"""Config registry: ``--arch <id>`` lookup.

The counterpart of ``repro/configs/__init__.py``.  It holds the
architectures the port serves so far; the others come with their slices.
"""
from __future__ import annotations

from repro_torch.models.config import ArchConfig

from . import mamba2_2_7b, qwen3_0_6b, zamba2_2_7b

_MODULES = {
    "qwen3-0.6b": qwen3_0_6b,
    "mamba2-2.7b": mamba2_2_7b,
    "zamba2-2.7b": zamba2_2_7b,
}

ARCHS = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    try:
        mod = _MODULES[name]
    except KeyError as e:
        raise KeyError(f"unknown arch {name!r}; known: {list(ARCHS)}") from e
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ARCHS", "get_config"]
