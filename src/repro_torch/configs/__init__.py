"""Config registry: ``--arch <id>`` lookup.

The counterpart of ``repro/configs/__init__.py``.  It holds the dense
archs (qwen3-0.6b, stablelm-12b, gemma3-12b, command-r-plus-104b), the
MoE ones (deepseek-moe-16b, olmoe-1b-7b), the SSM ones (mamba2-2.7b,
zamba2-2.7b), the encoder-decoder one (whisper-base) and the VLM one
(paligemma-3b): all ten of the reference's ids.
"""
from __future__ import annotations

from repro_torch.models.config import ArchConfig

from . import (command_r_plus_104b, deepseek_moe_16b, gemma3_12b,
               mamba2_2_7b, olmoe_1b_7b, paligemma_3b, qwen3_0_6b,
               stablelm_12b, whisper_base, zamba2_2_7b)

_MODULES = {
    "qwen3-0.6b": qwen3_0_6b,
    "stablelm-12b": stablelm_12b,
    "gemma3-12b": gemma3_12b,
    "command-r-plus-104b": command_r_plus_104b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "mamba2-2.7b": mamba2_2_7b,
    "zamba2-2.7b": zamba2_2_7b,
    "paligemma-3b": paligemma_3b,
    "whisper-base": whisper_base,
}

ARCHS = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    try:
        mod = _MODULES[name]
    except KeyError as e:
        raise KeyError(f"unknown arch {name!r}; known: {list(ARCHS)}") from e
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ARCHS", "get_config"]
