"""Config registry: ``--arch <id>`` lookup.

The counterpart of ``repro/configs/__init__.py``.  It holds the dense
archs (qwen3-0.6b, stablelm-12b, gemma3-12b, command-r-plus-104b), the
MoE ones (deepseek-moe-16b, olmoe-1b-7b), the SSM ones (mamba2-2.7b,
zamba2-2.7b), the encoder-decoder one (whisper-base) and the VLM one
(paligemma-3b): all ten of the reference's ids; and the assigned input
shapes: every (arch x shape) pair is a dry-run cell, and ``applicable``
encodes the assignment's skip rules (long_500k needs sub-quadratic
attention).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ArchConfig

from . import (command_r_plus_104b, deepseek_moe_16b, gemma3_12b,
               mamba2_2_7b, olmoe_1b_7b, paligemma_3b, qwen3_0_6b,
               stablelm_12b, whisper_base, zamba2_2_7b)

_MODULES = {  # the reference's order, which ``cells`` follows
    "command-r-plus-104b": command_r_plus_104b,
    "gemma3-12b": gemma3_12b,
    "stablelm-12b": stablelm_12b,
    "qwen3-0.6b": qwen3_0_6b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "zamba2-2.7b": zamba2_2_7b,
    "paligemma-3b": paligemma_3b,
    "mamba2-2.7b": mamba2_2_7b,
    "whisper-base": whisper_base,
}

ARCHS = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    try:
        mod = _MODULES[name]
    except KeyError as e:
        raise KeyError(f"unknown arch {name!r}; known: {list(ARCHS)}") from e
    return mod.SMOKE if smoke else mod.CONFIG


# ---------------------------------------------------------------------------
# assigned input shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# archs whose per-token state is sub-quadratic (SSM / hybrid / local-window)
_LONG_OK = {"gemma3-12b", "zamba2-2.7b", "mamba2-2.7b"}


def applicable(arch: str, shape: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for a dry-run cell."""
    if shape == "long_500k" and arch not in _LONG_OK:
        return False, ("pure full attention: 500k KV cache is O(seq) per "
                       "token and O(seq^2) prefill — skipped per assignment")
    return True, ""


def cells(include_skipped: bool = False):
    """All 40 (arch, shape) cells, with skip annotations."""
    out = []
    for a in ARCHS:
        for s in SHAPES:
            ok, why = applicable(a, s)
            if ok or include_skipped:
                out.append((a, s, ok, why))
    return out


__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "applicable", "cells",
           "get_config"]
