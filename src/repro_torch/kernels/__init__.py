"""Hopper kernels scheduled by the Covenant tiler.

``ops`` is the public API (padding, Covenant blocks, device dispatch);
``ref`` holds the plain-PyTorch oracles every kernel is tested against;
``tiling`` is the Algorithm-1 -> block-geometry bridge; ``matmul``,
``flash_attention`` and ``ssd_scan`` hold the wrappers of ``csrc/*.cu``
beside their plain versions (and ``FlashAttention``, the autograd Function
over the LSE forward and the backward); ``adamw`` holds the optimizer's
fused norm and update, whose plain version is ``optim/adamw.py``'s eager
path; ``_build`` compiles and binds the CUDA sources.
"""
from . import adamw, flash_attention, matmul, ops, ref, ssd_scan, tiling
from .ops import (covenant_attention, covenant_decode_attention,
                  covenant_matmul, covenant_ssd)


def kernel_launches() -> dict[str, int]:
    """Every kernel wrapper's launch count (its ``.launches``)."""
    fa = flash_attention
    return {"matmul": matmul.matmul.launches,
            "flash_attention": fa.flash_attention.launches,
            "flash_attention_fwd_lse": fa.flash_attention_fwd_lse.launches,
            "flash_attention_bwd": fa.flash_attention_bwd.launches,
            "flash_decode": fa.flash_decode.launches,
            "ssd_chunk_scan": ssd_scan.ssd_chunk_scan.launches,
            "adamw_sq_sums": adamw.sq_sums.launches,
            "adamw_update": adamw.update.launches}


__all__ = ["adamw", "covenant_attention", "covenant_decode_attention",
           "covenant_matmul", "covenant_ssd", "flash_attention",
           "kernel_launches", "matmul", "ops", "ref", "ssd_scan", "tiling"]
