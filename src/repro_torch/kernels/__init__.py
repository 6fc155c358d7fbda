"""Hopper kernels scheduled by the Covenant tiler.

``ops`` is the public API (padding, Covenant blocks, device dispatch);
``ref`` holds the plain-PyTorch oracles every kernel is tested against;
``tiling`` is the Algorithm-1 -> block-geometry bridge; ``matmul``,
``flash_attention`` and ``ssd_scan`` hold the wrappers of ``csrc/*.cu``
beside their plain versions (and ``FlashAttention``, the autograd Function
over the LSE forward and the backward); ``_build`` compiles and binds the
CUDA sources.
"""
from . import flash_attention, matmul, ops, ref, ssd_scan, tiling
from .ops import (covenant_attention, covenant_decode_attention,
                  covenant_matmul, covenant_ssd)

__all__ = ["covenant_attention", "covenant_decode_attention",
           "covenant_matmul", "covenant_ssd", "flash_attention", "matmul",
           "ops", "ref", "ssd_scan", "tiling"]
