"""Blocked GEMM: the Hopper port of ``repro/kernels/matmul.py::matmul``.

``matmul`` launches ``csrc/matmul.cu`` for a CUDA tensor and runs
``matmul_plain`` for a CPU tensor.  The block geometry comes from the
Covenant tiler (``tiling.gemm_blocks``) through ``ops.covenant_matmul``.
Supports bf16/f32 -> f32 (f32 in true IEEE f32, no TF32) and s8 -> s32.
bf16 runs on the tensor cores (TMA + wgmma, a stage ring sized by
``tiling.gemm_stages``) and takes ragged edges itself; f32 and s8 run on the
SIMT lanes with a register micro-tile per thread (``thread_tile``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .ref import matmul_ref
from .tiling import gemm_stages

_P, _I = ctypes.c_void_p, ctypes.c_int
_SYMBOLS = {torch.bfloat16: "covenant_matmul_bf16",
            torch.float32: "covenant_matmul_f32",
            torch.int8: "covenant_matmul_i8"}
THREADS = 256


@functools.lru_cache(maxsize=None)
def thread_tile(rows: int, cols: int, max_tn: int = 16, max_tm: int = 8
                ) -> tuple[int, int, int, int]:
    """(tm, tn, txc, tyc): a ``rows x cols`` block tile over at most 256
    threads, ``tyc x txc`` of them, each holding a ``tm x tn`` register
    micro-tile (thread (ty, tx) owns rows ty + i*tyc, columns tx + j*txc).
    Picks the fewest outputs per thread, then the fewest shared-memory
    reads per step (tm + tn), then the widest rows of threads."""
    best, best_key = None, None
    for tm in (t for t in (1, 2, 4, 8) if t <= max_tm):
        tyc = math.ceil(rows / tm)
        if tyc > THREADS:
            continue
        txc = max(1, min(THREADS // tyc, cols))
        tn = math.ceil(cols / txc)
        if tn > max_tn:
            continue
        key = (tm * tn, tm + tn, -txc)
        if best_key is None or key < best_key:
            best, best_key = (tm, tn, txc, tyc), key
    if best is None:
        raise ValueError(f"block tile {rows}x{cols} does not fit {THREADS} "
                         f"threads of at most {max_tm}x{max_tn} outputs")
    return best


def smem_bytes(block_m: int, block_n: int, block_k: int,
               dtype: torch.dtype) -> int:
    """Shared memory of one block: the a and b tiles in the input type,
    each row padded by 4 bytes (``csrc/matmul.cu``)."""
    size = torch.empty((), dtype=dtype).element_size()
    pad = 4 // size
    return ((block_m * (block_k + pad) + block_k * (block_n + pad)) * size)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype.is_floating_point else torch.int32


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, copied if its data does not start on 16 bytes, as a TMA base
    must (the allocator's tensors do; a view may not)."""
    return x.clone() if x.data_ptr() % 16 else x


def matmul_plain(a: torch.Tensor, b: torch.Tensor,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """C = A @ B with f32 (or i32) accumulation, in plain PyTorch: the
    oracle ``ref.matmul_ref``."""
    return matmul_ref(a, b, out_dtype or _acc_dtype(a.dtype))


def matmul(a: torch.Tensor, b: torch.Tensor, *, block_m: int, block_n: int,
           block_k: int, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N]; accumulation is f32 for float inputs, i32
    for int8.  Dims must be divisible by the block sizes
    (``ops.covenant_matmul`` pads), except for bf16 on a card: the
    tensor-core kernel masks ragged edges itself, and needs only K and N to
    be multiples of 8 (TMA's 16-byte row stride).  CPU tensors take
    ``matmul_plain``; CUDA tensors launch the kernel or raise."""
    m, k = a.shape
    k2, n = b.shape
    bf16 = a.dtype == torch.bfloat16
    ragged = bf16 and a.device.type == "cuda"
    if k != k2 or (not ragged
                   and (m % block_m or n % block_n or k % block_k)):
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)} "
                         f"do not tile by {(block_m, block_n, block_k)}")
    if a.device.type == "cpu":
        return matmul_plain(a, b, out_dtype)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"matmul: unsupported devices {a.device}, {b.device}")
    if a.dtype != b.dtype or a.dtype not in _SYMBOLS:
        raise TypeError(f"matmul: unsupported dtypes {a.dtype}, {b.dtype}")
    if bf16 and (n % 8 or k % 8):
        raise ValueError(f"matmul: bf16 {m}x{n}x{k}: K and N must be "
                         f"multiples of 8")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((m, n), dtype=_acc_dtype(a.dtype), device=a.device)
    if bf16:
        a, b = _aligned(a), _aligned(b)
        stage_k, stages = gemm_stages(block_m, block_n, block_k)
        args = (block_m, block_n, stage_k, stages)
    else:
        args = (block_m, block_n, block_k, *thread_tile(block_m, block_n),
                smem_bytes(block_m, block_n, block_k, a.dtype))
    fn = _build.bind("matmul", _SYMBOLS[a.dtype],
                     [_P, _P, _P] + [_I] * (3 + len(args)) + [_P])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, *args,
                 stream)
    _build.check("matmul", err)
    matmul.launches += 1
    return out if out_dtype is None or out_dtype == out.dtype \
        else out.to(out_dtype)


matmul.launches = 0

__all__ = ["matmul", "matmul_plain", "smem_bytes", "thread_tile"]
