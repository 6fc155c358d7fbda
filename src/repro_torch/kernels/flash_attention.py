"""Flash attention forward and decode: the Hopper ports of
``repro/kernels/flash_attention.py::flash_attention`` and ``flash_decode``.

``flash_attention`` launches ``csrc/flash_attention.cu`` and
``flash_decode`` launches ``csrc/flash_decode.cu`` for CUDA tensors; CPU
tensors take ``flash_attention_plain`` / ``flash_decode_plain``, which
compute the same function in plain PyTorch.  Block geometry again comes
from the Covenant tiler (``tiling.attention_blocks``): the QK^T GEMM's
Algorithm-1 tiling is the flash block structure.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .matmul import thread_tile
from .tiling import flash_smem_bytes

NEG_INF = -1e30
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _masked_softmax_av(s: torch.Tensor, mask: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """softmax(s) @ v over visible entries; a row with none gives zeros
    (the kernels' ``l == 0`` guard).  ``s`` is f32 logits."""
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    o = p @ v.float()
    return o / torch.where(l == 0, torch.ones_like(l), l)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          scale: float | None = None,
                          q_offset: int | None = None) -> torch.Tensor:
    """The function ``flash_attention`` computes, in plain PyTorch.
    q: (BH, Sq, D); k, v: (BH / group, Sk, D)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    group = bh // k.shape[0]
    if group != 1:
        k = k.repeat_interleave(group, dim=0)
        v = v.repeat_interleave(group, dim=0)
    scale = scale if scale is not None else d ** -0.5
    q_offset = (sk - sq) if q_offset is None else q_offset
    s = (q.float() @ k.float().transpose(1, 2)) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = kpos < sk
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return _masked_softmax_av(s, mask, v).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None, block_q: int = 64,
                    block_kv: int = 64, q_offset: int | None = None
                    ) -> torch.Tensor:
    """q: (BH, Sq, D); k, v: (BH / group, Sk, D) — query head ``h`` reads kv
    head ``h // group``.  ``q_offset`` is the kv position of q row 0
    (default ``Sk - Sq``).  ``window=None`` is no window; an int, even 0,
    is a window of that many most recent keys.  The kernel masks ragged
    q and kv edges itself.  CPU tensors take ``flash_attention_plain``;
    CUDA tensors launch the kernel or raise."""
    bh, sq, d = q.shape
    bkv_rows, sk, dk = k.shape
    if dk != d or v.shape != k.shape or bh % bkv_rows:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, q_offset=q_offset)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: unsupported devices {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: unsupported dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    scale = scale if scale is not None else d ** -0.5
    q_offset = (sk - sq) if q_offset is None else q_offset
    s_tile = thread_tile(block_q, block_kv, max_tn=8)
    o_tile = thread_tile(block_q, d, max_tn=8)
    smem = flash_smem_bytes(block_q, block_kv, d)
    out = torch.empty_like(q)
    fn = _build.bind("flash_attention",
                     f"covenant_flash_attention_{_DTYPES[q.dtype]}",
                     [_P] * 4 + [_I] * 11 + [_F] + [_I] * 9 + [_P])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bh, sq, sk, d, bh // bkv_rows, block_q, block_kv, int(causal),
                 int(window is not None), 0 if window is None else int(window),
                 q_offset, float(scale), *s_tile, *o_tile, smem, stream)
    _build.check("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_len: torch.Tensor, *, scale: float | None = None
                       ) -> torch.Tensor:
    """The function ``flash_decode`` computes, in plain PyTorch.
    q: (BKV, Hg, D); k, v: (BKV, S, D); kv_len: (BKV,)."""
    d = q.shape[-1]
    s_len = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    s = (q.float() @ k.float().transpose(1, 2)) * scale     # (BKV, Hg, S)
    kpos = torch.arange(s_len, device=q.device)
    mask = (kpos[None, :] < kv_len.to(q.device)[:, None])[:, None, :]
    return _masked_softmax_av(s, mask, v).to(q.dtype)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor, *, scale: float | None = None,
                 block_kv: int = 512) -> torch.Tensor:
    """Single-token decode attention against a KV cache.

    q: (BKV, Hg, D) — one query block per kv head (Hg = q heads per kv
    head); k, v: (BKV, S, D); kv_len: (BKV,) valid lengths.  The kernel
    splits each row's kv walk into ``block_kv`` pieces and combines them by
    log-sum-exp.  CPU tensors take ``flash_decode_plain``; CUDA tensors
    launch the kernel or raise."""
    rows, hg, d = q.shape
    _, s_len, dk = k.shape
    if dk != d or v.shape != k.shape or k.shape[0] != rows \
            or kv_len.shape != (rows,):
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, kv_len {tuple(kv_len.shape)}")
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, kv_len, scale=scale)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_decode: unsupported devices {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode: unsupported dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lens = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    scale = scale if scale is not None else d ** -0.5
    n_split = math.ceil(s_len / block_kv)
    part_m = torch.empty((rows, n_split, hg), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((rows, n_split, hg, d), dtype=torch.float32,
                           device=q.device)
    out = torch.empty_like(q)
    fn = _build.bind("flash_decode", f"covenant_flash_decode_{_DTYPES[q.dtype]}",
                     [_P] * 8 + [_I] * 5 + [_F, _P])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                 out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
                 part_acc.data_ptr(), rows, s_len, d, hg, block_kv,
                 float(scale), stream)
    _build.check("flash_decode", err)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0

__all__ = ["flash_attention", "flash_attention_plain", "flash_decode",
           "flash_decode_plain"]
