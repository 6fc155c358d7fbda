"""Flash attention: the Hopper ports of ``repro/kernels/flash_attention.py``
``flash_attention``, ``flash_decode``, ``flash_attention_fwd_lse`` and
``flash_attention_bwd``.

Each wrapper launches its ``csrc`` kernel for CUDA tensors
(``flash_attention.cu`` holds the forward with and without the LSE output:
bf16 on the tensor cores, f32 on the SIMT lanes;
``flash_attention_bwd.cu`` the backward's dq and dkv passes, bf16 on the
tensor cores, f32 on the SIMT lanes; ``flash_decode.cu`` the decode, one
launch with its split combine); CPU tensors take the ``*_plain`` version
beside it, which computes the same function in plain PyTorch.
``FlashAttention`` is the autograd Function over the LSE forward and the
backward.  Block geometry again comes from the Covenant tiler
(``tiling.attention_blocks`` / ``attention_mma_blocks`` /
``attention_bwd_blocks`` / ``attention_bwd_mma_blocks``): the QK^T GEMM's
Algorithm-1 tiling is the flash block structure.

Window semantics follow the reference function by function:
``flash_attention`` (like ``_fa_kernel``) reads an int window, even 0, as a
window and None as none; ``flash_attention_fwd_lse`` and
``flash_attention_bwd`` (like their kernels' ``if window:``) read 0 as none.
``FlashAttention`` takes the forward's meaning and hands the same mask to
both its kernels.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .matmul import thread_tile
from ..targets import H100
from .tiling import (FLASH_BWD_MMA_BLOCKS, FLASH_BWD_MMA_HEAD_DIMS,
                     FLASH_MMA_BLOCK_KV, FLASH_MMA_BLOCK_Q,
                     FLASH_MMA_HEAD_DIMS, flash_bwd_mma_smem_bytes,
                     flash_bwd_smem_bytes, flash_mma_built, flash_smem_bytes)

NEG_INF = -1e30
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _visible(sq: int, sk: int, *, causal: bool, window: int | None,
             q_offset: int, device) -> torch.Tensor:
    """(Sq, Sk) mask of the kv positions each q row sees; ``window=None``
    is no window."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    mask = kpos < sk
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def _expand_kv(x: torch.Tensor, bh: int) -> torch.Tensor:
    """k or v (BH / group, S, D) repeated to one row per q head."""
    group = bh // x.shape[0]
    return x if group == 1 else x.repeat_interleave(group, dim=0)


def _masked_softmax_av(s: torch.Tensor, mask: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """softmax(s) @ v over visible entries; a row with none gives zeros
    (the kernels' ``l == 0`` guard).  ``s`` is f32 logits."""
    return _masked_softmax_av_lse(s, mask, v)[0]


def _masked_softmax_av_lse(s: torch.Tensor, mask: torch.Tensor,
                           v: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(softmax(s) @ v, the rows' log-sum-exp m + log l); a row with no
    visible entry gives zeros and lse = -1e30 (``l == 0`` read as 1)."""
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    safe = torch.where(l == 0, torch.ones_like(l), l)
    return (p @ v.float()) / safe, m + torch.log(safe)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          scale: float | None = None,
                          q_offset: int | None = None) -> torch.Tensor:
    """The function ``flash_attention`` computes, in plain PyTorch.
    q: (BH, Sq, D); k, v: (BH / group, Sk, D)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    k, v = _expand_kv(k, bh), _expand_kv(v, bh)
    scale = scale if scale is not None else d ** -0.5
    q_offset = (sk - sq) if q_offset is None else q_offset
    s = (q.float() @ k.float().transpose(1, 2)) * scale
    mask = _visible(sq, sk, causal=causal, window=window, q_offset=q_offset,
                    device=q.device)
    return _masked_softmax_av(s, mask, v).to(q.dtype)


def _check_qkv(name: str, q, k, v) -> None:
    bh, _, d = q.shape
    bkv_rows, _, dk = k.shape
    if dk != d or v.shape != k.shape or bh % bkv_rows:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")


def _check_cuda(name: str, q, *others) -> None:
    """A CUDA launch takes same-device, same-dtype bf16 or f32 tensors."""
    if q.device.type != "cuda" or any(t.device != q.device for t in others):
        raise ValueError(f"{name}: unsupported devices "
                         f"{[str(t.device) for t in (q, *others)]}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in others):
        raise TypeError(f"{name}: unsupported dtypes "
                        f"{[t.dtype for t in (q, *others)]}")


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
    bkv_rows, sk, _ = k.shape
    _check_qkv("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, q_offset=q_offset)
    _check_cuda("flash_attention", q, k, v)
    out, _ = _forward(q, k, v, causal=causal, window=window, scale=scale,
                      block_q=block_q, block_kv=block_kv, q_offset=q_offset,
                      with_lse=False)
    flash_attention.launches += 1
    return out


def _forward(q, k, v, *, causal, window, scale, block_q, block_kv, q_offset,
             with_lse: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch ``csrc/flash_attention.cu`` on checked CUDA tensors; with
    ``with_lse`` through its LSE entry point.  ``window=None`` is no
    window.  bf16 runs the tensor-core kernel, which takes head dims
    ``FLASH_MMA_HEAD_DIMS``, block_q in ``FLASH_MMA_BLOCK_Q`` and block_kv in
    ``FLASH_MMA_BLOCK_KV`` whose tiles fit one block's shared memory
    (``tiling.flash_mma_built``, ``attention_mma_blocks``) and raises on
    others.  Returns (out, lse (BH, Sq, 1) f32 or None)."""
    bh, sq, d = q.shape
    bkv_rows, sk, _ = k.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    scale = scale if scale is not None else d ** -0.5
    q_offset = (sk - sq) if q_offset is None else q_offset
    out = torch.empty_like(q)
    lse = (torch.empty((bh, sq, 1), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.dtype == torch.bfloat16:
        if not flash_mma_built(block_q, block_kv, d):
            raise ValueError(
                f"flash_attention: the bf16 kernel takes head dims "
                f"{FLASH_MMA_HEAD_DIMS}, block_q {FLASH_MMA_BLOCK_Q} and "
                f"block_kv {FLASH_MMA_BLOCK_KV} whose tiles fit one block's "
                f"shared memory; got {d}, {block_q}, {block_kv}")
        # a view may start off the 16 bytes cp.async reads
        q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q, k, v))
        fn = _build.bind("flash_attention", "covenant_flash_attention_mma",
                         [_P] * 5 + [_I] * 11 + [_F, _P])
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     None if lse is None else lse.data_ptr(), bh, sq, sk, d,
                     bh // bkv_rows, block_q, block_kv, int(causal),
                     int(window is not None),
                     0 if window is None else int(window), q_offset,
                     float(scale), stream)
        _build.check("flash_attention", err)
        return out, lse
    s_tile = thread_tile(block_q, block_kv, max_tn=8)
    o_tile = thread_tile(block_q, d, max_tn=8)
    smem = flash_smem_bytes(block_q, block_kv, d)
    symbol = "fwd_lse_" if with_lse else ""
    fn = _build.bind("flash_attention",
                     f"covenant_flash_attention_{symbol}{_DTYPES[q.dtype]}",
                     [_P] * (5 if with_lse else 4) + [_I] * 11 + [_F]
                     + [_I] * 9 + [_P])
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if with_lse:
        ptrs.append(lse.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs, bh, sq, sk, d, bh // bkv_rows, block_q, block_kv,
                 int(causal), int(window is not None),
                 0 if window is None else int(window), q_offset, float(scale),
                 *s_tile, *o_tile, smem, stream)
    _build.check("flash_attention", err)
    return out, lse


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# forward with LSE, backward (the training pair)
# ---------------------------------------------------------------------------


def flash_attention_fwd_lse_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *, causal: bool = True,
                                  window: int | None = None,
                                  scale: float | None = None,
                                  q_offset: int | None = None
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The function ``flash_attention_fwd_lse`` computes, in plain PyTorch:
    (out (BH, Sq, D), lse (BH, Sq, 1) f32).  ``window`` 0 or None is no
    window, as in the reference's ``_fa_fwd_lse_kernel``."""
    return _fwd_lse_plain(q, k, v, causal=causal, window=window or None,
                          scale=scale, q_offset=q_offset)


def _fwd_lse_plain(q, k, v, *, causal, window, scale, q_offset):
    bh, sq, d = q.shape
    sk = k.shape[1]
    k, v = _expand_kv(k, bh), _expand_kv(v, bh)
    scale = scale if scale is not None else d ** -0.5
    q_offset = (sk - sq) if q_offset is None else q_offset
    s = (q.float() @ k.float().transpose(1, 2)) * scale
    mask = _visible(sq, sk, causal=causal, window=window, q_offset=q_offset,
                    device=q.device)
    out, lse = _masked_softmax_av_lse(s, mask, v)
    return out.to(q.dtype), lse


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int | None = None,
                            scale: float | None = None, block_q: int = 64,
                            block_kv: int = 64, q_offset: int | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward that also returns the rows' log-sum-exp, the backward's
    residual: (out (BH, Sq, D), lse (BH, Sq, 1) f32).  Shapes and
    ``q_offset`` (default ``Sk - Sq``) as in ``flash_attention``; ``window``
    0 or None is no window, as in the reference.  A fully masked row gives
    zeros and lse = -1e30.  CPU tensors take
    ``flash_attention_fwd_lse_plain``; CUDA tensors launch the kernel or
    raise."""
    return _fwd_lse(q, k, v, causal=causal, window=window or None,
                    scale=scale, block_q=block_q, block_kv=block_kv,
                    q_offset=q_offset)


def _fwd_lse(q, k, v, *, causal, window, scale, block_q, block_kv, q_offset):
    """``flash_attention_fwd_lse`` with ``window=None`` as no window and an
    int, even 0, as a window (``FlashAttention`` takes this form)."""
    _check_qkv("flash_attention_fwd_lse", q, k, v)
    if q.device.type == "cpu":
        return _fwd_lse_plain(q, k, v, causal=causal, window=window,
                              scale=scale, q_offset=q_offset)
    _check_cuda("flash_attention_fwd_lse", q, k, v)
    out = _forward(q, k, v, causal=causal, window=window, scale=scale,
                   block_q=block_q, block_kv=block_kv, q_offset=q_offset,
                   with_lse=True)
    flash_attention_fwd_lse.launches += 1
    return out


flash_attention_fwd_lse.launches = 0


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True, window: int | None = None,
                              scale: float | None = None, q_offset: int = 0
                              ) -> tuple[torch.Tensor, ...]:
    """The function ``flash_attention_bwd`` computes, in plain PyTorch: the
    flash-recompute formula from ``lse`` and ``delta = rowsum(dout * out)``
    (no autograd).  ``window`` 0 or None is no window."""
    return _bwd_plain(q, k, v, out, lse, dout, causal=causal,
                      window=window or None, scale=scale, q_offset=q_offset)


def _bwd_plain(q, k, v, out, lse, dout, *, causal, window, scale, q_offset):
    bh, sq, d = q.shape
    bkv_rows, sk, _ = k.shape
    group = bh // bkv_rows
    scale = scale if scale is not None else d ** -0.5
    kf, vf = _expand_kv(k, bh).float(), _expand_kv(v, bh).float()
    qf, dof = q.float(), dout.float()
    mask = _visible(sq, sk, causal=causal, window=window, q_offset=q_offset,
                    device=q.device)
    s = (qf @ kf.transpose(1, 2)) * scale
    # select with the mask: exp(s - lse) overflows on a fully masked row
    p = torch.where(mask, torch.exp(s - lse.reshape(bh, sq, 1).float()),
                    torch.zeros_like(s))
    delta = (dof * out.float()).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(1, 2) - delta) * scale
    dq = ds @ kf
    dk = (ds.transpose(1, 2) @ qf).reshape(bkv_rows, group, sk, d).sum(1)
    dv = (p.transpose(1, 2) @ dof).reshape(bkv_rows, group, sk, d).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int | None = None,
                        scale: float | None = None, block_q: int = 64,
                        block_kv: int = 64, q_offset: int = 0
                        ) -> tuple[torch.Tensor, ...]:
    """dq, dk, dv of the flash forward.  q, out, dout: (BH, Sq, D); k, v:
    (BH / group, Sk, D), q head ``h`` reading kv head ``h // group``; lse:
    (BH, Sq, 1) f32 from ``flash_attention_fwd_lse``.  dk and dv come out
    summed over the group, all three in the input dtype.  ``q_offset``
    defaults to 0 and ``window`` 0 or None is no window, as in the
    reference; unlike it, ragged q and kv edges need no padding (nor its
    ``seq_k``).  CPU tensors take ``flash_attention_bwd_plain``; CUDA
    tensors launch the two kernels (dq, then dk/dv) or raise."""
    return _bwd(q, k, v, out, lse, dout, causal=causal, window=window or None,
                scale=scale, block_q=block_q, block_kv=block_kv,
                q_offset=q_offset)


def _bwd(q, k, v, out, lse, dout, *, causal, window, scale, block_q,
         block_kv, q_offset):
    """``flash_attention_bwd`` with ``window=None`` as no window and an
    int, even 0, as a window (``FlashAttention`` takes this form)."""
    _check_qkv("flash_attention_bwd", q, k, v)
    bh, sq, d = q.shape
    bkv_rows, sk, _ = k.shape
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.numel() != bh * sq:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}, lse "
                         f"{tuple(lse.shape)}")
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, out, lse, dout, causal=causal,
                          window=window, scale=scale, q_offset=q_offset)
    _check_cuda("flash_attention_bwd", q, k, v, out, dout)
    if lse.device != q.device or lse.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd: lse must be f32 on "
                        f"{q.device}, got {lse.dtype} on {lse.device}")
    q, k, v, dout = (t.contiguous() for t in (q, k, v, dout))
    lse = lse.reshape(bh, sq).contiguous()
    scale = scale if scale is not None else d ** -0.5
    if q.dtype == torch.bfloat16:
        dq, dk, dv = _bwd_mma(q, k, v, out.contiguous(), lse, dout,
                              causal=causal, window=window, scale=scale,
                              block_q=block_q, block_kv=block_kv,
                              q_offset=q_offset)
        flash_attention_bwd.launches += 1
        return dq, dk, dv
    # the reference computes delta outside its kernels too (:270)
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    s_tile = thread_tile(block_q, block_kv, max_tn=8, max_tm=4)
    dq_tile = thread_tile(block_q, d, max_tn=8, max_tm=4)
    dkv_tile = thread_tile(block_kv, d, max_tn=8, max_tm=4)
    smem = flash_bwd_smem_bytes(block_q, block_kv, d)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    common = (sq, sk, d, bh // bkv_rows, block_q, block_kv, int(causal),
              int(window is not None), 0 if window is None else int(window),
              q_offset, float(scale), *s_tile)
    args = [_I] * 10 + [_F] + [_I] * 9 + [_P]
    dt = _DTYPES[q.dtype]
    dq_fn = _build.bind("flash_attention_bwd",
                        f"covenant_flash_attention_bwd_dq_{dt}",
                        [_P] * 7 + [_I] + args)
    dkv_fn = _build.bind("flash_attention_bwd",
                         f"covenant_flash_attention_bwd_dkv_{dt}",
                         [_P] * 8 + [_I] + args)
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = dq_fn(*inputs, dq.data_ptr(), bh, *common, *dq_tile, smem,
                    stream)
        _build.check("flash_attention_bwd", err)
        err = dkv_fn(*inputs, dk.data_ptr(), dv.data_ptr(), bkv_rows,
                     *common, *dkv_tile, smem, stream)
    _build.check("flash_attention_bwd", err)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def _bwd_mma(q, k, v, out, lse, dout, *, causal, window, scale, block_q,
             block_kv, q_offset):
    """The bf16 tensor-core backward (``covenant_flash_attention_bwd_mma``:
    the dq pass, which also writes delta = rowsum(dout * out), then the dkv
    pass) on checked, contiguous CUDA tensors.  It takes head dims
    ``FLASH_BWD_MMA_HEAD_DIMS`` and block_q, block_kv in
    ``FLASH_BWD_MMA_BLOCKS`` (``tiling.attention_bwd_mma_blocks``) whose
    tiles fit one block's shared memory, the pairs the library builds, and
    raises on others (at head dim 160 block (128, 128); at 256 every pair
    but (64, 64))."""
    bh, sq, d = q.shape
    bkv_rows, sk, _ = k.shape
    if d not in FLASH_BWD_MMA_HEAD_DIMS or block_q not in FLASH_BWD_MMA_BLOCKS \
            or block_kv not in FLASH_BWD_MMA_BLOCKS \
            or flash_bwd_mma_smem_bytes(block_q, block_kv, d) > \
            H100["smem_bytes_per_block"]:
        raise ValueError(
            f"flash_attention_bwd: the bf16 kernel takes head dims "
            f"{FLASH_BWD_MMA_HEAD_DIMS} and block_q, block_kv in "
            f"{FLASH_BWD_MMA_BLOCKS} whose tiles fit one block's shared "
            f"memory; got {d}, {block_q}, {block_kv}")
    # a view may start off the 16 bytes cp.async and the vector loads read
    q, k, v, out, dout = (t.clone() if t.data_ptr() % 16 else t
                          for t in (q, k, v, out, dout))
    delta = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = _build.bind("flash_attention_bwd", "covenant_flash_attention_bwd_mma",
                     [_P] * 10 + [_I] * 12 + [_F, _P])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, bkv_rows,
                 sq, sk, d, bh // bkv_rows, block_q, block_kv, int(causal),
                 int(window is not None), 0 if window is None else int(window),
                 q_offset, float(scale), stream)
    _build.check("flash_attention_bwd", err)
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Flash attention that carries gradients: the forward runs
    ``flash_attention_fwd_lse`` and saves q, k, v, out and the (BH, Sq, 1)
    lse, never the (Sq, Sk) probabilities; the backward runs
    ``flash_attention_bwd`` with the forward's mask and ``q_offset``.

    ``apply(q, k, v, causal, window, scale, blocks, bwd_blocks, q_offset)``
    with q (BH, Sq, D), k/v (BH / group, Sk, D); ``window`` as in
    ``flash_attention`` (None is none, an int, even 0, is a window)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, blocks, bwd_blocks,
                q_offset):
        out, lse = _fwd_lse(q, k, v, causal=causal, window=window,
                            scale=scale, block_q=blocks[0],
                            block_kv=blocks[1], q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale,
                        block_q=bwd_blocks[0], block_kv=bwd_blocks[1],
                        q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, out, lse, dout, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_len: torch.Tensor, *, scale: float | None = None,
                       kv_heads: int = 1) -> torch.Tensor:
    """The function ``flash_decode`` computes, in plain PyTorch.
    q: (BKV, Hg, D); k, v: (BKV, S, D); kv_len: (BKV / kv_heads,), row
    ``r`` reading ``kv_len[r // kv_heads]``."""
    d = q.shape[-1]
    s_len = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    lens = kv_len.to(q.device).repeat_interleave(kv_heads)
    s = (q.float() @ k.float().transpose(1, 2)) * scale     # (BKV, Hg, S)
    kpos = torch.arange(s_len, device=q.device)
    mask = (kpos[None, :] < lens[:, None])[:, None, :]
    return _masked_softmax_av(s, mask, v).to(q.dtype)


# the decode kernel (csrc/flash_decode.cu) is built for these head dims and
# q heads per kv head: its warps split a group of up to 16 heads between
# them, at most 4 heads a warp
DECODE_HEAD_DIMS = (8, 16, 32, 64, 128, 160, 256)
DECODE_GROUPS = tuple(range(1, 17))


def _decode_built(head_dim: int, group: int, elem_bytes: int) -> bool:
    """The decode kernel is built for this shape (``launch_d`` and
    ``launch_hg`` in csrc/flash_decode.cu): a head dim it is built for,
    whole 16-byte chunks a row, and a group of 1 to 16 heads."""
    return (head_dim in DECODE_HEAD_DIMS and group in DECODE_GROUPS
            and head_dim * elem_bytes % 16 == 0)


# (device index, stream) -> the decode kernel's per-row arrival counters
_counters: dict[tuple[int, int], torch.Tensor] = {}


def _arrival_counters(device: torch.device, stream: int,
                      rows: int) -> torch.Tensor:
    """int32 zeros, one per row, for the decode kernel's launches on
    ``stream``: each launch leaves them zero again, so they are made once
    (and again, larger, for a launch with more rows)."""
    buf = _counters.get((device.index, stream))
    if buf is None or buf.numel() < rows:
        buf = torch.zeros(max(rows, 1024), dtype=torch.int32, device=device)
        _counters[(device.index, stream)] = buf
    return buf


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor, *, scale: float | None = None,
                 block_kv: int = 512, kv_heads: int = 1) -> torch.Tensor:
    """Single-token decode attention against a KV cache.

    q: (BKV, Hg, D) — one query block per kv head (Hg = q heads per kv
    head); k, v: (BKV, S, D); kv_len: (BKV / kv_heads,) valid lengths,
    row ``r`` reading ``kv_len[r // kv_heads]`` (one length per batch entry
    of ``kv_heads`` consecutive rows; 1 gives the reference's one length a
    row).  The kernel splits each row's kv walk into ``block_kv`` pieces
    and combines them by log-sum-exp in the same launch.  CPU tensors take
    ``flash_decode_plain``; CUDA tensors launch the kernel or raise."""
    rows, hg, d = q.shape
    _, s_len, dk = k.shape
    if dk != d or v.shape != k.shape or k.shape[0] != rows \
            or kv_heads < 1 or rows % kv_heads \
            or kv_len.shape != (rows // kv_heads,):
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, kv_len {tuple(kv_len.shape)}, "
                         f"kv_heads {kv_heads}")
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, kv_len, scale=scale,
                                  kv_heads=kv_heads)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_decode: unsupported devices {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode: unsupported dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not _decode_built(d, hg, q.element_size()):
        raise ValueError(f"flash_decode: the kernel is built for head dims "
                         f"{DECODE_HEAD_DIMS} and groups 1 to "
                         f"{DECODE_GROUPS[-1]}; got head dim {d}, group "
                         f"{hg}, {q.dtype}")
    # a view may start off the 16 bytes cp.async reads
    q, k, v = (t.contiguous() for t in (q, k, v))
    q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q, k, v))
    lens = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    scale = scale if scale is not None else d ** -0.5
    n_split = math.ceil(s_len / block_kv)
    part = torch.empty(rows * n_split * hg * (d + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty_like(q)
    fn = _build.bind("flash_decode", f"covenant_flash_decode_{_DTYPES[q.dtype]}",
                     [_P] * 4 + [_I] + [_P] * 3 + [_I] * 5 + [_F, _P])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counters = _arrival_counters(q.device, stream, rows)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                 kv_heads, out.data_ptr(), part.data_ptr(),
                 counters.data_ptr(), rows, s_len, d, hg, block_kv,
                 float(scale), stream)
    _build.check("flash_decode", err)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0

__all__ = ["DECODE_GROUPS", "DECODE_HEAD_DIMS", "FlashAttention",
           "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_fwd_lse",
           "flash_attention_fwd_lse_plain", "flash_attention_plain",
           "flash_decode", "flash_decode_plain"]
