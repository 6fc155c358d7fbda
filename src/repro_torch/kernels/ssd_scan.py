"""Mamba2 SSD chunked scan: the Hopper port of
``repro/kernels/ssd_scan.py::ssd_chunk_scan``.

The SSD dual form splits the sequence into chunks of length L:

* intra-chunk:   Y_intra = (C B^T ⊙ Γ) (Δ ⊙ X)
* chunk states:  S_c     = (B ⊙ γ_end)^T (Δ ⊙ X)
* inter-chunk:   H_c     = exp(ΔA_c) H_{c-1} + S_c
* output:        Y_inter = γ_start ⊙ (C H_{c-1})

``ssd_chunk_local`` computes the two chunk-local stages (and each chunk's
decay sum): ``csrc/ssd_scan.cu`` for CUDA tensors, ``ssd_chunk_local_plain``
for CPU ones.  ``ssd_chunk_scan`` adds the inter-chunk recurrence and
Y_inter as torch ops outside the kernel, as the reference runs them as jnp
outside its Pallas kernel; ``ssd_chunk_scan_plain`` is the same function in
plain PyTorch throughout.  The row and column blocks of the kernel come from
the Covenant tiler (``tiling.ssd_blocks``).

Shapes (head-batched): x (BH, S, P), dt (BH, S), A (BH,), B and C
(BH / rep, S, N): head row ``bh`` reads the B and C rows of ``bh // rep``,
so a model with fewer groups than heads passes them unrepeated (rep = 1 is
the reference's layout).  The kernel has no backward: a CUDA call with an
input that needs a gradient raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .matmul import thread_tile
from .tiling import ssd_blocks

NEG_INF = -1e30
_P, _I = ctypes.c_void_p, ctypes.c_int
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _check(x, dt, A, B, C, chunk: int) -> int:
    """Validate the head-batched shapes; returns rep (heads per B/C row)."""
    bh, s, _ = x.shape
    bg, sb, n = B.shape
    if (dt.shape != (bh, s) or A.shape != (bh,) or C.shape != B.shape
            or sb != s or bh % bg or s % chunk):
        raise ValueError(f"ssd_chunk_scan: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}, chunk "
                         f"{chunk}")
    return bh // bg


def _by_group(t: torch.Tensor, bg: int) -> torch.Tensor:
    """A per-head-row tensor (BH, ...) as (BG, rep, ...)."""
    return t.reshape(bg, t.shape[0] // bg, *t.shape[1:])


def ssd_chunk_local_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                          B: torch.Tensor, C: torch.Tensor, *, chunk: int
                          ) -> tuple[torch.Tensor, ...]:
    """What the CUDA kernel computes, in plain PyTorch: (y_intra (BH, S, P)
    f32, states (BH * chunks, N, P) f32, dsums (BH * chunks,) f32), chunk
    by chunk as the reference's ``_ssd_chunk_kernel``."""
    bh, s, p = x.shape
    bg, _, n = B.shape
    nck = s // chunk
    xf = _by_group(x.float().reshape(bh, nck, chunk, p), bg)
    dtf = _by_group(dt.float().reshape(bh, nck, chunk), bg)
    af = _by_group(A.float(), bg)[:, :, None, None]
    bf = B.float().reshape(bg, 1, nck, chunk, n)
    cf = C.float().reshape(bg, 1, nck, chunk, n)
    cum = torch.cumsum(dtf * af, -1)                     # (BG,rep,nck,L)
    idx = torch.arange(chunk, device=x.device)
    tril = idx[None, :] <= idx[:, None]
    # mask inside the exp, so the masked branch cannot overflow
    seg = cum[..., :, None] - cum[..., None, :]
    gamma = torch.exp(torch.where(tril, seg, torch.full_like(seg, NEG_INF)))
    xdt = xf * dtf[..., None]
    y = ((cf @ bf.transpose(-1, -2)) * gamma) @ xdt      # (BG,rep,nck,L,P)
    decay_end = torch.exp(cum[..., -1:] - cum)[..., None]
    states = (bf * decay_end).transpose(-1, -2) @ xdt    # (BG,rep,nck,N,P)
    return (y.reshape(bh, s, p), states.reshape(bh * nck, n, p),
            cum[..., -1].reshape(bh * nck))


def _no_grad_inputs(*tensors) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError("ssd_chunk_scan: the CUDA kernel has no backward;"
                           " call it under torch.no_grad() or on inputs that"
                           " need no gradient")


def ssd_chunk_local(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, *, chunk: int
                    ) -> tuple[torch.Tensor, ...]:
    """The chunk-local stages: (y_intra (BH, S, P) f32, states (BH * chunks,
    N, P) f32, dsums (BH * chunks,) f32), with the tiler's row and column
    blocks.  CPU tensors take ``ssd_chunk_local_plain``; CUDA tensors
    launch the kernel or raise."""
    rep = _check(x, dt, A, B, C, chunk)
    if x.device.type == "cpu":
        return ssd_chunk_local_plain(x, dt, A, B, C, chunk=chunk)
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in (dt, A, B, C)):
        raise ValueError(f"ssd_chunk_scan: unsupported devices "
                         f"{[str(t.device) for t in (x, dt, A, B, C)]}")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_chunk_scan: unsupported dtypes {x.dtype}, "
                        f"{B.dtype}, {C.dtype}")
    _no_grad_inputs(x, dt, A, B, C)
    bh, s, p = x.shape
    n = B.shape[-1]
    nck = s // chunk
    bl, bc = ssd_blocks(chunk, n, p, heads=bh * nck)
    x, B, C = x.contiguous(), B.contiguous(), C.contiguous()
    dt = dt.to(torch.float32).contiguous()
    A = A.to(torch.float32).contiguous()
    y = torch.empty((bh, s, p), dtype=torch.float32, device=x.device)
    states = torch.empty((bh * nck, n, p), dtype=torch.float32,
                         device=x.device)
    dsums = torch.empty((bh * nck,), dtype=torch.float32, device=x.device)
    tiles = (*thread_tile(bl, bc, max_tn=8), *thread_tile(bl, p, max_tn=8),
             *thread_tile(n, p, max_tn=8))
    fn = _build.bind("ssd_scan", f"covenant_ssd_scan_{_DTYPES[x.dtype]}",
                     [_P] * 8 + [_I] * 20 + [_P])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), y.data_ptr(), states.data_ptr(),
                 dsums.data_ptr(), bh, s, chunk, n, p, rep, bl, bc, *tiles,
                 stream)
    _build.check("ssd_scan", err)
    ssd_chunk_scan.launches += 1
    return y, states, dsums


def _inter_chunk(x, dt, A, C, y_intra, states, dsums, chunk, init_state):
    """The reference's jnp stages after its kernel: the recurrence H_c =
    exp(dsum_c) H_{c-1} + S_c from ``init_state`` (or zeros), and Y_inter
    from the states entering each chunk.  Returns (y in x's dtype, the
    final state (BH, N, P) f32)."""
    bh, s, p = x.shape
    bg, _, n = C.shape
    nck = s // chunk
    states = states.reshape(bh, nck, n, p)
    decay = torch.exp(dsums.reshape(bh, nck))[..., None, None]
    h = (torch.zeros((bh, n, p), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    h_prev = []
    for c in range(nck):
        h_prev.append(h)
        h = decay[:, c] * h + states[:, c]
    h_prev = _by_group(torch.stack(h_prev, 1), bg)       # (BG,rep,nck,N,P)
    cum_in = torch.cumsum(dt.float().reshape(bh, nck, chunk)
                          * A.float()[:, None, None], -1)
    gamma_start = _by_group(torch.exp(cum_in), bg)[..., None]
    cc = C.float().reshape(bg, 1, nck, chunk, n)
    y_inter = (cc @ h_prev) * gamma_start                # (BG,rep,nck,L,P)
    y = y_intra + y_inter.reshape(bh, s, p)
    return y.to(x.dtype), h


def ssd_chunk_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         B: torch.Tensor, C: torch.Tensor, *, chunk: int = 64,
                         init_state: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The function ``ssd_chunk_scan`` computes, in plain PyTorch."""
    _check(x, dt, A, B, C, chunk)
    local = ssd_chunk_local_plain(x, dt, A, B, C, chunk=chunk)
    return _inter_chunk(x, dt, A, C, *local, chunk, init_state)


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int = 64,
                   init_state: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Head-batched SSD: x (BH, S, P), dt (BH, S), A (BH,), B/C (BH / rep,
    S, N), ``init_state`` (BH, N, P).  Returns (y (BH, S, P) in x's dtype,
    final state (BH, N, P) f32).  S % chunk == 0 (``ops.covenant_ssd``
    pads).  The chunk-local stages run in the kernel on a CUDA tensor
    (``ssd_chunk_local``); the cross-chunk combination is torch."""
    _check(x, dt, A, B, C, chunk)
    if x.device.type != "cpu":
        _no_grad_inputs(init_state)
    local = ssd_chunk_local(x, dt, A, B, C, chunk=chunk)
    return _inter_chunk(x, dt, A, C, *local, chunk, init_state)


ssd_chunk_scan.launches = 0

__all__ = ["ssd_chunk_local", "ssd_chunk_local_plain", "ssd_chunk_scan",
           "ssd_chunk_scan_plain"]
