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
plain PyTorch throughout.

The kernel runs both products on the tensor cores (mma.sync, bf16 operands,
f32 sums).  A block computes a row block of 64 or 128 rows of one (head
row, chunk), 16 rows a warp, and walks the column blocks of 32 or 64
columns at or below its rows with the B and X tiles double-buffered in
shared memory; the scores C B^T stay in registers, where they are scaled by
Γ and dt; a second kernel sums each chunk's end state.  Both block sizes
come from the Covenant tiler through the equivalent C B^T GEMM
(``tiling.ssd_mma_blocks``), capped at half the SM's shared memory.  dt is
folded into the scores' columns (and into B's rows for the state), never
into X: bf16 x, B and C enter exact, and each term of y and of the state
takes one bf16 rounding of its scaled score, at most 2^-8 of it, two
thirds of ``chip_smoke.check_ssd``'s bound.  f32 inputs enter as two bf16
parts hi + lo each (2^-16), three products for each one of f32
(``launch.ssd_probes simulate`` holds both choices against the gates).
N and P are zero-padded to multiples of 8 here where they are not already,
which is exact.

Gradients: ``ssd_chunk_local`` is an autograd Function.  Its forward is the
kernel (the plain local stage on a CPU tensor); its backward recomputes the
local stage through the ops of ``ssd_chunk_local_plain`` under autograd and
returns their gradients for x, dt, A, B and C.  That is the backward of a
function for which the reference has no backward kernel either: its
gradients are jnp autodiff through ``ssd_chunked``.  It is not a stand-in
for the forward kernel, which every forward runs.

Shapes (head-batched): x (BH, S, P), dt (BH, S), A (BH,), B and C
(BH / rep, S, N): head row ``bh`` reads the B and C rows of ``bh // rep``,
so a model with fewer groups than heads passes them unrepeated (rep = 1 is
the reference's layout).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .tiling import ssd_mma_blocks

NEG_INF = -1e30
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PARTS = {torch.bfloat16: 1, torch.float32: 2}


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


def _pad8(t: torch.Tensor) -> torch.Tensor:
    """The last dim zero-padded to a multiple of 8: the kernel stages rows
    in 16-byte vectors of bf16."""
    extra = -t.shape[-1] % 8
    return F.pad(t, (0, extra)) if extra else t


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    # a view may start off the 16 bytes cp.async reads
    return t.clone() if t.data_ptr() % 16 else t


def _parts(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
    """bf16 ``t`` as itself; f32 ``t`` as two bf16 parts hi + lo, split
    by the kernel library's ``covenant_ssd_split``."""
    if t.dtype == torch.bfloat16:
        return t, None
    hi = torch.empty(t.shape, dtype=torch.bfloat16, device=t.device)
    lo = torch.empty_like(hi)
    fn = _build.bind("ssd_scan", "covenant_ssd_split", [_P, _P, _P, _L, _P])
    stream = torch.cuda.current_stream(t.device).cuda_stream
    _build.check("ssd_scan", fn(t.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                                t.numel(), stream))
    return hi, lo


def _launch(x, dt, A, B, C, chunk: int, rep: int) -> tuple[torch.Tensor, ...]:
    """Launch ``csrc/ssd_scan.cu`` on checked CUDA tensors: (y_intra,
    states, dsums) as ``ssd_chunk_local_plain`` gives them."""
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in (dt, A, B, C)):
        raise ValueError(f"ssd_chunk_scan: unsupported devices "
                         f"{[str(t.device) for t in (x, dt, A, B, C)]}")
    if x.dtype not in _PARTS or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_chunk_scan: unsupported dtypes {x.dtype}, "
                        f"{B.dtype}, {C.dtype}")
    bh, s, p = x.shape
    n = B.shape[-1]
    nck = s // chunk
    parts = _PARTS[x.dtype]
    bl, bc = ssd_mma_blocks(chunk, n, p, heads=bh * nck, parts=parts)
    xp, bp, cp = (_aligned(_pad8(t)) for t in (x, B, C))
    pp, npad = xp.shape[-1], bp.shape[-1]
    dt = dt.to(torch.float32).contiguous()
    A = A.to(torch.float32).contiguous()
    y = torch.empty((bh, s, pp), dtype=torch.float32, device=x.device)
    states = torch.empty((bh * nck, npad, pp), dtype=torch.float32,
                         device=x.device)
    dsums = torch.empty((bh * nck,), dtype=torch.float32, device=x.device)
    fn = _build.bind("ssd_scan", "covenant_ssd_scan_mma",
                     [_P] * 11 + [_I] * 8 + [_P])
    with torch.cuda.device(x.device):
        (xh, xl), (bhi, blo), (chi, clo) = (_parts(t) for t in (xp, bp, cp))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        err = fn(ptr(xh), ptr(xl), dt.data_ptr(), A.data_ptr(), ptr(bhi),
                 ptr(blo), ptr(chi), ptr(clo), y.data_ptr(),
                 states.data_ptr(), dsums.data_ptr(), bh, s, chunk, npad, pp,
                 rep, bl, bc, stream)
    _build.check("ssd_scan", err)
    ssd_chunk_scan.launches += 1
    if pp != p or npad != n:
        y, states = y[..., :p], states[:, :n, :p]
    return y, states, dsums


class SsdChunkLocal(torch.autograd.Function):
    """The chunk-local stage with a gradient.  ``apply(x, dt, A, B, C,
    chunk)``: the forward runs the kernel on a CUDA tensor and the plain
    local stage on a CPU one; the backward recomputes the local stage
    through ``ssd_chunk_local_plain`` under autograd."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        rep = _check(x, dt, A, B, C, chunk)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        if x.device.type == "cpu":
            return ssd_chunk_local_plain(x, dt, A, B, C, chunk=chunk)
        return _launch(x, dt, A, B, C, chunk, rep)

    @staticmethod
    def backward(ctx, gy, gstates, gdsums):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(w) for t, w in
                      zip(saved, need)]
            outs = ssd_chunk_local_plain(*leaves, chunk=ctx.chunk)
            wanted = [t for t, w in zip(leaves, need) if w]
            grads = iter(torch.autograd.grad(outs, wanted,
                                             (gy, gstates, gdsums),
                                             allow_unused=True))
        return (*(next(grads) if w else None for w in need), None)


def ssd_chunk_local(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, *, chunk: int
                    ) -> tuple[torch.Tensor, ...]:
    """The chunk-local stages: (y_intra (BH, S, P) f32, states (BH * chunks,
    N, P) f32, dsums (BH * chunks,) f32), with the tiler's row and column
    blocks.  CPU tensors take ``ssd_chunk_local_plain``; CUDA tensors
    launch the kernel or raise.  Gradients flow to x, dt, A, B and C
    (``SsdChunkLocal``)."""
    return SsdChunkLocal.apply(x, dt, A, B, C, chunk)


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
    (``ssd_chunk_local``); the cross-chunk combination is torch, and
    autograd follows both."""
    _check(x, dt, A, B, C, chunk)
    local = ssd_chunk_local(x, dt, A, B, C, chunk=chunk)
    return _inter_chunk(x, dt, A, C, *local, chunk, init_state)


ssd_chunk_scan.launches = 0

__all__ = ["SsdChunkLocal", "ssd_chunk_local", "ssd_chunk_local_plain",
           "ssd_chunk_scan", "ssd_chunk_scan_plain"]
