"""Public kernel API: padding, block selection, GQA and device dispatch.

The counterpart of ``repro/kernels/ops.py`` with the same signatures, less
``interpret``: a CPU tensor runs each kernel's plain PyTorch version, a
CUDA tensor launches the Hopper kernel or raises.  Block geometry defaults
to the Covenant tiler's Algorithm-1 choice against the ``h100`` covenant
(``tiling.gemm_blocks`` / ``attention_blocks`` / ``ssd_mma_blocks``).

``covenant_attention``, ``covenant_decode_attention`` and ``covenant_ssd``
also take DTensors (the sharded train step and the dry-run): each runs its
kernel on every rank's local shard through ``local_map``, the autograd
Functions (``FlashAttention``, the SSD's) included.  A split of the batch
(and, for attention, of the heads) stays local; every other split is
gathered first, since a kernel needs whole sequences.  Where q's heads are
split over a mesh dim and k/v's are not (fewer kv heads than ranks), each
rank takes the kv heads of its own q heads, and k/v's gradients come back
partial over that dim.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from . import ref as _ref
from .flash_attention import FlashAttention
from .flash_attention import flash_attention as _fa, flash_decode as _fd
from .matmul import matmul as _mm
from .ssd_scan import ssd_chunk_scan as _ssd
from .tiling import (attention_blocks, attention_bwd_blocks,
                     attention_bwd_mma_blocks, attention_mma_blocks,
                     gemm_blocks)


def _pad_to(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    s = x.shape[axis]
    t = -(-s // mult) * mult
    if t == s:
        return x
    pads = [0, 0] * x.ndim
    pads[2 * (x.ndim - 1 - axis) + 1] = t - s
    return F.pad(x, pads)


def covenant_matmul(a: torch.Tensor, b: torch.Tensor, *,
                    out_dtype: torch.dtype | None = None,
                    blocks: tuple[int, int, int] | None = None
                    ) -> torch.Tensor:
    """GEMM with Covenant-tiled blocks.  The bf16 tensor-core kernel on a
    CUDA tensor takes ragged edges itself, so nothing is padded to the
    blocks: only K and N are, to multiples of 8 (TMA's row stride), where
    they are not already.  Every other case pads to block multiples."""
    m, k = a.shape
    _, n = b.shape
    is_int = not a.dtype.is_floating_point
    out_dtype = out_dtype or (torch.int32 if is_int else torch.float32)
    in_dt = "i8" if is_int else ("f32" if a.dtype == torch.float32
                                 else "bf16")
    if blocks is None:
        blocks = gemm_blocks(m, n, k, in_dtype=in_dt, wgmma=in_dt == "bf16")
    bm, bn, bk = blocks
    if in_dt == "bf16" and a.device.type == "cuda":
        ap, bp = _pad_to(a, 1, 8), _pad_to(_pad_to(b, 0, 8), 1, 8)
        out = _mm(ap, bp, block_m=bm, block_n=bn, block_k=bk,
                  out_dtype=out_dtype)
        return out if out.shape[1] == n else out[:, :n]
    ap = _pad_to(_pad_to(a, 0, bm), 1, bk)
    bp = _pad_to(_pad_to(b, 0, bk), 1, bn)
    out = _mm(ap, bp, block_m=bm, block_n=bn, block_k=bk, out_dtype=out_dtype)
    return out[:m, :n]


def _kept(t: DTensor, dims: tuple) -> tuple:
    """``t``'s placements with every split of a dim outside ``dims``, and
    every partial sum, made whole."""
    return tuple(p if isinstance(p, Shard) and p.dim in dims else Replicate()
                 for p in t.placements)


def _head_layout(q: DTensor, k: DTensor):
    """(q's local placements, k/v's, k/v's gradient placements, the mesh
    dim over which q's heads split and k/v's do not, or None)."""
    qp = _kept(q, (0, 1))
    kp, gp, pick = [], [], None
    for i, (pq, pk) in enumerate(zip(qp, k.placements)):
        if pq == Shard(1) and pk != Shard(1):
            if pick is not None:
                raise ValueError("q heads split over two mesh dims that do "
                                 "not split the kv heads")
            pick = i
            kp.append(Replicate())
            gp.append(Partial())
        else:
            kp.append(pq)
            gp.append(pq)
    return qp, tuple(kp), tuple(gp), pick


def _own_kv(k: torch.Tensor, v: torch.Tensor, hq: int, hkv: int,
            lhq: int, rank: int):
    """The local k, v of a rank whose q heads are ``[rank * lhq, (rank + 1)
    * lhq)`` of ``hq`` (GQA group ``hq // hkv``), from the whole ``hkv``
    heads: a contiguous slice where its heads share whole groups, else one
    kv head per q head (group 1)."""
    g = hq // hkv
    lo = rank * lhq
    if lhq % g == 0 or g % lhq == 0:
        a, b = lo // g, (lo + lhq - 1) // g + 1
        return k[:, a:b], v[:, a:b]
    idx = torch.arange(lo, lo + lhq, device=k.device) // g
    return k.index_select(1, idx), v.index_select(1, idx)


def _sharded_attention(q, k, v, **kw) -> DTensor:
    hq, hkv = q.shape[1], k.shape[1]
    mesh = q.device_mesh
    qp, kp, gp, pick = _head_layout(q, k)
    rank = mesh.get_local_rank(pick) if pick is not None else 0

    def run(ql, kl, vl):
        if pick is not None:
            kl, vl = _own_kv(kl, vl, hq, hkv, ql.shape[1], rank)
        return covenant_attention(ql, kl, vl, **kw)

    return local_map(run, out_placements=(qp,), in_placements=(qp, kp, kp),
                     in_grad_placements=(qp, gp, gp), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def covenant_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: int | None = None,
                       scale: float | None = None,
                       blocks: tuple[int, int] | None = None) -> torch.Tensor:
    """GQA flash attention.  q: (B,Hq,Sq,D), k/v: (B,Hkv,Sk,D).

    The kernel reads kv head ``h // (Hq // Hkv)`` for q head ``h`` rather
    than repeating k and v, and masks the ragged q edge itself rather than
    padding q; ``q_offset = Sk - Sq`` as in the reference.  When autograd
    needs a gradient of q, k or v, the call goes through ``FlashAttention``
    (the LSE forward, then the flash backward, with the tiler's backward
    blocks); otherwise through the forward-only kernel.  Both compute the
    same output, with the same masks.  bf16 takes the tensor-core kernels'
    blocks (``attention_mma_blocks``: block_q a whole number of 64-row
    tiles, even past a short Sq, whose edge the kernel masks; and
    ``attention_bwd_mma_blocks`` for the backward), f32 the SIMT kernels'
    (``attention_blocks``, block_q cut to Sq; ``attention_bwd_blocks``)."""
    if isinstance(q, DTensor):
        return _sharded_attention(q, k, v, causal=causal, window=window,
                                  scale=scale, blocks=blocks)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    mma = q.dtype == torch.bfloat16
    if blocks is None:
        pick = attention_mma_blocks if mma else attention_blocks
        bq, bkv = pick(sq, sk, d, heads=b * hq)
    else:
        bq, bkv = blocks
    if not mma:
        bq = min(bq, sq)
    qf = q.reshape(b * hq, sq, d)
    kf, vf = k.reshape(b * hkv, sk, d), v.reshape(b * hkv, sk, d)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        # the bf16 backward on the card takes its tensor-core blocks (and
        # raises for a head dim it is not built for); CPU tensors take the
        # plain backward, which uses no blocks
        pick = attention_bwd_mma_blocks if mma and q.device.type == "cuda" \
            else attention_bwd_blocks
        bwd_blocks = pick(sq, sk, d, heads=b * hq)
        out = FlashAttention.apply(qf, kf, vf, causal, window, scale,
                                   (bq, bkv), bwd_blocks, sk - sq)
    else:
        out = _fa(qf, kf, vf, causal=causal, window=window, scale=scale,
                  block_q=bq, block_kv=bkv, q_offset=sk - sq)
    return out.reshape(b, hq, sq, d)


def covenant_decode_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, kv_len: torch.Tensor, *,
                              scale: float | None = None,
                              block_kv: int = 512) -> torch.Tensor:
    """One-token GQA decode.  q: (B,Hq,D), cache k/v: (B,Hkv,S,D),
    kv_len: (B,).  Returns (B,Hq,D)."""
    if isinstance(q, DTensor):
        hq, hkv = q.shape[1], k.shape[1]
        mesh = q.device_mesh
        qp, kp, _, pick = _head_layout(q, k)
        lp = tuple(p if p == Shard(0) else Replicate() for p in qp)
        rank = mesh.get_local_rank(pick) if pick is not None else 0

        def run(ql, kl, vl, ll):
            if pick is not None:
                kl, vl = _own_kv(kl, vl, hq, hkv, ql.shape[1], rank)
            return covenant_decode_attention(ql, kl, vl, ll, scale=scale,
                                             block_kv=block_kv)

        return local_map(run, out_placements=(qp,),
                         in_placements=(qp, kp, kp, lp), device_mesh=mesh,
                         redistribute_inputs=True)(q, k, v, kv_len)
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b * hkv, g, d)
    kf = k.reshape(b * hkv, s, d)
    vf = v.reshape(b * hkv, s, d)
    # the kernel reads batch entry r // hkv's length for row r
    out = _fd(qg, kf, vf, kv_len, scale=scale, block_kv=min(block_kv, s),
              kv_heads=hkv)
    return out.reshape(b, hq, d)


def covenant_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, *, chunk: int = 64,
                 init_state: torch.Tensor | None = None,
                 return_state: bool = False):
    """Mamba2 SSD over (b, s, h, p) inputs with (b, s, g, n) B/C; dt
    (b, s, h) after softplus, A (h,).  The state, ``init_state`` and the
    returned one, is (b, h, p, n), as in ``ref.ssd_ref``.  S is padded to
    the chunk with dt = 0, so a padded step neither decays nor adds.  B and
    C are passed per group, unrepeated: the kernel reads group
    ``h // (H / G)`` for head ``h``.  DTensors keep only their batch
    split; A, whole on every rank, gets its gradient summed over it."""
    if isinstance(x, DTensor):
        bp = _kept(x, (0,))
        args = (x, dt, A, B, C) + (() if init_state is None
                                   else (init_state,))
        inp = tuple((Replicate(),) * len(bp) if a is A else bp for a in args)
        # every rank's batch adds to A's gradient
        a_grad = tuple(Partial() if isinstance(p, Shard) else p for p in bp)
        grads = tuple(a_grad if a is A else bp for a in args)

        def run(xl, dtl, al, bl, cl, st0=None):
            return covenant_ssd(xl, dtl, al, bl, cl, chunk=chunk,
                                init_state=st0, return_state=return_state)

        return local_map(run, out_placements=(bp, bp) if return_state
                         else (bp,), in_placements=inp,
                         in_grad_placements=grads, device_mesh=x.device_mesh,
                         redistribute_inputs=True)(*args)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    ck = min(chunk, s)
    spad = -(-s // ck) * ck
    xf = _pad_to(x, 1, ck).transpose(1, 2).reshape(b * h, spad, p)
    dtf = _pad_to(dt, 1, ck).transpose(1, 2).reshape(b * h, spad)
    bf = _pad_to(B, 1, ck).transpose(1, 2).reshape(b * g, spad, n)
    cf = _pad_to(C, 1, ck).transpose(1, 2).reshape(b * g, spad, n)
    af = A.repeat(b)
    st0 = None
    if init_state is not None:
        st0 = init_state.reshape(b * h, p, n).transpose(1, 2)  # (BH,N,P)
    y, fin = _ssd(xf, dtf, af, bf, cf, chunk=ck, init_state=st0)
    y = y[:, :s].reshape(b, h, s, p).transpose(1, 2)
    if return_state:
        return y, fin.transpose(1, 2).reshape(b, h, p, n)
    return y


# re-export oracles for convenience
matmul_ref = _ref.matmul_ref
attention_ref = _ref.attention_ref
ssd_ref = _ref.ssd_ref

__all__ = ["attention_ref", "covenant_attention", "covenant_decode_attention",
           "covenant_matmul", "covenant_ssd", "matmul_ref", "ssd_ref"]
