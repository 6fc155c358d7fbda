"""Explicit collectives: compressed gradient psum + seq-sharded decode
attention with LSE combine.

The counterpart of ``repro/runtime/collectives.py``, with its numerics,
on ``torch.distributed`` functional collectives over a mesh axis's
sub-group (the reference's ``shard_map`` bodies):

* ``compressed_psum``   — int8-on-the-wire gradient all-reduce: quantise
  each rank's tensor, sum the int8 payload widened to int32 over the
  ``data`` sub-group (the sum of n int8 shards needs log2(n) extra bits),
  rescale by the largest scale (a max over the sub-group).
* ``sharded_decode_attention`` — decode attention with the KV cache split
  along *sequence* over the ``model`` sub-group: each rank computes
  partial (max, sum, acc) over its kv slice, and the result is combined
  with a numerically stable log-sum-exp reduction, a zero sum guarded —
  the distributed flash-decode pattern for kv_heads < |model|.
"""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..tree import tree_map

NEG_INF = -1e30


def _wait(t: torch.Tensor) -> torch.Tensor:
    return funcol.wait_tensor(t) if isinstance(
        t, funcol.AsyncCollectiveTensor) else t


def compressed_psum(grads, mesh, axis: str = "data"):
    """All-reduce a tree of each rank's own tensors with int8 payloads
    (error feedback is the optimizer wrapper's job; this is the wire
    primitive).  Returns f32 tensors, the same on every rank of the
    sub-group."""
    group = mesh.get_group(axis)

    def one(g):
        g = g.to_local() if isinstance(g, DTensor) else g
        gf = g.to(torch.float32)
        scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        qsum = _wait(funcol.all_reduce(q.to(torch.int32), "sum", group))
        smax = _wait(funcol.all_reduce(scale, "max", group))
        return qsum.to(torch.float32) * smax

    return tree_map(one, grads)


def _seq_local(t: torch.Tensor, mesh, seq_axis: str) -> torch.Tensor:
    """This rank's slice of a cache split on S over ``seq_axis``: a
    DTensor's (redistributed there first if need be), or the rank's piece
    of a whole tensor that every rank holds."""
    dim = mesh.mesh_dim_names.index(seq_axis)
    want = tuple(Shard(2) if i == dim else Replicate()
                 for i in range(mesh.ndim))
    if isinstance(t, DTensor):
        if t.placements != want:
            t = t.redistribute(mesh, want)
        return t.to_local()
    n, r = mesh.size(dim), mesh.get_local_rank(seq_axis)
    return t.chunk(n, dim=2)[r]


def sharded_decode_attention(q, k_cache, v_cache, kv_len, mesh,
                             seq_axis: str = "model",
                             scale: float | None = None) -> torch.Tensor:
    """q (B,H,D) the same on every rank of ``seq_axis``; caches (B,H,S,D)
    split on S over it (DTensors, or whole tensors of which each rank
    takes its piece).  Returns (B,H,D).  GQA repeat must be done by the
    caller."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    group = mesh.get_group(seq_axis)
    qs = q.to_local() if isinstance(q, DTensor) else q
    lens = kv_len.to_local() if isinstance(kv_len, DTensor) else kv_len
    ks = _seq_local(k_cache, mesh, seq_axis)
    vs = _seq_local(v_cache, mesh, seq_axis)
    idx = mesh.get_local_rank(seq_axis)
    s_local = ks.shape[2]
    kpos = idx * s_local + torch.arange(s_local, device=ks.device)[None, None]
    logits = torch.einsum("bhd,bhkd->bhk", qs.float(), ks.float()) * scale
    mask = kpos < lens[:, None, None]
    logits = torch.where(mask, logits, NEG_INF)
    m = torch.max(logits, -1, keepdim=True).values
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    l = p.sum(-1, keepdim=True)  # noqa: E741
    acc = torch.einsum("bhk,bhkd->bhd", p, vs.float())
    # LSE combine across ranks
    g_m = _wait(funcol.all_reduce(m, "max", group))
    alpha = torch.exp(m - g_m)
    g_l = _wait(funcol.all_reduce(l * alpha, "sum", group))
    g_acc = _wait(funcol.all_reduce(acc * alpha, "sum", group))
    return (g_acc / torch.where(g_l == 0.0, 1.0, g_l)).to(qs.dtype)


__all__ = ["compressed_psum", "sharded_decode_attention"]
