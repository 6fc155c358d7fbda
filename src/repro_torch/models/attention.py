"""Attention for the model zoo: plain paths and the kernel dispatch.

The counterpart of ``repro/models/attention.py``:

* ``dense_attention``  — einsum + masked softmax, exact; the plain path of
  prefill (the reference's choice for ``sq <= 2048``, ``:376-379``).
* ``decode_attention`` — one new token against the KV cache, in the
  grouped-GQA form.

The reference's docstring says the models dispatch to the Pallas kernels
on a TPU, but its model code never calls them, in serving or in training.
The port does what that docstring describes: ``prefill_attention`` (the
full-sequence attention of training and prefill, causal or not) and
``decode_attention_for`` send the models through
``repro_torch.kernels.ops`` when ``attn="kernel"`` and through the plain
functions here when ``attn="plain"``.  Both compute the same function.  In
training, ``ops.covenant_attention`` takes the autograd Function over the
LSE forward and the flash backward kernels; the plain path runs
``dense_attention`` under plain autograd.

Window semantics differ between the layers: the models pass ``window=0``
to mean no window, while ``ops`` (like the reference's kernels and
``attention_ref``) read 0 as a window that masks everything and ``None``
as no window.  The dispatch turns 0 into None.
"""
from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..kernels import ops
from ..kernels.tiling import decode_block_kv
from .common import shard_act

NEG_INF = -1e30
ATTN_IMPLS = ("kernel", "plain")


def _repeat_kv(k: torch.Tensor, hq: int) -> torch.Tensor:
    hkv = k.shape[1]
    return k if hkv == hq else k.repeat_interleave(hq // hkv, dim=1)


def _shard_heads(q, k, v):
    """Head-parallel constraint (no-op unless the launcher configured
    activation sharding): move the model axis from the sequence dim onto
    heads before the attention math, so logits shard over heads instead
    of replicating.  A head count the axis does not divide stays
    unsharded: on the kernel path, where k/v keep their kv heads, each
    rank then takes the kv heads of its own q heads (``kernels.ops``)."""
    spec = ("batch", "heads", None, None)
    return shard_act(q, spec), shard_act(k, spec), shard_act(v, spec)


def dense_attention(q, k, v, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """q (B,Hq,Sq,D), k/v (B,Hkv,Sk,D).  The reference's ``q_offset``,
    ``scale`` and ``kv_len`` arguments have no caller yet."""
    k = _repeat_kv(k, q.shape[1])
    v = _repeat_kv(v, q.shape[1])
    q, k, v = _shard_heads(q, k, v)
    core = functools.partial(_dense_core, causal=causal, window=window)
    if not isinstance(q, DTensor):
        return core(q, k, v)
    # each (batch row, head) attends on its own: on DTensors the math runs
    # on each rank's rows and heads, the rest of the split made whole
    mesh = q.device_mesh
    qp = tuple(p if p in (Shard(0), Shard(1)) else Replicate()
               for p in q.placements)
    return local_map(core, out_placements=(qp,), in_placements=(qp,) * 3,
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def _dense_core(q, k, v, *, causal: bool, window: int) -> torch.Tensor:
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * d ** -0.5
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def decode_attention(q, k_cache, v_cache, kv_len) -> torch.Tensor:
    """One new token vs the cache.  q (B,Hq,D), caches (B,Hkv,S,D),
    kv_len (B,) = number of valid entries INCLUDING the new token.  The
    reference's ``window`` and ``scale`` arguments have no caller."""
    b, hq, d = q.shape
    hkv = k_cache.shape[1]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d)
    s = k_cache.shape[2]
    logits = torch.einsum("bhgd,bhkd->bhgk", qg.float(),
                          k_cache.float()) * d ** -0.5
    kpos = torch.arange(s, device=q.device)[None, None, None]
    mask = kpos < kv_len[:, None, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return out.reshape(b, hq, d).to(q.dtype)


def _check_impl(attn: str) -> None:
    if attn not in ATTN_IMPLS:
        raise ValueError(f"attn must be one of {ATTN_IMPLS}, got {attn!r}")


def prefill_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      attn: str = "kernel") -> torch.Tensor:
    """Attention over a whole sequence (training forward or prompt); q
    (B,Hq,Sq,D), k/v (B,Hkv,Sk,D).  Causal self attention (Sq = Sk) by
    default; ``causal=False`` is bidirectional, and then Sq may differ
    from Sk (whisper's encoder and its cross attention).  ``window`` is
    the model's (0 = none).  Gradients flow through either path."""
    _check_impl(attn)
    if attn == "plain":
        return dense_attention(q, k, v, causal=causal, window=window)
    return ops.covenant_attention(*_shard_heads(q, k, v), causal=causal,
                                  window=window or None)


def decode_attention_for(q, k_cache, v_cache, kv_len, *,
                         attn: str = "kernel") -> torch.Tensor:
    """One token per row against the cache, through the decode kernel or
    the plain path.  Like the reference's model decode, it takes no window:
    a local layer's window is its rolling cache."""
    _check_impl(attn)
    if attn == "plain":
        return decode_attention(q, k_cache, v_cache, kv_len)
    b, hq, d = q.shape
    _, hkv, s, _ = k_cache.shape
    return ops.covenant_decode_attention(
        q, k_cache, v_cache, kv_len,
        block_kv=decode_block_kv(b * hkv, s, d, hq // hkv))


__all__ = ["ATTN_IMPLS", "decode_attention", "decode_attention_for",
           "dense_attention", "prefill_attention"]
