"""Shared building blocks: initializers, norms, RoPE, MLPs, embeddings.

The counterpart of ``repro/models/common.py``: plain functions over
parameter dicts of tensors; ``init_*`` builders draw from an explicit
``torch.Generator`` on an explicit device.  Compute happens in
``cfg.compute_dtype``; normalization statistics and softmax always in f32.
``shard_act`` is the reference's activation-sharding constraint: on a
DTensor, inside a mesh that the launcher configured, a ``redistribute`` to
the requested placements; everywhere else a no-op.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)

from .config import ArchConfig


def cdt(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def pdt(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# activation sharding (sequence parallelism for the residual stream)
# ---------------------------------------------------------------------------

# configured by the launcher/dry-run (requires an ambient mesh); tests and
# single-device runs leave it unset -> no-op.
_ACT_AXES: dict = {"batch": None, "seq": None, "heads": None, "vocab": None}
_MESH: list = [None]


@contextlib.contextmanager
def ambient_mesh(mesh):
    """Make ``mesh`` the one ``current_mesh`` returns inside the block
    (``launch.mesh.use_mesh``)."""
    prev, _MESH[0] = _MESH[0], mesh
    try:
        yield mesh
    finally:
        _MESH[0] = prev


def current_mesh():
    """The ambient ``DeviceMesh``, or None when no mesh is active."""
    return _MESH[0]


def configure_activation_sharding(batch_axes=None, seq_axes=None,
                                  heads_axes=None, vocab_axes=None) -> None:
    """E.g. batch_axes=("pod","data"), seq_axes="model", heads_axes="model".
    ``seq`` shards the residual stream (sequence parallelism); ``heads``
    makes attention head-parallel; ``vocab`` keeps logits vocab-sharded
    into the loss.  All None -> disabled."""
    _ACT_AXES["batch"] = batch_axes
    _ACT_AXES["seq"] = seq_axes
    _ACT_AXES["heads"] = heads_axes
    _ACT_AXES["vocab"] = vocab_axes


_IMPLICIT = [0]


@contextlib.contextmanager
def replicating():
    """Plain tensors count as replicated DTensors inside the block
    (``implicit_replication``), which may nest: the flag clears when the
    outermost block ends."""
    if _IMPLICIT[0]:
        _IMPLICIT[0] += 1
        try:
            yield
        finally:
            _IMPLICIT[0] -= 1
        return
    _IMPLICIT[0] = 1
    try:
        with implicit_replication():
            yield
    finally:
        _IMPLICIT[0] = 0


def _axis_names(ax) -> tuple:
    return () if ax is None else ((ax,) if isinstance(ax, str) else tuple(ax))


def shard_act(x: torch.Tensor, logical: tuple) -> torch.Tensor:
    """Constrain an activation; ``logical`` entries are "batch"/"seq"/
    "heads"/"vocab"/None per dim.  No-op unless configure_activation_sharding
    was called inside a mesh context and ``x`` is a DTensor.  A dim not
    divisible by its mesh axes (heads, most often) stays unsharded."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor) or \
            all(v is None for v in _ACT_AXES.values()):
        return x
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    dim_of = {}
    for d, name in enumerate(logical):
        axes = _axis_names(_ACT_AXES.get(name) if isinstance(name, str)
                           else None)
        size = math.prod(sizes[a] for a in axes)
        if axes and x.shape[d] % size == 0 and x.shape[d] >= size:
            dim_of.update({a: d for a in axes})
    placements = tuple(Shard(dim_of[n]) if n in dim_of else Replicate()
                       for n in mesh.mesh_dim_names)
    return x if x.placements == placements else \
        _Constrain.apply(x, placements)


class _Constrain(torch.autograd.Function):
    """``redistribute`` whose backward hands back a gradient whose local
    shard is contiguous, as its DTensor's strides say: a local shard that
    a collective left strided would make a later ``reshape`` take a view
    it cannot."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.src = x.placements
        if x.placements == placements:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        g = g.redistribute(g.device_mesh, ctx.src)
        return DTensor.from_local(g.to_local().contiguous(), g.device_mesh,
                                  ctx.src, run_check=False, shape=g.shape,
                                  stride=_contiguous_strides(g.shape)), None


def _contiguous_strides(shape) -> tuple:
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def pinned(t: DTensor) -> DTensor:
    """``t`` as it is, its gradient brought back to ``t``'s placements,
    so the backward of the ops that made ``t`` finds the split they
    expect."""
    return _Constrain.apply(t, t.placements)


def batch_split(t: DTensor) -> DTensor:
    """``t`` with only its batch (dim 0) split kept; every other split
    and partial sum made whole."""
    keep = tuple(p if p == Shard(0) else Replicate() for p in t.placements)
    return t if keep == t.placements else t.redistribute(t.device_mesh, keep)


def whole(t):
    """A DTensor ``t`` as a replicated DTensor, for an op that needs the
    whole tensor on every rank (a weight at its use, ZeRO-3's gather; a
    batch before its microbatches are cut).  Where every mesh dim that
    splits ``t`` has one rank, the local tensor is already whole and is
    relabelled, not copied.  Anything else passes through."""
    if not isinstance(t, DTensor):
        return t
    rep = (Replicate(),) * t.device_mesh.ndim
    if t.placements == rep:
        return t
    if tuple(t.to_local().shape) == tuple(t.shape) and \
            not any(p.is_partial() for p in t.placements):
        return DTensor.from_local(t.to_local(), t.device_mesh, rep,
                                  run_check=False)
    return t.redistribute(t.device_mesh, rep)


class _AtUse(dict):
    """A param dict whose DTensor leaves are gathered whole (``whole``)
    each time the model reads one, and not before: a layer's weights are
    gathered inside its (checkpointed) layer function, freed when it ends
    and gathered again by its recompute in the backward, whose gradients
    reduce-scatter back onto the split (ZeRO-3).  Nested dicts and lists
    read the same way."""

    def __getitem__(self, k):
        return at_use(dict.__getitem__(self, k))

    def get(self, k, default=None):
        return self[k] if k in self else default

    def items(self):
        return [(k, self[k]) for k in self]

    def values(self):
        return [self[k] for k in self]


class _AtUseList(list):
    """A list of ``_AtUse`` entries (a model's layers)."""

    def __getitem__(self, i):
        if isinstance(i, slice):
            return _AtUseList(list.__getitem__(self, i))
        return at_use(list.__getitem__(self, i))

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def at_use(tree):
    """``tree`` (a param tree) read through ``_AtUse``: each DTensor leaf
    gathered whole where the model reads it; a plain leaf as it is."""
    if isinstance(tree, dict):
        return tree if isinstance(tree, _AtUse) else _AtUse(tree)
    if isinstance(tree, list):
        return tree if isinstance(tree, _AtUseList) else _AtUseList(tree)
    return whole(tree)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    """Normal(0, 1/fan_in) with fan_in = shape[0], as ``x @ W`` reads W."""
    std = 1.0 / math.sqrt(max(shape[0], 1))
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ArchConfig, device) -> dict:
    d = cfg.d_model
    p = {"scale": torch.ones((d,), dtype=pdt(cfg), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=pdt(cfg), device=device)
    return p


def apply_norm(cfg: ArchConfig, p: dict, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return out.to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """qwen3 qk-norm: RMS over the head_dim of (..., H, S, D) tensors."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings (with partial-rotary support)
# ---------------------------------------------------------------------------


def rope_frequencies(cfg: ArchConfig, positions: torch.Tensor) -> tuple:
    """(sin, cos) of shape (..., rot_dim/2) for given positions."""
    rot = int(cfg.hd * cfg.rope_frac)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32,
                        device=positions.device) / rot
    inv = 1.0 / (cfg.rope_theta ** exps)
    ang = positions.float()[..., None] * inv  # (..., rot/2)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, H, S, D); sin/cos: (B, S, rot/2) or (S, rot/2)."""
    rot = sin.shape[-1] * 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    if sin.ndim == 2:
        s, c = sin[None, None], cos[None, None]
    else:
        s, c = sin[:, None], cos[:, None]
    s, c = s.float(), c.float()
    x1f, x2f = x1.float(), x2.float()
    o1 = x1f * c - x2f * s
    o2 = x2f * c + x1f * s
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], -1) if xp.shape[-1] else out


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(cfg: ArchConfig, gen: torch.Generator, d_ff: int | None = None
             ) -> dict:
    dm = cfg.d_model
    ff = d_ff or cfg.d_ff
    dtype = pdt(cfg)
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "wi": dense_init(gen, (dm, ff), dtype),
            "wg": dense_init(gen, (dm, ff), dtype),
            "wo": dense_init(gen, (ff, dm), dtype),
        }
    return {
        "wi": dense_init(gen, (dm, ff), dtype),
        "wo": dense_init(gen, (ff, dm), dtype),
    }


def apply_mlp(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["wi"].to(x.dtype)
    if cfg.mlp == "swiglu":
        h = F.silu(h) * (x @ p["wg"].to(x.dtype))
    elif cfg.mlp == "geglu":
        h = F.gelu(h, approximate="tanh") * (x @ p["wg"].to(x.dtype))
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------


def init_embed(cfg: ArchConfig, gen: torch.Generator) -> dict:
    p = {"tokens": embed_init(gen, (cfg.vocab, cfg.d_model), pdt(cfg))}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab), pdt(cfg))
    return p


def split_grads(placements) -> tuple:
    """The gradient placements of a whole input read by every rank of a
    split: summed over each split mesh dim."""
    return tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in placements)


def _lookup(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``w[idx]``; on DTensors, each rank looks up its own rows of ``idx``
    in the whole ``w`` (its gradient summed over the split), with no
    sharding rule for the lookup's backward needed."""
    if not isinstance(idx, DTensor):
        return w[idx]
    ip = idx.placements
    return local_map(lambda wl, il: wl[il], out_placements=(ip,),
                     in_placements=((Replicate(),) * len(ip), ip),
                     in_grad_placements=(split_grads(ip), ip),
                     device_mesh=idx.device_mesh,
                     redistribute_inputs=True)(w, idx)


def embed_tokens(cfg: ArchConfig, p: dict, tokens: torch.Tensor
                 ) -> torch.Tensor:
    x = _lookup(p["tokens"].to(cdt(cfg)), tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cdt(cfg))
    return x


def logits_from_hidden(cfg: ArchConfig, p: dict, x: torch.Tensor
                       ) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = p["tokens"].to(cdt(cfg)).T
    else:
        w = p["unembed"].to(cdt(cfg))
    if isinstance(x, DTensor) and isinstance(w, DTensor):
        # where the logits are to be split over their vocab, make them so:
        # the weight split over its vocab (a local slice of the whole one)
        # and the rows whole along their sequence, so no rank makes a
        # whole-vocab block to split afterwards
        ws = shard_act(w, (None, "vocab"))
        if ws is not w:
            xp = tuple(p if p == Shard(0) and q != Shard(1) else Replicate()
                       for p, q in zip(x.placements, ws.placements))
            x, w = _Constrain.apply(x, xp), ws
    logits = (x @ w).float()
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return shard_act(logits, ("batch",) + (None,) * (logits.ndim - 2)
                     + ("vocab",))


def _log_likelihood(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return picked - lse


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE over weighted tokens; logits (B,S,V) f32,
    targets (B,S).  The reference picks the target logit with a masked sum
    to keep a vocab-sharded tensor sharded, and so does the port on a
    DTensor split over its vocab; elsewhere a gather picks the same value,
    on a DTensor on each rank's own rows."""
    if not isinstance(logits, DTensor):
        ll = _log_likelihood(logits, targets)
    elif Shard(logits.ndim - 1) in logits.placements:
        # the log-sum-exp of split rows: a max and a sum across the
        # split (a stable shift needs no gradient), never the whole rows
        m = logits.detach().amax(-1, keepdim=True)
        lse = (logits - m).exp().sum(-1).log() + m[..., 0]
        mesh, last = logits.device_mesh, Shard(logits.ndim - 1)
        vocab = DTensor.from_local(
            torch.arange(logits.shape[-1], device=targets.device), mesh,
            (Replicate(),) * mesh.ndim, run_check=False).redistribute(
            mesh, tuple(Shard(0) if p == last else Replicate()
                        for p in logits.placements))
        hit = vocab == targets[..., None].long()
        ll = torch.where(hit, logits, 0.0).sum(-1) - lse
    else:
        lp = logits.placements
        ll = local_map(_log_likelihood, out_placements=(lp,),
                       in_placements=(lp, lp), device_mesh=logits.device_mesh,
                       redistribute_inputs=True)(logits, targets)
    if weights is None:
        weights = torch.ones_like(ll)
    return -(ll * weights).sum() / torch.clamp(weights.sum(), min=1.0)


__all__ = ["ambient_mesh", "apply_mlp", "apply_norm", "apply_rope", "at_use",
           "cdt",
           "configure_activation_sharding", "cross_entropy", "current_mesh",
           "dense_init", "embed_init", "embed_tokens", "init_embed",
           "init_mlp", "init_norm", "logits_from_hidden", "pdt",
           "batch_split", "pinned", "replicating", "rms_head_norm",
           "rope_frequencies", "shard_act", "split_grads", "whole"]
