"""Mixture-of-Experts LM (deepseek-moe fine-grained with shared experts,
olmoe).

The counterpart of ``repro/models/moe.py``.  The MoE FFN uses sort-based
expert dispatch: each token's top-k assignments are sorted by expert
(a stable sort, so an expert's slots go to its tokens in token order),
packed into a capacity-bounded (E, C, d) buffer (overflow dropped, GShard
semantics), pushed through the experts' GEMMs as batched products, and
combined weighted by the renormalised router probabilities.  The router
runs in f32; the Switch load-balancing loss is ``aux_loss``.  The
reference has no Pallas kernel for any of it: the expert products are its
``jnp.einsum``s, here ``torch.bmm``.

Two departures in form, none in value: the combine puts the sorted
contributions back in (token, k) order and sums over k in a fixed order,
where the reference scatter-adds (on a card an f32 ``index_add_`` is not
bit-stable); and the capacity comes from shapes, with no host sync on the
path, so a decode step stays asynchronous.

The backward is bit-stable on a card too, with the gathers as they are.
The dispatch reads each token once per top-k choice (``xf[r.token]``),
and torch's CUDA backward of that gather sorts the indices and sums a
token's k rows in a fixed order: one MoE layer's input and weight
gradients came out bit-equal on two runs on an H100, in bf16 and f32, and
in f32 within 1.6e-6 of the CPU's (``chip_smoke.check_moe_backward``).
The combine reads row (E-1, 0) of the expert outputs for every dropped
entry (``y[clamp(slot_e), slot_c]``), but the ``where`` after it zeroes
those entries' gradients, so where that gather's backward sums over
colliding indices it adds only zeros.

The model is the dense transformer with this FFN: ``cfg.first_dense``
leading dense layers (``params["dense_layers"]``), then one MoE layer per
entry of ``params["layers"]``.  Both keep the reference's key paths, the
FFN under ``ffn`` in either kind of layer.  The KV cache is the dense
family's: one ``{"k", "v"}`` per layer, the dense layers first; prefill
and decode run the dense family's serving loop with this module's step
after attention.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map
from torch.utils._pytree import tree_leaves
from torch.utils.checkpoint import checkpoint

from . import transformer as dense
from .common import (apply_mlp, apply_norm, batch_split, cdt,
                     cross_entropy, dense_init, embed_tokens, init_embed,
                     init_mlp, init_norm, logits_from_hidden, pdt,
                     shard_act, split_grads, whole)
from .config import ArchConfig
from .. import tracing
from ..tree import tree_map

# ---------------------------------------------------------------------------
# MoE FFN
# ---------------------------------------------------------------------------


def init_moe_ffn(cfg: ArchConfig, gen: torch.Generator) -> dict:
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    dtype = pdt(cfg)
    p = {
        "router": dense_init(gen, (d, e), torch.float32),
        "wi": dense_init(gen, (e, d, ff), dtype),
        "wg": dense_init(gen, (e, d, ff), dtype),
        "wo": dense_init(gen, (e, ff, d), dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(cfg, gen, d_ff=(cfg.moe_d_ff or cfg.d_ff) *
                               cfg.n_shared_experts)
    return p


def capacity(cfg: ArchConfig, tokens: int) -> int:
    """Slots per expert for a block of ``tokens``: the capacity factor's
    share, rounded up to a multiple of 8, at least 8."""
    cap = int(cfg.capacity_factor * tokens * cfg.top_k / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)


def _router_probs(p: dict, xf: torch.Tensor) -> torch.Tensor:
    return torch.softmax(xf.float() @ p["router"].float(), dim=-1)


class Routing(NamedTuple):
    """One block's dispatch, in expert-sorted order of its T*k
    assignments."""

    order: torch.Tensor    # flat (token, k) index of each sorted entry
    token: torch.Tensor    # its token
    gate: torch.Tensor     # its renormalised f32 router weight
    slot_e: torch.Tensor   # its expert, or E where it overflowed (dropped)
    slot_c: torch.Tensor   # its slot in the expert's buffer (0 if dropped)
    keep: torch.Tensor     # False where it overflowed
    cap: int


def route(cfg: ArchConfig, p: dict, xf: torch.Tensor) -> Routing:
    """Top-k routing and capacity slots of one token block (T, d)."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    gate, eidx = torch.topk(_router_probs(p, xf), k, dim=-1)    # (T,k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    cap = capacity(cfg, t)
    order = torch.argsort(eidx.reshape(-1), stable=True)
    se = eidx.reshape(-1)[order]
    # rank within the expert's group = position - the group's start
    starts = torch.searchsorted(se, torch.arange(e, device=xf.device))
    rank = torch.arange(t * k, device=xf.device) - starts[se]
    keep = rank < cap
    return Routing(order=order, token=order // k,
                   gate=gate.reshape(-1)[order],
                   slot_e=torch.where(keep, se, e),
                   slot_c=torch.where(keep, rank, 0), keep=keep, cap=cap)


def _dispatch_block(cfg: ArchConfig, p: dict, xf: torch.Tensor
                    ) -> torch.Tensor:
    """Sort-based dispatch + expert GEMMs for one token block (T, d);
    returns its routed experts' f32 output (T, d).  While tracing is on
    (``repro_torch.tracing``) its four stages are spans, forward and
    backward, and it counts its T*k assignments and the dropped ones."""
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    dt = cdt(cfg)
    with tracing.span("moe.route", xf) as s:
        r = route(cfg, p, s.bwd_end(xf))
        r = r._replace(gate=s.bwd_start(r.gate))
    if tracing.on():
        tracing.count("moe.assignments", t * k)
        tracing.count("moe.dropped", (~r.keep).sum())
    with tracing.span("moe.dispatch", xf) as s:
        buf = xf.new_zeros((e + 1, r.cap, d), dtype=dt)
        # dropped entries all land on row E, which no product reads
        buf[r.slot_e, r.slot_c] = s.bwd_end(xf)[r.token].to(dt)
        buf = s.bwd_start(buf)
    with tracing.span("moe.experts") as s:
        buf = s.bwd_end(buf)
        h = torch.bmm(buf[:e], p["wi"].to(dt))
        g = torch.bmm(buf[:e], p["wg"].to(dt))
        y = torch.bmm(F.silu(h) * g, p["wo"].to(dt))            # (E,C,d)
        y = s.bwd_start(y)
    with tracing.span("moe.combine", xf) as s:
        y = s.bwd_end(y)
        gathered = y[torch.clamp(r.slot_e, max=e - 1), r.slot_c]   # (T*k,d)
        gathered = torch.where(r.keep[:, None], gathered,
                               torch.zeros((), dtype=dt, device=xf.device))
        contrib = gathered.float() * r.gate[:, None]
        # back to (token, k) order, then a fixed-order sum over k
        flat = torch.empty_like(contrib)
        flat[r.order] = contrib
        return s.bwd_start(flat.reshape(t, k, d).sum(1))


def _blocks(cfg: ArchConfig, xf: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Token blocks of ``cfg.moe_block_tokens``; one block where they do
    not divide the tokens (tiny inputs), as the reference falls back."""
    t = xf.shape[0]
    tb = min(cfg.moe_block_tokens, t)
    return xf.split(t if t % tb else tb)


def _on_whole(fn, cfg: ArchConfig, p: dict, x: DTensor) -> DTensor:
    """``fn(cfg, p, x)`` on the whole of a DTensor ``x`` and of ``p``'s
    leaves, the same on every rank; the result is replicated.  The
    dispatch sorts and ranks all tokens of a block at once, and a block
    spans the batch, so its capacity drops are those of the whole batch,
    as in the reference."""
    rep = (Replicate(),) * x.device_mesh.ndim
    p = tree_map(whole, p)
    n = len(tree_leaves((p, x)))
    return local_map(lambda pl, xl: fn(cfg, pl, xl), out_placements=(rep,),
                     in_placements=(rep,) * n, device_mesh=x.device_mesh,
                     redistribute_inputs=True)(p, x)


def _rows_hold_blocks(cfg: ArchConfig, x: DTensor, rows: DTensor) -> bool:
    """Whether every dispatch block of ``x``'s tokens lies within one
    rank's rows of ``rows`` (``x`` split over its batch only): then each
    rank's blocks, and so their capacity drops, are the whole batch's."""
    t = x.shape[0] * x.shape[1]
    tb = min(cfg.moe_block_tokens, t)
    local = rows.to_local().shape[0] * x.shape[1]
    return local < t and t % tb == 0 and local % tb == 0


def _on_rows(cfg: ArchConfig, p: dict, x: DTensor) -> DTensor:
    """``moe_ffn`` of a DTensor ``x`` on each rank's own rows, where the
    dispatch blocks allow it (``_rows_hold_blocks``), with the layer's
    weights whole and their gradients summed over the ranks of the
    split; else on the whole of ``x`` (``_on_whole``)."""
    rows = batch_split(x)
    if not _rows_hold_blocks(cfg, x, rows):
        return _on_whole(moe_ffn, cfg, p, x)
    p = tree_map(whole, p)
    rp, mesh = rows.placements, x.device_mesh
    n = len(tree_leaves(p))
    rep = (Replicate(),) * mesh.ndim
    return local_map(lambda pl, xl: moe_ffn(cfg, pl, xl),
                     out_placements=(rp,), in_placements=(rep,) * n + (rp,),
                     in_grad_placements=(split_grads(rp),) * n + (rp,),
                     device_mesh=mesh, redistribute_inputs=True)(p, rows)


def moe_ffn(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B,S,D) -> the FFN output (B,S,D) in x's dtype.  Tokens are
    dispatched in blocks of ``cfg.moe_block_tokens`` so dispatch state
    stays bounded at any prompt length (GShard-style grouping).  A DTensor
    ``x`` is dispatched on each rank's rows where the blocks fall within
    them, else whole (``_on_rows``)."""
    if isinstance(x, DTensor):
        return _on_rows(cfg, p, x)
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    out = torch.cat([_dispatch_block(cfg, p, blk)
                     for blk in _blocks(cfg, xf)])
    if cfg.n_shared_experts:
        out = out + apply_mlp(cfg, p["shared"], xf).float()
    return out.reshape(b, s, d).to(x.dtype)


def aux_loss(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The Switch load-balancing loss over all tokens of x (B,S,D): E *
    sum(fraction routed * mean probability) * k."""
    if isinstance(x, DTensor):
        return _aux_loss_split(cfg, p, x)
    e, k = cfg.n_experts, cfg.top_k
    probs = _router_probs(p, x.reshape(-1, x.shape[-1]))
    _, eidx = torch.topk(probs, k, dim=-1)
    frac = F.one_hot(eidx, e).float().mean((0, 1))
    return e * torch.sum(frac * probs.mean(0)) * k


def _aux_sums(cfg: ArchConfig, router: torch.Tensor, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(the (E,) counts of x's routed assignments, the (E,) sums of its
    router probabilities) over x's tokens."""
    probs = _router_probs({"router": router}, x.reshape(-1, x.shape[-1]))
    _, eidx = torch.topk(probs, cfg.top_k, dim=-1)
    return F.one_hot(eidx, cfg.n_experts).float().sum((0, 1)), probs.sum(0)


def _aux_loss_split(cfg: ArchConfig, p: dict, x: DTensor) -> torch.Tensor:
    """``aux_loss`` of a DTensor ``x`` from each rank's rows: the counts
    and probability sums over its own tokens, summed across the split,
    then E * sum(counts * sums) / T^2, which is E * sum(fraction routed *
    mean probability) * k."""
    rows = batch_split(x)
    rp, mesh = rows.placements, x.device_mesh
    part = split_grads(rp)
    counts, sums = local_map(
        lambda wl, xl: _aux_sums(cfg, wl, xl), out_placements=(part, part),
        in_placements=((Replicate(),) * mesh.ndim, rp),
        in_grad_placements=(part, rp), device_mesh=mesh,
        redistribute_inputs=True)(whole(p["router"]), rows)
    t = x.shape[0] * x.shape[1]
    return cfg.n_experts * torch.sum(counts * sums) / (t * t)


def kept_assignments(cfg: ArchConfig, p: dict, x: torch.Tensor
                     ) -> torch.Tensor:
    """(B*S, E) bool: the (token, expert) assignments of x that
    ``moe_ffn`` keeps (routed and within capacity)."""
    xf = x.reshape(-1, x.shape[-1])
    out = []
    for blk in _blocks(cfg, xf):
        r = route(cfg, p, blk)
        kept = torch.zeros((blk.shape[0], cfg.n_experts + 1),
                           dtype=torch.bool, device=x.device)
        kept[r.token, r.slot_e] = True
        out.append(kept[:, :-1])
    return torch.cat(out)


# ---------------------------------------------------------------------------
# model = dense transformer with MoE FFN (first_dense leading dense layers)
# ---------------------------------------------------------------------------


def init_layer(cfg: ArchConfig, gen: torch.Generator, moe: bool) -> dict:
    return {
        "ln1": init_norm(cfg, gen.device),
        "attn": dense.init_attn(cfg, gen),
        "ln2": init_norm(cfg, gen.device),
        "ffn": init_moe_ffn(cfg, gen) if moe else init_mlp(cfg, gen),
    }


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Random parameters drawn from ``gen`` on ``gen.device``."""
    n_groups, per = cfg.layer_groups()
    assert per == 1, "moe family scans single layers"
    p = {
        "embed": init_embed(cfg, gen),
        "layers": [init_layer(cfg, gen, moe=True) for _ in range(n_groups)],
        "ln_f": init_norm(cfg, gen.device),
    }
    if cfg.first_dense:
        p["dense_layers"] = [init_layer(cfg, gen, moe=False)
                             for _ in range(cfg.first_dense)]
    return p


def _layers(params: dict) -> list[tuple[dict, bool]]:
    """(layer params, is MoE) in order: the dense layers first."""
    return ([(lp, False) for lp in params.get("dense_layers", [])]
            + [(lp, True) for lp in params["layers"]])


def _attn_residual(cfg: ArchConfig, lp: dict, x: torch.Tensor,
                   o: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x plus the attention output ``o`` through ``wo``, and its ``ln2``
    norm, the FFN's input."""
    x = x + o @ lp["attn"]["wo"].to(x.dtype)
    return x, apply_norm(cfg, lp["ln2"], x)


def _ffn(cfg: ArchConfig, lp: dict, h: torch.Tensor, moe: bool
         ) -> torch.Tensor:
    return moe_ffn(cfg, lp["ffn"], h) if moe else \
        apply_mlp(cfg, lp["ffn"], h)


def _residual_block(cfg: ArchConfig, lp: dict, x: torch.Tensor,
                    h: torch.Tensor, o: torch.Tensor, *, moe: bool
                    ) -> torch.Tensor:
    """A layer's step after attention, as ``transformer._serve_layers``
    takes it (``h``, the ``ln1`` norm, is unused: no parallel block)."""
    x, h = _attn_residual(cfg, lp, x, o)
    return x + _ffn(cfg, lp, h, moe)


def _serve_layers(cfg: ArchConfig, params: dict) -> list[tuple]:
    return [(lp, False, functools.partial(_residual_block, cfg, lp, moe=moe))
            for lp, moe in _layers(params)]


def layer_apply(cfg: ArchConfig, lp: dict, x: torch.Tensor, *, moe: bool,
                rope: tuple | None, attn: str = "kernel"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer over the whole sequence: (x out, its aux loss, 0 for a
    dense layer).  The span ``moe.layer`` (``repro_torch.tracing``) holds
    it, so its recompute under ``cfg.remat``, which the backward runs
    inside a stage's backward span, is no part of that span's self
    time."""
    with tracing.span("moe.layer", x):
        h = apply_norm(cfg, lp["ln1"], x)
        o, _, _ = dense._self_attention(cfg, lp["attn"], h, local=False,
                                        rope=rope, attn=attn)
        x, h = _attn_residual(cfg, lp, x, o)
        aux = aux_loss(cfg, lp["ffn"], h) if moe else \
            torch.zeros((), dtype=torch.float32, device=x.device)
        return x + _ffn(cfg, lp, h, moe), aux


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            attn: str = "kernel") -> tuple[torch.Tensor, torch.Tensor]:
    """(final hidden states (B,S,D), the summed aux loss of the MoE
    layers).  With ``cfg.remat`` and grad mode on, each layer runs under
    ``torch.utils.checkpoint``, as ``transformer.forward`` does."""
    x = embed_tokens(cfg, params["embed"], tokens)
    rope = dense._rope(cfg, torch.arange(x.shape[1], device=x.device))
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, moe in _layers(params):
        if moe:
            x = shard_act(x, dense.SEQ)
        fn = functools.partial(layer_apply, cfg, lp, moe=moe, rope=rope,
                               attn=attn)
        x, a = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
        aux = aux + a
    return apply_norm(cfg, params["ln_f"], x), aux


def loss_fn(cfg: ArchConfig, params: dict, batch: dict,
            attn: str = "kernel") -> torch.Tensor:
    """Next-token cross entropy plus 0.01 * aux / n_layers."""
    h, aux = forward(cfg, params, batch["tokens"], attn=attn)
    logits = logits_from_hidden(cfg, params["embed"], h)
    ce = cross_entropy(logits, batch["targets"], batch.get("weights"))
    return ce + 0.01 * aux / max(cfg.n_layers, 1)


# -- serving ------------------------------------------------------------------

init_cache = dense.init_cache


def prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            cache: dict, attn: str = "kernel") -> tuple[torch.Tensor, dict]:
    """Process the prompt; returns (last-token logits (B,V), the cache),
    whose k/v tensors are filled in place.  Serving skips the aux loss,
    which the reference computes and discards."""
    return dense._prefill(cfg, params, _serve_layers(cfg, params), tokens,
                          cache, attn)


def decode_step(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                cache: dict, attn: str = "kernel"
                ) -> tuple[torch.Tensor, dict]:
    """One token for every sequence.  tokens: (B,) int; the cache's k/v
    tensors are updated in place."""
    return dense._decode_step(cfg, params, _serve_layers(cfg, params),
                              tokens, cache, attn)


__all__ = ["Routing", "aux_loss", "capacity", "decode_step", "forward",
           "init_cache", "init_params", "kept_assignments", "layer_apply",
           "loss_fn", "moe_ffn", "prefill", "route"]
