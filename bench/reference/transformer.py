"""The plain reference of a decoder-only transformer with a dense or a
mixture-of-experts FFN, from the keys of a configuration file.

A layer is ``x + attn(norm1(x))`` then ``+ ffn(norm2(x))``, or, where
``parallel_block`` is set, ``x + attn(n) + ffn(n)`` with ``n = norm1(x)``
and no second norm.  The FFN is a
SwiGLU MLP, or (``family`` "moe") a router in f32 whose softmax picks
``top_k`` of ``n_experts`` SwiGLU experts, its top-k weights renormalised
to sum to one; an expert takes at most ``capacity`` tokens of a block of
``moe_block_tokens``, the first in token order, and drops the rest (GShard).
The loss adds ``router_aux_coef / n_layers`` times each MoE layer's
load-balancing term ``E * k * sum_e(share of assignments_e * mean
probability_e)``.  The parameter tree's layout (``layout``) is what the
benchmark makes from its seed and hands to the program and to this
reference alike.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import (F32, Precision, cross_entropy, derived, norm,
                     self_attention, swiglu, tree_map)

# ---------------------------------------------------------------------------
# the parameter tree
# ---------------------------------------------------------------------------


def _norm_leaves(cfg: dict, prefix: tuple) -> list:
    d, dt = cfg["d_model"], cfg["param_dtype"]
    out = [(prefix + ("scale",), (d,), dt, ("ones",))]
    if cfg["norm"] == "layernorm":
        out.append((prefix + ("bias",), (d,), dt, ("zeros",)))
    return out


def _normal(fan_in: int) -> tuple:
    return ("normal", 1.0 / math.sqrt(fan_in))


# keys of a configuration that this reference does not implement, with
# the value that leaves them out
_UNSUPPORTED = {"window": 0, "tie_embeddings": False,
                "embed_scale": False, "logit_softcap": 0.0, "first_dense": 0,
                "n_shared_experts": 0, "mlp": "swiglu",
                "local_global": [0, 0]}


def check(cfg: dict) -> None:
    """Refuse a configuration that asks for what this reference leaves
    out."""
    for key, plain in _UNSUPPORTED.items():
        if cfg.get(key, plain) != plain:
            raise ValueError(f"the reference has no {key}={cfg[key]!r}")


def layout(cfg: dict) -> list:
    """(path, shape, dtype name, init) of every leaf; init is ("normal",
    std), ("ones",) or ("zeros",)."""
    check(cfg)
    cfg = derived(cfg)
    d, dt = cfg["d_model"], cfg["param_dtype"]
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["hd"]
    out = [(("embed", "tokens"), (cfg["vocab"], d), dt, ("normal", 1.0)),
           (("embed", "unembed"), (d, cfg["vocab"]), dt, _normal(d))]
    out += _norm_leaves(cfg, ("ln_f",))
    moe = cfg["family"] == "moe"
    for i in range(cfg["n_layers"]):
        pre = ("layers", i)
        out += _norm_leaves(cfg, pre + ("ln1",))
        if not cfg.get("parallel_block", False):
            out += _norm_leaves(cfg, pre + ("ln2",))
        a = pre + ("attn",)
        out += [(a + ("wq",), (d, hq * hd), dt, _normal(d)),
                (a + ("wk",), (d, hkv * hd), dt, _normal(d)),
                (a + ("wv",), (d, hkv * hd), dt, _normal(d)),
                (a + ("wo",), (hq * hd, d), dt, _normal(hq * hd))]
        if cfg["qk_norm"]:
            out += [(a + ("q_norm",), (hd,), dt, ("ones",)),
                    (a + ("k_norm",), (hd,), dt, ("ones",))]
        if moe:
            f, e = pre + ("ffn",), cfg["n_experts"]
            ff = cfg["moe_d_ff"]
            out += [(f + ("router",), (d, e), "float32", _normal(d)),
                    (f + ("wi",), (e, d, ff), dt, _normal(d)),
                    (f + ("wg",), (e, d, ff), dt, _normal(d)),
                    (f + ("wo",), (e, ff, d), dt, _normal(ff))]
        else:
            m, ff = pre + ("mlp",), cfg["d_ff"]
            out += [(m + ("wi",), (d, ff), dt, _normal(d)),
                    (m + ("wg",), (d, ff), dt, _normal(d)),
                    (m + ("wo",), (ff, d), dt, _normal(ff))]
    return out


# ---------------------------------------------------------------------------
# the mixture-of-experts FFN
# ---------------------------------------------------------------------------


def capacity(cfg: dict, tokens: int) -> int:
    """Slots an expert has in a block: the capacity factor's share of the
    block's assignments, rounded up to a multiple of 8, at least 8."""
    cap = int(cfg["capacity_factor"] * tokens * cfg["top_k"]
              / cfg["n_experts"])
    return max(8, -(-cap // 8) * 8)


def _moe_block(cfg: dict, p: dict, x: torch.Tensor, prec: Precision
               ) -> torch.Tensor:
    """The routed experts' output for one block of tokens (T, d)."""
    e, k = cfg["n_experts"], cfg["top_k"]
    probs = torch.softmax(x @ p["router"].float(), -1)
    gate, idx = torch.topk(probs, k, -1)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    cap = capacity(cfg, x.shape[0])
    out = torch.zeros_like(x)
    for ex in range(e):
        tok, slot = (idx == ex).nonzero(as_tuple=True)  # in token order
        tok, slot = tok[:cap], slot[:cap]
        if tok.numel() == 0:
            continue
        w = {n: p[n][ex] for n in ("wi", "wg", "wo")}
        y = swiglu(w, x[tok], prec)
        out = out.index_add(0, tok, gate[tok, slot][:, None] * y)
    return out


def moe_ffn(cfg: dict, p: dict, h: torch.Tensor, prec: Precision
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(the FFN's output (B, S, d), the layer's load-balancing term)."""
    b, s, d = h.shape
    x = h.reshape(b * s, d)
    t = x.shape[0]
    tb = min(cfg["moe_block_tokens"], t)
    blocks = x.split(t if t % tb else tb)
    out = torch.cat([_moe_block(cfg, p, blk, prec) for blk in blocks])
    # the load-balancing term reads every token at once
    probs = torch.softmax(x @ p["router"].float(), -1)
    idx = torch.topk(probs, cfg["top_k"], -1).indices
    share = F.one_hot(idx, cfg["n_experts"]).to(F32).mean((0, 1))
    aux = cfg["n_experts"] * torch.sum(share * probs.mean(0)) * cfg["top_k"]
    return out.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def layer(cfg: dict, lp: dict, x: torch.Tensor, prec: Precision,
          heads_a_chunk: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(one layer's output, its load-balancing term, 0 where dense)."""
    h = norm(cfg, lp["ln1"], x)
    x = x + self_attention(cfg, lp["attn"], h, prec, heads_a_chunk)
    if not cfg.get("parallel_block", False):
        h = norm(cfg, lp["ln2"], x)
    if cfg["family"] == "moe":
        y, aux = moe_ffn(cfg, lp["ffn"], h, prec)
    else:
        y, aux = swiglu(lp["mlp"], h, prec), x.new_zeros(())
    return x + y, aux


def loss(cfg: dict, params: dict, tokens: torch.Tensor,
         targets: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Mean next-token cross entropy plus the weighted load-balancing
    terms; each layer recomputed in the backward, so the activations of
    one layer at a time are held."""
    cfg = derived(cfg)
    x = params["embed"]["tokens"][tokens].to(F32)
    aux = x.new_zeros(())
    for lp in params["layers"]:
        x, a = checkpoint(lambda x_, lp_=lp: layer(cfg, lp_, x_, prec), x,
                          use_reentrant=False)
        aux = aux + a
    h = norm(cfg, params["ln_f"], x)
    logits = prec.head_mm(h, params["embed"]["unembed"].float())
    ce = cross_entropy(logits, targets)
    if cfg["family"] != "moe":
        return ce
    return ce + cfg["router_aux_coef"] * aux / cfg["n_layers"]


# a serving forward runs one sequence, and 8 heads' (S, S) scores, at a time
HEADS_A_CHUNK = 8


@torch.no_grad()
def logits_at(cfg: dict, params: dict, tokens: torch.Tensor,
              first: int, prec: Precision) -> torch.Tensor:
    """The f32 logits (N, S - first, V) of positions ``first`` .. S - 1 of
    each of the N sequences ``tokens`` (N, S): a full causal forward, a
    layer at a time over every sequence, each layer's weights upcast to
    f32 once."""
    cfg = derived(cfg)
    x = params["embed"]["tokens"][tokens].to(F32)
    for lp in params["layers"]:
        lp32 = tree_map(lambda t: t.to(F32), lp)
        x = torch.cat([layer(cfg, lp32, x[i:i + 1], prec, HEADS_A_CHUNK)[0]
                       for i in range(x.shape[0])])
        del lp32
    h = norm(cfg, params["ln_f"], x[:, first:])
    return prec.head_mm(h, params["embed"]["unembed"].to(F32))

