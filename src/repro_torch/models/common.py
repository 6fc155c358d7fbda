"""Shared building blocks: initializers, norms, RoPE, MLPs, embeddings.

The counterpart of ``repro/models/common.py``: plain functions over
parameter dicts of tensors; ``init_*`` builders draw from an explicit
``torch.Generator`` on an explicit device.  Compute happens in
``cfg.compute_dtype``; normalization statistics and softmax always in f32.
The reference's activation-sharding helpers come with the distribution
slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ArchConfig


def cdt(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def pdt(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


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


def embed_tokens(cfg: ArchConfig, p: dict, tokens: torch.Tensor
                 ) -> torch.Tensor:
    x = p["tokens"].to(cdt(cfg))[tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cdt(cfg))
    return x


def logits_from_hidden(cfg: ArchConfig, p: dict, x: torch.Tensor
                       ) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = p["tokens"].to(cdt(cfg)).T
    else:
        w = p["unembed"].to(cdt(cfg))
    logits = (x @ w).float()
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE over weighted tokens; logits (B,S,V) f32,
    targets (B,S).  The reference picks the target logit with a masked sum
    to keep a vocab-sharded tensor sharded; unsharded, a gather picks the
    same value."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    ll = picked - lse
    if weights is None:
        weights = torch.ones_like(ll)
    return -(ll * weights).sum() / torch.clamp(weights.sum(), min=1.0)


__all__ = ["apply_mlp", "apply_norm", "apply_rope", "cdt", "cross_entropy",
           "dense_init", "embed_init", "embed_tokens", "init_embed",
           "init_mlp", "init_norm", "logits_from_hidden", "pdt",
           "rms_head_norm", "rope_frequencies"]
