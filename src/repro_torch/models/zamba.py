"""Zamba2 hybrid: a Mamba2 backbone with one *shared* transformer block.

The counterpart of ``repro/models/zamba.py``.  Before every
``shared_attn_every`` mamba blocks, one shared attention+MLP block runs on
``concat(hidden, embed0)`` (width 2 d_model) with its own RMS norm.  Its
weights are one copy reused at every use; each use adds its own low-rank
(LoRA) adapter on q and on the MLP's ``wi``.  Its output projects back to
d_model and adds to the residual stream.  As in the reference, the block
has no RoPE: ``positions`` is passed and unused.

Layout: ``params["layers"]`` holds one ``{"ln", "mamba"}`` dict per mamba
layer (layer ``g * per + j`` is mamba ``j`` of group ``g``, run after group
``g``'s shared block), ``params["loras"]`` one LoRA dict per group, and
``params["shared"]`` the shared block.  The cache holds one ``{"conv",
"ssm"}`` dict per mamba layer and one ``{"k", "v"}`` pair of (B, H, S, hd)
tensors per group, the latter updated in place.  ``attn`` picks the path of
the SSD and of the shared block's attention, prefill and decode.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import attention as attn_lib
from .common import (apply_norm, cdt, cross_entropy, dense_init,
                     embed_tokens, init_embed, init_norm, logits_from_hidden,
                     pdt, shard_act)
from .config import ArchConfig
from .ssm import (conv_state, init_mamba_block, init_mamba_cache,
                  mamba_block, mamba_block_decode, mixer)
from .transformer import _cache_write_prefill, _scatter_write


# ---------------------------------------------------------------------------
# shared attention block (width 2*d_model) + per-use LoRA
# ---------------------------------------------------------------------------


def _shared_dims(cfg: ArchConfig) -> tuple[int, int, int]:
    da = 2 * cfg.d_model                 # concat width
    hd = da // cfg.n_heads
    return da, hd, cfg.d_ff


def init_shared_block(cfg: ArchConfig, gen: torch.Generator) -> dict:
    da, hd, ff = _shared_dims(cfg)
    dtype = pdt(cfg)
    return {
        "ln": {"scale": torch.ones((da,), dtype=dtype, device=gen.device)},
        "wq": dense_init(gen, (da, cfg.n_heads * hd), dtype),
        "wk": dense_init(gen, (da, cfg.n_kv_heads * hd), dtype),
        "wv": dense_init(gen, (da, cfg.n_kv_heads * hd), dtype),
        "wo": dense_init(gen, (cfg.n_heads * hd, cfg.d_model), dtype),
        "wi": dense_init(gen, (da, ff), dtype),
        "wg": dense_init(gen, (da, ff), dtype),
        "wo_mlp": dense_init(gen, (ff, cfg.d_model), dtype),
    }


def init_lora(cfg: ArchConfig, gen: torch.Generator) -> dict:
    da, hd, ff = _shared_dims(cfg)
    r = cfg.lora_rank
    dtype = pdt(cfg)
    return {
        "qa": dense_init(gen, (da, r), dtype),
        "qb": torch.zeros((r, cfg.n_heads * hd), dtype=dtype,
                          device=gen.device),
        "ia": dense_init(gen, (da, r), dtype),
        "ib": torch.zeros((r, ff), dtype=dtype, device=gen.device),
    }


def _rms(x: torch.Tensor, scale: torch.Tensor,
         eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
            * scale.float()).to(x.dtype)


def _shared_input(sp: dict, x: torch.Tensor,
                  embed0: torch.Tensor) -> torch.Tensor:
    return _rms(torch.cat([x, embed0], -1), sp["ln"]["scale"])


def shared_block_qkv(cfg: ArchConfig, sp: dict, lora: dict,
                     h: torch.Tensor):
    """h: (B,S,2D) -> q, k, v heads (B,H,S,hd)."""
    b, s, _ = h.shape
    _, hd, _ = _shared_dims(cfg)
    q = h @ sp["wq"].to(h.dtype) + \
        (h @ lora["qa"].to(h.dtype)) @ lora["qb"].to(h.dtype)
    k = h @ sp["wk"].to(h.dtype)
    v = h @ sp["wv"].to(h.dtype)
    q = q.reshape(b, s, cfg.n_heads, hd).transpose(1, 2)
    k = k.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    v = v.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    return q, k, v


def _shared_out(cfg: ArchConfig, sp: dict, lora: dict, h: torch.Tensor,
                o: torch.Tensor) -> torch.Tensor:
    """The block's residual update from its normed input h and the
    attention output o (B,H,S,hd): wo, plus the LoRA'd SwiGLU MLP."""
    b, _, s, hd = o.shape
    a = o.transpose(1, 2).reshape(b, s, cfg.n_heads * hd) @ \
        sp["wo"].to(h.dtype)
    mi = h @ sp["wi"].to(h.dtype) + \
        (h @ lora["ia"].to(h.dtype)) @ lora["ib"].to(h.dtype)
    m = (F.silu(mi) * (h @ sp["wg"].to(h.dtype))) @ sp["wo_mlp"].to(h.dtype)
    return a + m


def shared_block(cfg: ArchConfig, sp: dict, lora: dict, x: torch.Tensor,
                 embed0: torch.Tensor, positions: torch.Tensor,
                 attn: str = "kernel") -> torch.Tensor:
    """Full-sequence shared block; returns the d_model residual update."""
    h = _shared_input(sp, x, embed0)
    q, k, v = shared_block_qkv(cfg, sp, lora, h)
    o = attn_lib.prefill_attention(q, k, v, attn=attn)
    return _shared_out(cfg, sp, lora, h, o)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Random parameters drawn from ``gen`` on ``gen.device``."""
    n_groups, _ = cfg.layer_groups()
    return {
        "embed": init_embed(cfg, gen),
        "layers": [{"ln": init_norm(cfg, gen.device),
                    "mamba": init_mamba_block(cfg, gen)}
                   for _ in range(cfg.n_layers)],
        "loras": [init_lora(cfg, gen) for _ in range(n_groups)],
        "shared": init_shared_block(cfg, gen),
        "ln_f": init_norm(cfg, gen.device),
    }


def _group(cfg: ArchConfig, params: dict, g: int, x: torch.Tensor,
           embed0: torch.Tensor, positions: torch.Tensor,
           attn: str) -> torch.Tensor:
    """Group ``g``: the shared block with its LoRA, then its mambas."""
    _, per = cfg.layer_groups()
    x = x + shared_block(cfg, params["shared"], params["loras"][g], x,
                         embed0, positions, attn=attn)
    for lp in params["layers"][g * per:(g + 1) * per]:
        x = x + mamba_block(cfg, lp["mamba"], apply_norm(cfg, lp["ln"], x),
                            attn=attn)
    return x


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            attn: str = "kernel") -> torch.Tensor:
    """Final hidden states (B,S,D).  With ``cfg.remat`` and grad mode on,
    each group runs under ``torch.utils.checkpoint``, as the reference
    checkpoints its group body."""
    x = embed_tokens(cfg, params["embed"], tokens)
    embed0 = x
    positions = torch.arange(tokens.shape[1], device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for g in range(len(params["loras"])):
        x = shard_act(x, ("batch", "seq", None))
        fn = functools.partial(_group, cfg, params, g, embed0=embed0,
                               positions=positions, attn=attn)
        x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    return apply_norm(cfg, params["ln_f"], x)


def loss_fn(cfg: ArchConfig, params: dict, batch: dict,
            attn: str = "kernel") -> torch.Tensor:
    h = forward(cfg, params, batch["tokens"], attn=attn)
    logits = logits_from_hidden(cfg, params["embed"], h)
    return cross_entropy(logits, batch["targets"], batch.get("weights"))


# -- serving -----------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device: torch.device | str = "cuda") -> dict:
    n_groups, _ = cfg.layer_groups()
    _, hd, _ = _shared_dims(cfg)
    shape = (batch, cfg.n_kv_heads, max_len, hd)
    return {
        "mamba": [init_mamba_cache(cfg, batch, device=device)
                  for _ in range(cfg.n_layers)],
        "attn": [{"k": torch.zeros(shape, dtype=cdt(cfg), device=device),
                  "v": torch.zeros(shape, dtype=cdt(cfg), device=device)}
                 for _ in range(n_groups)],
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _shared_prefill(cfg, sp, lora, x, embed0, positions, kv, attn):
    """The shared block over the prompt; writes its k, v into ``kv`` in
    place."""
    h = _shared_input(sp, x, embed0)
    q, k, v = shared_block_qkv(cfg, sp, lora, h)
    o = attn_lib.prefill_attention(q, k, v, attn=attn)
    _cache_write_prefill(kv["k"], k)
    _cache_write_prefill(kv["v"], v)
    return _shared_out(cfg, sp, lora, h, o)


def _mamba_prefill_states(cfg: ArchConfig, p: dict, h: torch.Tensor,
                          attn: str = "kernel"):
    """mamba_block plus its final (conv, ssm) states.  Unlike
    ``mamba.prefill``, the conv and ``out_proj`` run in f32, as the
    reference's ``_mamba_prefill_states`` runs them."""
    y, xbc, st = mixer(cfg, p, h, conv_dtype=torch.float32, attn=attn)
    out = (y.float() @ p["out_proj"].float()).to(h.dtype)
    return out, {"conv": conv_state(cfg, xbc), "ssm": st}


def prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor, cache: dict,
            attn: str = "kernel") -> tuple[torch.Tensor, dict]:
    x = embed_tokens(cfg, params["embed"], tokens)
    embed0 = x
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    _, per = cfg.layer_groups()
    mstates = []
    for g, (lora, kv) in enumerate(zip(params["loras"], cache["attn"])):
        x = x + _shared_prefill(cfg, params["shared"], lora, x, embed0,
                                positions, kv, attn)
        for lp in params["layers"][g * per:(g + 1) * per]:
            y, st = _mamba_prefill_states(cfg, lp["mamba"],
                                          apply_norm(cfg, lp["ln"], x), attn)
            x = x + y
            mstates.append(st)
    h = apply_norm(cfg, params["ln_f"], x[:, -1:])
    logits = logits_from_hidden(cfg, params["embed"], h)[:, 0]
    return logits, {"mamba": mstates, "attn": cache["attn"],
                    "length": cache["length"] + s}


def decode_step(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                cache: dict, attn: str = "kernel"
                ) -> tuple[torch.Tensor, dict]:
    """One token for every sequence.  tokens: (B,) int; the shared block's
    k/v caches are updated in place."""
    x = embed_tokens(cfg, params["embed"], tokens[:, None])   # (B,1,D)
    embed0 = x
    length = cache["length"]
    b = tokens.shape[0]
    _, per = cfg.layer_groups()
    sp = params["shared"]
    mstates = []
    for g, (lora, kv) in enumerate(zip(params["loras"], cache["attn"])):
        h = _shared_input(sp, x, embed0)
        q, k, v = shared_block_qkv(cfg, sp, lora, h)       # (B,H,1,hd)
        pos = length % kv["k"].shape[2]
        _scatter_write(kv["k"], k[:, :, 0], pos)
        _scatter_write(kv["v"], v[:, :, 0], pos)
        o = attn_lib.decode_attention_for(q[:, :, 0], kv["k"], kv["v"],
                                          length + 1, attn=attn)
        x = x + _shared_out(cfg, sp, lora, h, o.reshape(b, -1, 1,
                                                        o.shape[-1]))
        for i in range(g * per, (g + 1) * per):
            lp = params["layers"][i]
            hn = apply_norm(cfg, lp["ln"], x)[:, 0]
            y, st = mamba_block_decode(cfg, lp["mamba"], hn,
                                       cache["mamba"][i])
            x = x + y[:, None]
            mstates.append(st)
    h = apply_norm(cfg, params["ln_f"], x)
    logits = logits_from_hidden(cfg, params["embed"], h)[:, 0]
    return logits, {"mamba": mstates, "attn": cache["attn"],
                    "length": length + 1}


__all__ = ["decode_step", "forward", "init_cache", "init_lora",
           "init_params", "init_shared_block", "loss_fn", "prefill",
           "shared_block", "shared_block_qkv"]
