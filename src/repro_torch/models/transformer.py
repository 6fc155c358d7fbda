"""Dense decoder-only transformer LM.

The counterpart of ``repro/models/transformer.py`` for the dense path
(qwen3: qk-norm, GQA, tied embeddings), also PaliGemma's text decoder
(``embeds`` in place of the token embedding): training (``forward``,
``loss_fn``) and serving (``prefill``, ``decode_step``).  The reference
stacks each layer's parameters by group and scans over groups; here
``params["layers"]`` is a list with one dict per layer and the scan is a
Python loop.  The KV cache is a list with one ``{"k", "v"}`` pair of
(B, Hkv, S, D) tensors per layer, updated in place by ``prefill`` and
``decode_step``.

``attn`` picks the attention path: ``"kernel"`` sends prefill, training and
decode attention through ``repro_torch.kernels.ops`` (the Hopper kernels
on a CUDA tensor, their plain versions on a CPU one; training attention
through the autograd Function over the LSE forward and the backward
kernels), ``"plain"`` through the plain functions of ``models.attention``
under plain autograd.
"""
from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from . import attention as attn_lib
from .common import (apply_mlp, apply_norm, apply_rope, cdt, cross_entropy,
                     dense_init, embed_tokens, init_embed, init_mlp,
                     init_norm, logits_from_hidden, pdt, rms_head_norm,
                     rope_frequencies, shard_act)
from .config import ArchConfig

# the residual stream's activation sharding (``common.shard_act``)
SEQ = ("batch", "seq", None)

# ---------------------------------------------------------------------------
# layer pattern helpers
# ---------------------------------------------------------------------------


def layer_pattern(cfg: ArchConfig) -> list[bool]:
    """Per-position-in-group flag: True = sliding-window (local) layer."""
    local, glob = cfg.local_global
    if local + glob == 0:
        return [cfg.window > 0]  # uniform window (or full) single layer
    return [True] * local + [False] * glob


def layer_is_local(cfg: ArchConfig) -> list[bool]:
    """The ``layer_pattern`` flag of every layer, in order."""
    pattern = layer_pattern(cfg)
    return [pattern[i % len(pattern)] for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_attn(cfg: ArchConfig, gen: torch.Generator) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dtype = pdt(cfg)
    p = {
        "wq": dense_init(gen, (d, hq * hd), dtype),
        "wk": dense_init(gen, (d, hkv * hd), dtype),
        "wv": dense_init(gen, (d, hkv * hd), dtype),
        "wo": dense_init(gen, (hq * hd, d), dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=gen.device)
    return p


def init_layer(cfg: ArchConfig, gen: torch.Generator) -> dict:
    p = {
        "ln1": init_norm(cfg, gen.device),
        "attn": init_attn(cfg, gen),
        "mlp": init_mlp(cfg, gen),
    }
    if not cfg.parallel_block:
        p["ln2"] = init_norm(cfg, gen.device)
    return p


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Random parameters drawn from ``gen`` on ``gen.device``."""
    return {
        "embed": init_embed(cfg, gen),
        "layers": [init_layer(cfg, gen) for _ in range(cfg.n_layers)],
        "ln_f": init_norm(cfg, gen.device),
    }


# ---------------------------------------------------------------------------
# attention projection / core
# ---------------------------------------------------------------------------


def _qkv(cfg: ArchConfig, p: dict, x: torch.Tensor):
    b, s, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, hq, hd).transpose(1, 2)
    k = (x @ p["wk"].to(x.dtype)).reshape(b, s, hkv, hd).transpose(1, 2)
    v = (x @ p["wv"].to(x.dtype)).reshape(b, s, hkv, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"])
        k = rms_head_norm(k, p["k_norm"])
    return q, k, v


def _self_attention(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
                    local: bool, rope: tuple | None, attn: str,
                    causal: bool = True):
    """(attention output before ``wo``, k, v) over the whole sequence;
    ``rope`` is the (sin, cos) of the positions, None without RoPE;
    ``causal=False`` for an encoder's bidirectional attention."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    if rope is not None:
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
    window = cfg.window if local else 0
    o = attn_lib.prefill_attention(q, k, v, causal=causal, window=window,
                                   attn=attn)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
    return o, k, v


def _rope(cfg: ArchConfig, positions: torch.Tensor) -> tuple | None:
    """(sin, cos) shared by every layer (the reference recomputes them per
    layer inside its scan; the values are the same)."""
    return rope_frequencies(cfg, positions) if cfg.rope_frac > 0 else None


def _residual_block(cfg: ArchConfig, lp: dict, x: torch.Tensor,
                    h: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    a = o @ lp["attn"]["wo"].to(x.dtype)
    if cfg.parallel_block:  # command-r: attn + mlp from the same norm
        return x + a + apply_mlp(cfg, lp["mlp"], h)
    x = x + a
    h2 = apply_norm(cfg, lp["ln2"], x)
    return x + apply_mlp(cfg, lp["mlp"], h2)


def layer_apply(cfg: ArchConfig, p: dict, x: torch.Tensor, *, local: bool,
                positions: torch.Tensor, attn: str = "kernel"
                ) -> torch.Tensor:
    h = apply_norm(cfg, p["ln1"], x)
    o, _, _ = _self_attention(cfg, p["attn"], h, local=local,
                              rope=_rope(cfg, positions), attn=attn)
    return _residual_block(cfg, p, x, h, o)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _embed(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
           embeds: torch.Tensor | None) -> torch.Tensor:
    """``embeds`` when given (PaliGemma's image prefix and text), else the
    token embedding."""
    return embeds if embeds is not None else \
        embed_tokens(cfg, params["embed"], tokens)


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            attn: str = "kernel", embeds: torch.Tensor | None = None
            ) -> torch.Tensor:
    """Returns final hidden states (B,S,D).  ``embeds`` (B,S,D) overrides
    the token embedding, positions running over the whole stream.  With
    ``cfg.remat`` and grad mode on, each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant): the backward recomputes its
    activations, as the reference's ``jax.checkpoint`` does per layer
    group."""
    x = _embed(cfg, params, tokens, embeds)
    x = shard_act(x, SEQ)  # boundary: embed -> layers
    positions = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    per = len(layer_pattern(cfg))
    for i, (lp, local) in enumerate(zip(params["layers"],
                                        layer_is_local(cfg))):
        if i % per == 0:  # each layer group, as the reference's scan body
            x = shard_act(x, SEQ)
        fn = functools.partial(layer_apply, cfg, lp, local=local,
                               positions=positions, attn=attn)
        x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    x = shard_act(x, SEQ)  # boundary: layers -> loss
    return apply_norm(cfg, params["ln_f"], x)


def loss_fn(cfg: ArchConfig, params: dict, batch: dict,
            attn: str = "kernel") -> torch.Tensor:
    """Mean next-token cross entropy of ``batch`` (tokens, targets and
    optional weights, (B,S) tensors; optional ``embeds``, as ``forward``
    takes them)."""
    h = forward(cfg, params, batch["tokens"], attn=attn,
                embeds=batch.get("embeds"))
    logits = logits_from_hidden(cfg, params["embed"], h)
    return cross_entropy(logits, batch["targets"], batch.get("weights"))


# ---------------------------------------------------------------------------
# KV cache + serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device: torch.device | str = "cuda") -> dict:
    """Local (window) layers get window-sized rolling caches; global layers
    full ``max_len``."""
    dtype = cdt(cfg)
    hkv, hd = cfg.n_kv_heads, cfg.hd
    caches = []
    for local in layer_is_local(cfg):
        slen = min(cfg.window, max_len) if (local and cfg.window) else max_len
        caches.append({
            "k": torch.zeros((batch, hkv, slen, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, hkv, slen, hd), dtype=dtype,
                             device=device),
        })
    return {"layers": caches,
            "length": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _local_cache(cache_k: DTensor, new: torch.Tensor):
    """(the rank's cache shard, ``new`` (B, Hkv, ...) split as the cache's
    batch and kv heads are and whole along the rest, the global slot of
    the shard's first entry): a cache split over its sequence (kv heads
    fewer than the model axis) holds one run of slots a rank."""
    mesh, cp = cache_k.device_mesh, cache_k.placements
    keep = tuple(p if p in (Shard(0), Shard(1)) else Replicate() for p in cp)
    loc = cache_k.to_local()
    seq = [i for i, p in enumerate(cp) if p == Shard(2)]
    off = mesh.get_local_rank(seq[0]) * loc.shape[2] if seq else 0
    return loc, new.redistribute(mesh, keep[:new.ndim]).to_local(), off


def _cache_write_prefill(cache_k: torch.Tensor, k: torch.Tensor) -> None:
    """Write a full prefill (B,Hkv,S,D) into the cache, in place.  Rolling
    caches (w < s) keep the last w tokens at their canonical slots
    ``t % w`` so decode's rolling writes overwrite the oldest entry.  A
    DTensor cache takes the write in each rank's own shard."""
    w = cache_k.shape[2]
    if isinstance(cache_k, DTensor):
        loc, kl, off = _local_cache(cache_k, k)
        s, sl = k.shape[2], loc.shape[2]
        if s >= w:  # slot j holds token s - w + ((j - s) mod w)
            j = torch.arange(off, off + sl, device=loc.device)
            loc.copy_(kl[:, :, s - w + torch.remainder(j - s, w)])
        elif s > off:  # slots [off, min(off + sl, s)) take those tokens
            hi = min(off + sl, s)
            loc[:, :, :hi - off] = kl[:, :, off:hi].to(loc.dtype)
        return
    s = k.shape[2]
    if s >= w:
        last = k[:, :, s - w:].to(cache_k.dtype)
        cache_k.copy_(torch.roll(last, s % w, dims=2))
    else:
        cache_k[:, :, :s] = k.to(cache_k.dtype)


def _scatter_write(cache_k: torch.Tensor, k_new: torch.Tensor,
                   pos: torch.Tensor) -> None:
    """Write one token per row (B,Hkv,D) at per-row slots ``pos``, in
    place; in each rank's own shard of a DTensor cache."""
    if isinstance(cache_k, DTensor):
        loc, kl, off = _local_cache(cache_k, k_new)
        if isinstance(pos, DTensor):
            pos = pos.redistribute(pos.device_mesh, tuple(
                p if p == Shard(0) else Replicate()
                for p in cache_k.placements)).to_local()
        local = pos.long() - off
        mine = (local >= 0) & (local < loc.shape[2])
        slot = torch.clamp(local, 0, loc.shape[2] - 1)
        bi = torch.arange(loc.shape[0], device=loc.device)[:, None]
        hi = torch.arange(loc.shape[1], device=loc.device)[None, :]
        loc[bi, hi, slot[:, None]] = torch.where(
            mine[:, None, None], kl.to(loc.dtype), loc[bi, hi, slot[:, None]])
        return
    b, hkv = cache_k.shape[:2]
    bi = torch.arange(b, device=cache_k.device)[:, None]
    hi = torch.arange(hkv, device=cache_k.device)[None, :]
    cache_k[bi, hi, pos[:, None].long()] = k_new.to(cache_k.dtype)


def _serve_layers(cfg: ArchConfig, params: dict) -> list[tuple]:
    """(layer params, is local, its step after attention) for each layer:
    ``step(x, h, o)`` takes the residual stream, the ``ln1`` norm and the
    attention output before ``wo`` and returns the layer's output."""
    return [(lp, local, functools.partial(_residual_block, cfg, lp))
            for lp, local in zip(params["layers"], layer_is_local(cfg))]


def prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            cache: dict, attn: str = "kernel",
            embeds: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """Process the prompt; returns (last-token logits (B,V), the cache),
    whose k/v tensors are filled in place.  ``embeds`` as in ``forward``:
    the cache then holds its whole stream."""
    return _prefill(cfg, params, _serve_layers(cfg, params), tokens, cache,
                    attn, embeds)


def _prefill(cfg: ArchConfig, params: dict, layers: list[tuple],
             tokens: torch.Tensor, cache: dict, attn: str,
             embeds: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, dict]:
    """``prefill`` over ``layers`` as ``_serve_layers`` gives them, one
    cache entry each; the MoE family and whisper's decoder pass their
    own."""
    x = _embed(cfg, params, tokens, embeds)
    s = x.shape[1]
    rope = _rope(cfg, torch.arange(s, device=x.device))
    for (lp, local, step), kv in zip(layers, cache["layers"]):
        x = shard_act(x, SEQ)
        h = apply_norm(cfg, lp["ln1"], x)
        o, k, v = _self_attention(cfg, lp["attn"], h, local=local,
                                  rope=rope, attn=attn)
        _cache_write_prefill(kv["k"], k)
        _cache_write_prefill(kv["v"], v)
        x = step(x, h, o)
    h = apply_norm(cfg, params["ln_f"], x[:, -1:])
    logits = logits_from_hidden(cfg, params["embed"], h)[:, 0]
    return logits, {"layers": cache["layers"], "length": cache["length"] + s}


def decode_step(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                cache: dict, attn: str = "kernel"
                ) -> tuple[torch.Tensor, dict]:
    """One token for every sequence.  tokens: (B,) int; the cache's k/v
    tensors are updated in place."""
    return _decode_step(cfg, params, _serve_layers(cfg, params), tokens,
                        cache, attn)


def _decode_step(cfg: ArchConfig, params: dict, layers: list[tuple],
                 tokens: torch.Tensor, cache: dict, attn: str
                 ) -> tuple[torch.Tensor, dict]:
    """``decode_step`` over ``layers`` as ``_serve_layers`` gives them."""
    b = tokens.shape[0]
    x = embed_tokens(cfg, params["embed"], tokens[:, None])  # (B,1,D)
    length = cache["length"]  # (B,)
    rope = _rope(cfg, length[:, None])
    slots = {}  # cache width -> (write slot, valid length), as per layer
    for (lp, _, step), kv in zip(layers, cache["layers"]):
        h = apply_norm(cfg, lp["ln1"], x)
        q, k, v = _qkv(cfg, lp["attn"], h)       # (B,H,1,D)
        if rope is not None:
            q = apply_rope(q, *rope)
            k = apply_rope(k, *rope)
        w = kv["k"].shape[2]
        if w not in slots:
            slots[w] = (length % w, torch.clamp(length + 1, max=w))
        pos, valid = slots[w]
        _scatter_write(kv["k"], k[:, :, 0], pos)
        _scatter_write(kv["v"], v[:, :, 0], pos)
        # as in the reference, a local layer's window is its rolling cache
        o = attn_lib.decode_attention_for(q[:, :, 0], kv["k"], kv["v"],
                                          valid, attn=attn)
        o = o.reshape(b, 1, cfg.n_heads * cfg.hd)
        x = step(x, h, o)
    h = apply_norm(cfg, params["ln_f"], x)
    logits = logits_from_hidden(cfg, params["embed"], h)[:, 0]
    return logits, {"layers": cache["layers"], "length": length + 1}


__all__ = ["decode_step", "forward", "init_cache", "init_params",
           "layer_apply", "layer_is_local", "layer_pattern", "loss_fn",
           "prefill"]
