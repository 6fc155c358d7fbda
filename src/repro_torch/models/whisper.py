"""Whisper-style encoder-decoder (audio backbone; conv frontend STUB).

The counterpart of ``repro/models/whisper.py``.  The batch brings
precomputed mel-frame embeddings (B, enc_frames, d_model), as there: the
conv frontend is a stub.  Encoder: ``frames + pos_enc``, then pre-norm
blocks of bidirectional self attention (no RoPE).  Decoder: causal self
attention with RoPE (as the reference has it, where the published model
learns its positions), cross attention over the encoder's output, then the
MLP.

Parameters hold one dict per layer in ``enc_layers`` and ``dec_layers``
(the reference stacks each; ``convert`` carries both layouts).  The
serving cache is ``{"self": [{"k", "v"} (B, Hkv, max_len, D)] per decoder
layer, "cross": [{"k", "v"} (B, Hkv, enc_frames, D)] per decoder layer,
"length": (B,)}``; the prefill encodes the audio and fills the cross cache
once, and every tensor is written in place.  The decoder's serving loop is
``models.transformer``'s, with a layer step that adds the cross attention
and the MLP.  ``attn`` picks the path of every attention call (encoder,
decoder self and cross, prefill and decode): the kernels of
``repro_torch.kernels.ops`` (``"kernel"``) or the plain functions of
``models.attention`` (``"plain"``).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn_lib
from . import transformer as dense
from .common import (apply_mlp, apply_norm, cdt, cross_entropy, dense_init,
                     embed_tokens, init_embed, init_mlp, init_norm,
                     logits_from_hidden, pdt, shard_act)
from .config import ArchConfig


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Random parameters drawn from ``gen`` on ``gen.device``."""
    dev = gen.device

    def enc_layer():
        return {"ln1": init_norm(cfg, dev), "attn": dense.init_attn(cfg, gen),
                "ln2": init_norm(cfg, dev), "mlp": init_mlp(cfg, gen)}

    def dec_layer():
        return {"ln1": init_norm(cfg, dev), "attn": dense.init_attn(cfg, gen),
                "lnx": init_norm(cfg, dev),
                "xattn": dense.init_attn(cfg, gen),
                "ln2": init_norm(cfg, dev), "mlp": init_mlp(cfg, gen)}

    return {
        "embed": init_embed(cfg, gen),
        "pos_enc": dense_init(gen, (cfg.enc_frames, cfg.d_model), pdt(cfg)),
        "enc_layers": [enc_layer() for _ in range(cfg.enc_layers)],
        "enc_ln_f": init_norm(cfg, dev),
        "dec_layers": [dec_layer() for _ in range(cfg.n_layers)],
        "ln_f": init_norm(cfg, dev),
    }


def _layers(cfg: ArchConfig, fns: list, x: torch.Tensor) -> torch.Tensor:
    """``x`` through each layer function; with ``cfg.remat`` and grad mode
    on, each under ``torch.utils.checkpoint``, as ``transformer.forward``
    runs its layers."""
    remat = cfg.remat and torch.is_grad_enabled()
    for fn in fns:
        x = shard_act(x, ("batch", "seq", None))
        x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    return x


def _enc_layer(cfg: ArchConfig, lp: dict, x: torch.Tensor, *,
               attn: str) -> torch.Tensor:
    h = apply_norm(cfg, lp["ln1"], x)
    o, _, _ = dense._self_attention(cfg, lp["attn"], h, local=False,
                                    rope=None, attn=attn, causal=False)
    x = x + o @ lp["attn"]["wo"].to(x.dtype)
    h = apply_norm(cfg, lp["ln2"], x)
    return x + apply_mlp(cfg, lp["mlp"], h)


def encode(cfg: ArchConfig, params: dict, frames: torch.Tensor,
           attn: str = "kernel") -> torch.Tensor:
    """frames: (B, enc_frames, d_model) stub embeddings -> encoder
    states."""
    x = frames.to(cdt(cfg)) + params["pos_enc"].to(cdt(cfg))[None]
    x = _layers(cfg, [functools.partial(_enc_layer, cfg, lp, attn=attn)
                      for lp in params["enc_layers"]], x)
    return apply_norm(cfg, params["enc_ln_f"], x)


def _enc_kv(cfg: ArchConfig, lp: dict, enc: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer's cross-attention k, v (B, Hkv, enc_frames, D)."""
    b, se, _ = enc.shape
    hkv, hd = cfg.n_kv_heads, cfg.hd
    k = (enc @ lp["xattn"]["wk"].to(enc.dtype)).reshape(b, se, hkv, hd)
    v = (enc @ lp["xattn"]["wv"].to(enc.dtype)).reshape(b, se, hkv, hd)
    return k.transpose(1, 2), v.transpose(1, 2)


def _cross_attend(cfg: ArchConfig, lp: dict, enc_k: torch.Tensor,
                  enc_v: torch.Tensor, x: torch.Tensor, *, attn: str
                  ) -> torch.Tensor:
    """Cross attention of the decoder stream x (B, S, D) over the encoder's
    k/v, bidirectional, through ``wo``."""
    b, s, _ = x.shape
    hq, hd = cfg.n_heads, cfg.hd
    h = apply_norm(cfg, lp["lnx"], x)
    q = (h @ lp["xattn"]["wq"].to(h.dtype)).reshape(b, s, hq, hd)
    o = attn_lib.prefill_attention(q.transpose(1, 2), enc_k, enc_v,
                                   causal=False, attn=attn)
    o = o.transpose(1, 2).reshape(b, s, hq * hd)
    return o @ lp["xattn"]["wo"].to(h.dtype)


def _cross_decode(cfg: ArchConfig, lp: dict, kv: dict, kv_len: torch.Tensor,
                  x: torch.Tensor, *, attn: str) -> torch.Tensor:
    """Cross attention of one token per row x (B, 1, D) over the static
    cross cache, through the decode path, then ``wo``."""
    b = x.shape[0]
    hq, hd = cfg.n_heads, cfg.hd
    h = apply_norm(cfg, lp["lnx"], x)
    q = (h @ lp["xattn"]["wq"].to(h.dtype)).reshape(b, hq, hd)
    o = attn_lib.decode_attention_for(q, kv["k"], kv["v"], kv_len,
                                      attn=attn)
    return o.reshape(b, 1, hq * hd) @ lp["xattn"]["wo"].to(h.dtype)


def _dec_rest(cfg: ArchConfig, lp: dict, cross, x: torch.Tensor,
              h: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """A decoder layer after its self attention (``o`` before ``wo``; the
    ``ln1`` norm ``h`` is not needed again): ``wo``, ``cross(x)``, the
    MLP.  The step ``transformer._prefill`` and ``_decode_step`` call."""
    x = x + o @ lp["attn"]["wo"].to(x.dtype)
    x = x + cross(x)
    h2 = apply_norm(cfg, lp["ln2"], x)
    return x + apply_mlp(cfg, lp["mlp"], h2)


def _dec_layer(cfg: ArchConfig, lp: dict, enc: torch.Tensor, rope: tuple,
               x: torch.Tensor, *, attn: str) -> torch.Tensor:
    h = apply_norm(cfg, lp["ln1"], x)
    o, _, _ = dense._self_attention(cfg, lp["attn"], h, local=False,
                                    rope=rope, attn=attn)
    cross = functools.partial(_cross_attend, cfg, lp, *_enc_kv(cfg, lp, enc),
                              attn=attn)
    return _dec_rest(cfg, lp, cross, x, h, o)


def decode_train(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                 enc: torch.Tensor, attn: str = "kernel") -> torch.Tensor:
    """The decoder over whole sequences: final hidden states (B, S, D)."""
    x = embed_tokens(cfg, params["embed"], tokens)
    rope = dense._rope(cfg, torch.arange(x.shape[1], device=x.device))
    x = _layers(cfg, [functools.partial(_dec_layer, cfg, lp, enc, rope,
                                        attn=attn)
                      for lp in params["dec_layers"]], x)
    return apply_norm(cfg, params["ln_f"], x)


def loss_fn(cfg: ArchConfig, params: dict, batch: dict,
            attn: str = "kernel") -> torch.Tensor:
    """Mean next-token cross entropy of the decoder on ``batch`` (tokens,
    targets, optional weights and the ``frames`` it listens to)."""
    enc = encode(cfg, params, batch["frames"], attn=attn)
    h = decode_train(cfg, params, batch["tokens"], enc, attn=attn)
    logits = logits_from_hidden(cfg, params["embed"], h)
    return cross_entropy(logits, batch["targets"], batch.get("weights"))


# -- serving -----------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device: torch.device | str = "cuda") -> dict:
    hkv, hd = cfg.n_kv_heads, cfg.hd

    def kv(s):
        return {n: torch.zeros((batch, hkv, s, hd), dtype=cdt(cfg),
                               device=device) for n in ("k", "v")}

    return {"self": [kv(max_len) for _ in range(cfg.n_layers)],
            "cross": [kv(cfg.enc_frames) for _ in range(cfg.n_layers)],
            "length": torch.zeros((batch,), dtype=torch.int32,
                                  device=device)}


def prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            cache: dict, frames: torch.Tensor, attn: str = "kernel"
            ) -> tuple[torch.Tensor, dict]:
    """Encode the audio, fill the cross cache, run the decoder prompt;
    returns (last-token logits (B,V), the cache)."""
    enc = encode(cfg, params, frames, attn=attn)
    layers = []
    for lp, kv in zip(params["dec_layers"], cache["cross"]):
        ek, ev = _enc_kv(cfg, lp, enc)
        kv["k"].copy_(ek)
        kv["v"].copy_(ev)
        cross = functools.partial(_cross_attend, cfg, lp, ek, ev, attn=attn)
        layers.append((lp, False, functools.partial(_dec_rest, cfg, lp,
                                                    cross)))
    logits, c = dense._prefill(cfg, params, layers, tokens,
                               {"layers": cache["self"],
                                "length": cache["length"]}, attn)
    return logits, {"self": cache["self"], "cross": cache["cross"],
                    "length": c["length"]}


def decode_step(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                cache: dict, attn: str = "kernel"
                ) -> tuple[torch.Tensor, dict]:
    """One token for every sequence: self attention against the first
    ``length + 1`` entries of its cache, cross attention against every
    encoder frame (a device tensor of lengths: no host sync)."""
    length = cache["length"]
    cross_len = torch.full_like(length, cfg.enc_frames)
    layers = [(lp, False, functools.partial(
        _dec_rest, cfg, lp, functools.partial(_cross_decode, cfg, lp, kv,
                                              cross_len, attn=attn)))
        for lp, kv in zip(params["dec_layers"], cache["cross"])]
    logits, c = dense._decode_step(cfg, params, layers, tokens,
                                   {"layers": cache["self"],
                                    "length": length}, attn)
    return logits, {"self": cache["self"], "cross": cache["cross"],
                    "length": c["length"]}


__all__ = ["decode_step", "decode_train", "encode", "init_cache",
           "init_params", "loss_fn", "prefill"]
