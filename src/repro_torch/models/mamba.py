"""Pure Mamba2 (SSD) language model: attention-free, O(1)-state decode.

The counterpart of ``repro/models/mamba.py``.  As in ``transformer``,
``params["layers"]`` holds one ``{"ln", "mamba"}`` dict per layer and the
reference's scan over layers is a Python loop; the serving cache holds one
``{"conv", "ssm"}`` dict per layer.  ``attn`` picks the SSD path of the
full-sequence passes (``ssm.ssd``); decode is plain torch on both paths.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from .common import (apply_norm, cross_entropy, embed_tokens, init_embed,
                     init_norm, logits_from_hidden, shard_act)
from .config import ArchConfig
from .ssm import (conv_state, init_mamba_block, init_mamba_cache,
                  mamba_block, mamba_block_decode, mixer)


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Random parameters drawn from ``gen`` on ``gen.device``."""
    return {
        "embed": init_embed(cfg, gen),
        "layers": [{"ln": init_norm(cfg, gen.device),
                    "mamba": init_mamba_block(cfg, gen)}
                   for _ in range(cfg.n_layers)],
        "ln_f": init_norm(cfg, gen.device),
    }


def _layer(cfg: ArchConfig, lp: dict, x: torch.Tensor, attn: str
           ) -> torch.Tensor:
    return x + mamba_block(cfg, lp["mamba"], apply_norm(cfg, lp["ln"], x),
                           attn=attn)


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            attn: str = "kernel") -> torch.Tensor:
    """Final hidden states (B,S,D).  With ``cfg.remat`` and grad mode on,
    each layer runs under ``torch.utils.checkpoint``."""
    x = embed_tokens(cfg, params["embed"], tokens)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params["layers"]:
        x = shard_act(x, ("batch", "seq", None))
        fn = functools.partial(_layer, cfg, lp, attn=attn)
        x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    return apply_norm(cfg, params["ln_f"], x)


def loss_fn(cfg: ArchConfig, params: dict, batch: dict,
            attn: str = "kernel") -> torch.Tensor:
    h = forward(cfg, params, batch["tokens"], attn=attn)
    logits = logits_from_hidden(cfg, params["embed"], h)
    return cross_entropy(logits, batch["targets"], batch.get("weights"))


def init_cache(cfg: ArchConfig, batch: int, max_len: int = 0, *,
               device: torch.device | str = "cuda") -> dict:
    """Per-layer (conv, ssm) states; ``max_len`` is unused (the state is
    O(1) in the sequence)."""
    return {"layers": [init_mamba_cache(cfg, batch, device=device)
                       for _ in range(cfg.n_layers)],
            "length": torch.zeros((batch,), dtype=torch.int32,
                                  device=device)}


def prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor, cache: dict,
            attn: str = "kernel") -> tuple[torch.Tensor, dict]:
    """Run the prompt through the chunked SSD, keeping each layer's final
    (conv, ssm) states for decode.  The conv and ``out_proj`` run in the
    compute dtype, as the reference's ``mamba.prefill`` runs them."""
    x = embed_tokens(cfg, params["embed"], tokens)
    states = []
    for lp in params["layers"]:
        h = apply_norm(cfg, lp["ln"], x)
        p = lp["mamba"]
        y, xbc, st = mixer(cfg, p, h, conv_dtype=h.dtype, attn=attn)
        x = x + (y @ p["out_proj"].to(y.dtype)).to(x.dtype)
        states.append({"conv": conv_state(cfg, xbc), "ssm": st})
    h = apply_norm(cfg, params["ln_f"], x[:, -1:])
    logits = logits_from_hidden(cfg, params["embed"], h)[:, 0]
    return logits, {"layers": states,
                    "length": cache["length"] + tokens.shape[1]}


def decode_step(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """One token for every sequence.  tokens: (B,) int."""
    x = embed_tokens(cfg, params["embed"], tokens[:, None])[:, 0]
    states = []
    for lp, st in zip(params["layers"], cache["layers"]):
        h = apply_norm(cfg, lp["ln"], x[:, None])[:, 0]
        out, st2 = mamba_block_decode(cfg, lp["mamba"], h, st)
        x = x + out
        states.append(st2)
    h = apply_norm(cfg, params["ln_f"], x[:, None])
    logits = logits_from_hidden(cfg, params["embed"], h)[:, 0]
    return logits, {"layers": states, "length": cache["length"] + 1}


__all__ = ["decode_step", "forward", "init_cache", "init_params", "loss_fn",
           "prefill"]
