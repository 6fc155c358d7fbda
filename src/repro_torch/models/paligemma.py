"""PaliGemma-style VLM: SigLIP frontend STUB + projector + gemma decoder.

The counterpart of ``repro/models/paligemma.py``.  The modality frontend
is a stub, as there: the batch brings precomputed patch embeddings
(B, vis_tokens, vis_dim).  The model owns the linear projector
(vis_dim -> d_model) and the MQA (kv=1) gemma decoder of
``models.transformer``.  Image tokens form a prefix, projected with no
embed scale; text tokens follow, with gemma's.  Masking is causal over the
whole stream, as in the reference (which notes prefix-LM masking as its
deviation from the published model), so the serving cache holds
``vis_tokens + prompt`` entries after the prefill.
"""
from __future__ import annotations

import torch

from . import transformer as dense
from .common import (cdt, cross_entropy, dense_init, embed_tokens,
                     logits_from_hidden, pdt)
from .config import ArchConfig


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """The decoder's parameters plus ``projector`` (vis_dim, d_model)."""
    p = dense.init_params(cfg, gen)
    p["projector"] = dense_init(gen, (cfg.vis_dim, cfg.d_model), pdt(cfg))
    return p


def _embed_multimodal(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                      patches: torch.Tensor) -> torch.Tensor:
    """[image prefix | text] embedding stream."""
    img = patches.to(cdt(cfg)) @ params["projector"].to(cdt(cfg))
    txt = embed_tokens(cfg, params["embed"], tokens)
    return torch.cat([img, txt], dim=1)


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            patches: torch.Tensor, attn: str = "kernel") -> torch.Tensor:
    """Final hidden states of the whole stream (B, vis_tokens + S, D)."""
    embeds = _embed_multimodal(cfg, params, tokens, patches)
    return dense.forward(cfg, params, tokens, attn=attn, embeds=embeds)


def loss_fn(cfg: ArchConfig, params: dict, batch: dict,
            attn: str = "kernel") -> torch.Tensor:
    """CE on the text positions only (image prefix carries no targets)."""
    h = forward(cfg, params, batch["tokens"], batch["patches"], attn=attn)
    h_txt = h[:, batch["patches"].shape[1]:]
    logits = logits_from_hidden(cfg, params["embed"], h_txt)
    return cross_entropy(logits, batch["targets"], batch.get("weights"))


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device: torch.device | str = "cuda") -> dict:
    return dense.init_cache(cfg, batch, max_len, device=device)


def prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            cache: dict, patches: torch.Tensor, attn: str = "kernel"
            ) -> tuple[torch.Tensor, dict]:
    embeds = _embed_multimodal(cfg, params, tokens, patches)
    return dense.prefill(cfg, params, tokens, cache, attn=attn,
                         embeds=embeds)


def decode_step(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                cache: dict, attn: str = "kernel"
                ) -> tuple[torch.Tensor, dict]:
    return dense.decode_step(cfg, params, tokens, cache, attn=attn)


__all__ = ["decode_step", "forward", "init_cache", "init_params", "loss_fn",
           "prefill"]
