"""Model zoo: the PyTorch counterparts of ``repro.models``.

``get_model(cfg)`` returns the uniform ``Model`` API the server uses:

* ``init_params(seed)``                     -> parameter dict
* ``loss_fn(params, batch)``                -> scalar loss (train step core)
* ``init_cache(batch, max_len)``            -> serving cache
* ``prefill(params, batch, cache)``         -> (last logits (B,V), cache)
* ``decode_step(params, tokens, cache)``    -> (logits (B,V), cache)

It holds the ``dense`` family (qwen3, stablelm, gemma3, command-r), the
``moe`` one (deepseek-moe, olmoe), the ``ssm`` one (mamba2) and the
``hybrid`` one (zamba2); ``get_model`` raises for ``audio`` and ``vlm``,
and ``extra_inputs`` comes with the encoder-decoder and VLM families.
Everything runs on ``device`` (``cuda`` unless the caller asks for
``cpu``); ``loss_fn`` takes a batch of numpy arrays or tensors and moves it
there.  ``attn`` picks the path of every kernel of the model: the kernel
path (``"kernel"``) or plain PyTorch (``"plain"``), for attention
(``models.attention``) and the SSD (``models.ssm.ssd``) alike.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from . import (attention, common, config, mamba, moe, ssm, transformer,
               zamba)
from .config import ArchConfig


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    init_params: Callable[[int], dict]
    loss_fn: Callable[[dict, dict], torch.Tensor]
    init_cache: Callable[[int, int], dict]
    prefill: Callable[[dict, dict, dict], tuple]
    decode_step: Callable[[dict, Any, dict], tuple]


def get_model(cfg: ArchConfig, *, device: str | torch.device = "cuda",
              attn: str = "kernel") -> Model:
    device = torch.device(device)
    try:
        mod = _FAMILIES[cfg.family]
    except KeyError:
        raise KeyError(f"model family {cfg.family!r} is not ported yet") \
            from None

    def init_params(seed: int) -> dict:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return mod.init_params(cfg, gen)

    def on_device(batch: dict) -> dict:
        return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}

    # mamba2's decode is plain torch on both paths: it takes no ``attn``
    decode_kw = {} if mod is mamba else {"attn": attn}
    return Model(
        cfg,
        device,
        init_params=init_params,
        loss_fn=lambda p, b: mod.loss_fn(cfg, p, on_device(b), attn=attn),
        init_cache=lambda bs, ml: mod.init_cache(cfg, bs, ml, device=device),
        prefill=lambda p, b, c: mod.prefill(cfg, p, b["tokens"], c,
                                            attn=attn),
        decode_step=lambda p, t, c: mod.decode_step(cfg, p, t, c,
                                                    **decode_kw),
    )


_FAMILIES = {"dense": transformer, "moe": moe, "ssm": mamba,
             "hybrid": zamba}

__all__ = ["ArchConfig", "Model", "attention", "common", "config",
           "get_model", "mamba", "moe", "ssm", "transformer", "zamba"]
