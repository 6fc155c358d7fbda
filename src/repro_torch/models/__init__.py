"""Model zoo: the PyTorch counterparts of ``repro.models``.

``get_model(cfg)`` returns the uniform ``Model`` API the server uses:

* ``init_params(seed)``                     -> parameter dict
* ``loss_fn(params, batch)``                -> scalar loss (train step core)
* ``init_cache(batch, max_len)``            -> serving cache
* ``prefill(params, batch, cache)``         -> (last logits (B,V), cache)
* ``decode_step(params, tokens, cache)``    -> (logits (B,V), cache)
* ``extra_inputs``                          -> stub-frontend input specs

It holds every family of the reference: ``dense`` (qwen3, stablelm,
gemma3, command-r), ``moe`` (deepseek-moe, olmoe), ``ssm`` (mamba2),
``hybrid`` (zamba2), ``audio`` (whisper) and ``vlm`` (paligemma).  The
last two take a stub frontend's output beside the tokens, as the
reference's do: ``extra_inputs`` names it, ``name -> (shape_fn(batch,
seq), dtype)`` (whisper's ``frames``, paligemma's ``patches``), and
``prefill`` reads it from the batch.  Everything runs on ``device``
(``cuda`` unless the caller asks for ``cpu``); ``loss_fn`` takes a batch
of numpy arrays or tensors and moves it there, the extras in their spec's
dtype.  ``attn`` picks the path of
every kernel of the model: the kernel path (``"kernel"``) or plain
PyTorch (``"plain"``), for attention (``models.attention``) and the SSD
(``models.ssm.ssd``) alike.

Params and batches may also be DTensors (the sharded train step, the
dry-run): each weight is then gathered whole where the model reads it,
inside its layer's function (``common.at_use``, ZeRO-3's gather: a rank
holds the weights of the layer it runs whole, the rest at their split),
the batch keeps its split, and plain tensors made on the way (masks,
positions) count as replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from . import (attention, common, config, mamba, moe, paligemma, ssm,
               transformer, whisper, zamba)
from .config import ArchConfig
from ..tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    init_params: Callable[[int], dict]
    loss_fn: Callable[[dict, dict], torch.Tensor]
    init_cache: Callable[[int, int], dict]
    prefill: Callable[[dict, dict, dict], tuple]
    decode_step: Callable[[dict, Any, dict], tuple]
    # stub-frontend extra batch inputs: name -> (shape_fn(batch, seq), dtype)
    extra_inputs: dict


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

    # mamba2's decode is plain torch on both paths: it takes no ``attn``
    decode_kw = {} if mod is mamba else {"attn": attn}
    extra_inputs = _extra_inputs(cfg)

    def on_device(batch: dict) -> dict:
        """The batch on ``device``; the stub frontend's extras in their
        spec's dtype (the data pipeline draws them in f32)."""
        def one(k, v):
            dtype = extra_inputs[k][1] if k in extra_inputs else None
            if isinstance(v, DTensor):
                return v.to(dtype) if dtype is not None else v
            return torch.as_tensor(v, device=device, dtype=dtype)
        return {k: one(k, v) for k, v in batch.items()}

    def sharded(fn):
        """``fn(params, ...)`` with a DTensor param tree gathered at use
        and plain tensors replicated; plain params as they are."""
        def call(params, *rest):
            if not any(isinstance(t, DTensor) for t in tree_leaves(params)):
                return fn(params, *rest)
            with common.replicating():
                return fn(common.at_use(params), *rest)
        return call

    return Model(
        cfg,
        device,
        init_params=init_params,
        loss_fn=sharded(lambda p, b: mod.loss_fn(cfg, p, on_device(b),
                                                 attn=attn)),
        init_cache=lambda bs, ml: mod.init_cache(cfg, bs, ml, device=device),
        prefill=sharded(lambda p, b, c: mod.prefill(
            cfg, p, b["tokens"], c, *(b[n] for n in extra_inputs),
            attn=attn)),
        decode_step=sharded(lambda p, t, c: mod.decode_step(cfg, p, t, c,
                                                            **decode_kw)),
        extra_inputs=extra_inputs,
    )


def _extra_inputs(cfg: ArchConfig) -> dict:
    """The reference's stub-frontend specs: in bf16 when the model
    computes in bf16, else f32."""
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32
    if cfg.family == "vlm":
        return {"patches": (
            lambda bs, seq: (bs, cfg.vis_tokens, cfg.vis_dim), dtype)}
    if cfg.family == "audio":
        return {"frames": (
            lambda bs, seq: (bs, cfg.enc_frames, cfg.d_model), dtype)}
    return {}


_FAMILIES = {"dense": transformer, "moe": moe, "ssm": mamba,
             "hybrid": zamba, "audio": whisper, "vlm": paligemma}

__all__ = ["ArchConfig", "Model", "attention", "common", "config",
           "get_model", "mamba", "moe", "paligemma", "ssm", "transformer",
           "whisper", "zamba"]
