"""Int8 gradient compression with error feedback.

The counterpart of ``repro/optim/compression.py``: gradients are quantised
to int8 with a per-tensor scale, and the quantisation residual is carried
to the next step (error feedback), which keeps SGD convergence unbiased in
expectation.  ``int8_compressed(opt, cfg)`` wraps any Optimizer: its state
grows an ``err`` tree of f32 residuals that mirrors the params.

The reference's tensors are its stacked layer leaves, so one scale spans a
leaf of every layer (of one pattern position).  The port quantises in that
layout (``convert.to_reference_layout``), so it gives the same numbers.
On DTensor leaves the residuals keep the params' placements, and each
scale is the max over the whole stacked leaf (a max across its shards).
"""
from __future__ import annotations

import torch

from ..convert import from_reference_layout, to_reference_layout
from ..models.config import ArchConfig
from ..tree import tree_map, tree_pick
from .adamw import Optimizer, local_part, placed_like


def compress(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 tensor -> (int8 payload, f32 scale)."""
    gf = g.to(torch.float32)
    scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def int8_compressed(opt: Optimizer, cfg: ArchConfig) -> Optimizer:
    def init(params):
        inner = opt.init(params)
        err = tree_map(lambda p: placed_like(torch.zeros_like(
            local_part(p), dtype=torch.float32), p), params)
        return {"inner": inner, "err": err}

    @torch.no_grad()
    def update(grads, state, params):
        def q_with_feedback(g, e):
            corrected = g.to(torch.float32) + e
            deq = decompress(*compress(corrected))
            return deq, corrected - deq

        pairs = tree_map(q_with_feedback, to_reference_layout(cfg, grads),
                         to_reference_layout(cfg, state["err"]))
        deq, err = (from_reference_layout(cfg, tree_pick(pairs, i))
                    for i in (0, 1))
        new_params, inner, metrics = opt.update(deq, state["inner"], params)
        return new_params, {"inner": inner, "err": err}, metrics

    return Optimizer(init, update)


__all__ = ["compress", "decompress", "int8_compressed"]
