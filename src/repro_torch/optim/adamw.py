"""Self-contained AdamW + schedules + global-norm clipping.

The counterpart of ``repro/optim/adamw.py`` with the same dtype rules:
moments are f32 whatever the param dtype (bf16-safe), weight decay applies
to leaves of ``ndim >= 2`` in the reference's stacked layout (``_ref_ndim``),
and updated params are cast back to their dtype.  The optimizer-state tree mirrors the param tree
(``{"mu": tree, "nu": tree, "step": int32 scalar}``), so a checkpoint
holds the reference's layout.  Updates are functional, as in the
reference: ``update`` returns new tensors and leaves its inputs as they
were, so a rollback can reuse the old state.  ``adamw(..., inplace=True)``
updates the f32 moments in place instead and returns them, for a caller
that owns its state and rolls back from checkpoints (``launch.train``): at
2.7B parameters a second copy of the moments (21.6 GB) does not fit an
80 GB card beside the rest of a train step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..tree import tree_leaves, tree_map, tree_map_with_path, tree_pick

_F32 = torch.float32


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(_F32)))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    g = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    return tree_map(lambda leaf: (leaf.to(_F32) * scale).to(leaf.dtype),
                    tree), g


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(_F32)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable:
    def lr(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


def linear_schedule(peak_lr: float, warmup: int, total: int) -> Callable:
    def lr(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return torch.where(step < warmup, warm, peak_lr * (1 - t))
    return lr


def _ref_ndim(path: tuple, p: torch.Tensor) -> int:
    """``p.ndim`` in the reference's layout, which stacks every layer leaf
    as ``(n_groups, ...)``: there its ``ndim >= 2`` decay test also decays
    the layers' norm scales (not ``ln_f``'s), and so does the port."""
    return p.ndim + ("layers" in path)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (params, state, metrics)


def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          max_grad_norm: float = 1.0, inplace: bool = False) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: torch.tensor(lr, dtype=_F32))

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=_F32,  # noqa: E731
                                      device=p.device)
        device = tree_leaves(params)[0].device
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        t = step.to(_F32)
        b1c = 1 - torch.tensor(b1, dtype=_F32, device=t.device) ** t
        b2c = 1 - torch.tensor(b2, dtype=_F32, device=t.device) ** t
        lr_t = lr_fn(step).to(t.device)

        def upd(path, g, m, v, p):
            gf = g.to(_F32)
            if inplace:  # rounded as the expressions below are
                m2 = m.mul_(b1).add_((1 - b1) * gf)
                v2 = v.mul_(b2).add_((1 - b2) * torch.square(gf))
            else:
                m2 = b1 * m + (1 - b1) * gf
                v2 = b2 * v + (1 - b2) * torch.square(gf)
            mhat = m2 / b1c
            vhat = v2 / b2c
            delta = mhat / (torch.sqrt(vhat) + eps)
            if _ref_ndim(path, p) >= 2:  # decay matrices only
                delta = delta + weight_decay * p.to(_F32)
            return (p.to(_F32) - lr_t * delta).to(p.dtype), m2, v2

        out = tree_map_with_path(upd, grads, state["mu"], state["nu"], params)
        new_state = {"mu": tree_pick(out, 1), "nu": tree_pick(out, 2),
                     "step": step}
        return tree_pick(out, 0), new_state, {"grad_norm": gnorm,
                                              "lr": lr_t}

    return Optimizer(init, update)


__all__ = ["Optimizer", "adamw", "clip_by_global_norm", "cosine_schedule",
           "global_norm", "linear_schedule"]
