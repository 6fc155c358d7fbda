"""Train step builders with microbatch gradient accumulation.

The counterpart of ``repro/runtime/trainstep.py``.  The reference's
sharding constraints and donation belong to the distribution slice and are
left out; ``make_serve_step`` has no caller in the port yet.
"""
from __future__ import annotations

import torch

from ..optim import Optimizer
from ..tree import tree_map, tree_map_with_path, tree_paths


def _value_and_grad(loss_fn, params, batch):
    """(loss, grads): grads in each param's dtype, as ``jax.grad``
    gives them."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    paths, flat = zip(*tree_paths(leaves))
    with torch.enable_grad():
        loss = loss_fn(leaves, batch)
        grads = dict(zip(paths, torch.autograd.grad(loss, flat)))
    return loss.detach(), tree_map_with_path(lambda path, _: grads[path],
                                             leaves)


def make_loss_with_accum(loss_fn, microbatches: int):
    """``fn(params, batch) -> (loss, grads)``.  With ``microbatches > 1``
    the batch splits along its first axis into that many chunks, one
    forward and backward each (activation memory / microbatches); the
    grads accumulate in f32 and are averaged, as the reference's scan
    does.  With one microbatch they stay in the param dtype."""
    if microbatches <= 1:
        return lambda params, batch: _value_and_grad(loss_fn, params, batch)

    def accum(params, batch):
        def chunk(x, i):
            b = x.shape[0]
            if b % microbatches:
                raise ValueError(f"batch of {b} rows does not split into "
                                 f"{microbatches} microbatches")
            n = b // microbatches
            return x[i * n:(i + 1) * n]

        loss_acc = None
        grads_acc = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        for i in range(microbatches):
            mbatch = {k: chunk(v, i) for k, v in batch.items()}
            loss, grads = _value_and_grad(loss_fn, params, mbatch)
            loss_acc = loss.float() if loss_acc is None else \
                loss_acc + loss.float()
            grads_acc = tree_map(torch.add, grads_acc, grads)
        inv = 1.0 / microbatches
        return loss_acc * inv, tree_map(lambda g: g * inv, grads_acc)

    return accum


def make_train_step(loss_fn, optimizer: Optimizer, microbatches: int = 1):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics)."""
    grad_fn = make_loss_with_accum(loss_fn, microbatches)

    def train_step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        new_params, new_state, om = optimizer.update(grads, opt_state, params)
        return new_params, new_state, {"loss": loss, **om}

    return train_step


__all__ = ["make_loss_with_accum", "make_train_step"]
