"""Train step builders with microbatch accumulation and grad shardings.

The counterpart of ``repro/runtime/trainstep.py``.  ``grad_shardings`` (a
param tree of ``runtime.sharding.NamedSharding``) pins the gradients and
the f32 microbatch accumulator to the params' placements: each
microbatch's grads are redistributed there (on a ``data``-split leaf, the
reduce-scatter of ZeRO) before they are added, so no replicated f32 grad
of a whole leaf outlives its microbatch.  Without it (the single-device
run) nothing is constrained.  Donation is the caller's: ``adamw(...,
inplace=True)``.  ``make_serve_step`` has no caller in the port.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor

from .. import tracing
from ..models.common import replicating, whole
from ..optim import Optimizer
from ..optim.adamw import local_part, placed_like
from ..tree import tree_leaves, tree_map, tree_map_with_path, tree_paths


def _constrain(tree, shardings):
    if shardings is None:
        return tree
    return tree_map(lambda g, sh: g.redistribute(sh.mesh, sh.placements)
                    if g.placements != sh.placements else g,
                    tree, shardings)


def _dist_context(params):
    """Plain tensors made inside the step count as replicated when the
    params are DTensors (the backward runs inside it too)."""
    return replicating() if any(
        isinstance(t, DTensor) for t in tree_leaves(params)) \
        else contextlib.nullcontext()


def _value_and_grad(loss_fn, params, batch):
    """(loss, grads): grads in each param's dtype, as ``jax.grad``
    gives them."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    paths, flat = zip(*tree_paths(leaves))
    with torch.enable_grad(), _dist_context(params), \
            tracing.span("train.grad"):
        loss = loss_fn(leaves, batch)
        grads = dict(zip(paths, torch.autograd.grad(loss, flat)))
    return loss.detach(), tree_map_with_path(lambda path, _: grads[path],
                                             leaves)


def make_loss_with_accum(loss_fn, microbatches: int, grad_shardings=None):
    """``fn(params, batch) -> (loss, grads)``.  With ``microbatches > 1``
    the batch splits along its first axis into that many chunks, one
    forward and backward each (activation memory / microbatches); the
    grads accumulate in f32 and are averaged, as the reference's scan
    does.  With one microbatch they stay in the param dtype.  A DTensor
    batch's microbatch i is its rows ``[i * n, (i + 1) * n)`` split as the
    batch is, as the reference's reshape takes them: the MoE dispatch and
    the token weights' mean see the same rows."""
    if microbatches <= 1:
        def simple(params, batch):
            loss, grads = _value_and_grad(loss_fn, params, batch)
            return loss, _constrain(grads, grad_shardings)
        return simple

    def accum(params, batch):
        def chunk(x, i):
            b = x.shape[0]
            if b % microbatches:
                raise ValueError(f"batch of {b} rows does not split into "
                                 f"{microbatches} microbatches")
            n = b // microbatches
            if isinstance(x, DTensor):
                return whole(x)[i * n:(i + 1) * n].redistribute(
                    x.device_mesh, x.placements)
            return x[i * n:(i + 1) * n]

        loss_acc = None
        grads_acc = tree_map(lambda p: placed_like(torch.zeros_like(
            local_part(p), dtype=torch.float32), p), params)
        for i in range(microbatches):
            mbatch = {k: chunk(v, i) for k, v in batch.items()}
            loss, grads = _value_and_grad(loss_fn, params, mbatch)
            grads = _constrain(grads, grad_shardings)
            loss_acc = loss.float() if loss_acc is None else \
                loss_acc + loss.float()
            with _dist_context(params):
                grads_acc = _constrain(tree_map(torch.add, grads_acc, grads),
                                       grad_shardings)
        inv = 1.0 / microbatches
        return loss_acc * inv, tree_map(lambda g: g * inv, grads_acc)

    return accum


def make_train_step(loss_fn, optimizer: Optimizer, microbatches: int = 1,
                    grad_shardings=None):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics).  While tracing is on (``repro_torch.tracing``) a step is the
    span ``train.step``, each microbatch's forward and backward
    ``train.grad`` and the optimizer's update ``train.update``."""
    grad_fn = make_loss_with_accum(loss_fn, microbatches, grad_shardings)

    def train_step(params, opt_state, batch):
        with tracing.span("train.step"):
            loss, grads = grad_fn(params, batch)
            if isinstance(loss, DTensor):  # a partial sum over the split
                loss = loss.full_tensor()
            with tracing.span("train.update"):
                new_params, new_state, om = optimizer.update(
                    grads, opt_state, params)
        return new_params, new_state, {"loss": loss, **om}

    return train_step


__all__ = ["make_loss_with_accum", "make_train_step"]
