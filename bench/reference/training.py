"""The reference's first training steps: the loss and its gradients from a
family's plain ``loss``, then AdamW as the workload file states it.

The parameters are held in the configuration's parameter dtype (each
update is computed in f32 and rounded to it, as the configuration says
the weights are stored) and every other number in f32: the gradients,
their global norm and clip, both moments, the update.  AdamW decays every
leaf under ``layers`` and every other leaf of two or more dims.
"""
from __future__ import annotations

import math

import torch

from .common import F32, Precision, build, paths


def lr_at(opt: dict, step: int) -> float:
    """The learning rate of (1-based) ``step``: a linear warm-up, then a
    cosine down to ``floor`` of the peak."""
    peak, warm, total = opt["peak_lr"], opt["warmup"], opt["total_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    t = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    floor = opt["lr_floor"]
    return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * t)))


def _decays(path: tuple, ndim: int) -> bool:
    return path[0] == "layers" or ndim >= 2


def readings(family, cfg: dict, opt: dict, weights, batches: list,
             prec: Precision, rows: slice = slice(None)) -> dict:
    """{"losses", "grad_norms", "change_norms"} of ``len(batches)`` steps
    from the weights ``weights()`` makes (called twice: to start, and to
    measure each leaf's change at the end, so no copy is held between):
    the loss of each step, the norm of each leaf's first clipped gradient,
    and of its change over the steps.  ``rows`` picks the rows of each
    batch the loss reads (a planted fault leaves half of them out)."""
    names, start = zip(*paths(weights()))
    dtypes = [t.dtype for t in start]
    work = [t.to(F32) for t in start]
    del start
    mu = [torch.zeros_like(t) for t in work]
    nu = [torch.zeros_like(t) for t in work]
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    losses, grad_norms = [], None
    for step, (tokens, targets) in enumerate(batches, start=1):
        leaves = [t.detach().requires_grad_(True) for t in work]
        with torch.enable_grad():
            loss = family.loss(cfg, build(zip(names, leaves)),
                               tokens[rows], targets[rows], prec)
            grads = list(torch.autograd.grad(loss, leaves))
        del leaves
        losses.append(float(loss.detach()))
        del loss
        gnorm = float(torch.sqrt(sum(g.square().sum() for g in grads)))
        scale = min(1.0, opt["max_grad_norm"] / max(gnorm, 1e-9))
        if step == 1:
            grad_norms = {leaf_name(n): float(g.norm()) * scale
                          for n, g in zip(names, grads)}
        lr = lr_at(opt, step)
        b1c, b2c = 1 - b1 ** step, 1 - b2 ** step
        for i in range(len(grads)):
            g, grads[i] = grads[i] * scale, None
            mu[i].mul_(b1).add_((1 - b1) * g)
            nu[i].mul_(b2).add_((1 - b2) * g.square())
            del g
            delta = (mu[i] / b1c) / (torch.sqrt(nu[i] / b2c) + eps)
            if _decays(names[i], work[i].ndim):
                delta.add_(opt["weight_decay"] * work[i])
            work[i] = (work[i] - lr * delta).to(dtypes[i]).to(F32)
            del delta
        del grads
    del mu, nu
    start = dict(paths(weights()))
    change = {leaf_name(n): float((w - start[n].to(F32)).norm())
              for n, w in zip(names, work)}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


def leaf_name(path: tuple) -> str:
    return ".".join(str(p) for p in path)
