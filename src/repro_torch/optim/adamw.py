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

Two paths, chosen leaf by leaf by the device alone, with no option.
Every leaf on a CUDA card takes the fused path: ``csrc/adamw.cu`` sums
every such gradient's squares in one launch, and updates every such leaf
in one more, the clip included, reading g, m, v and p once and writing p,
m and v once, with no f32 temporary.  A strided gradient is made
contiguous first; the kernels' wrappers raise on a leaf they cannot take
(a param or gradient not in bf16 or f32, moments not in f32).  Its update
is the eager path's bit for bit at the same norm; its norm adds the
squares in another order, which may move the last bits.  Every CPU leaf
takes the eager path, elementwise PyTorch ops.

The eager norm, clip and update run over each leaf a slice of its
leading dimension at a time (``SLICE_ELEMS``), so no f32 temporary is
larger than a slice, whatever the leaf: command-r-plus-104b's tied
embedding is one leaf of 3.1 B parameters, 12.6 GB in f32.  The clip and
the update are elementwise, so the slices change no value; the update
clips each slice of a gradient as it reads it, rounding it to the
gradient's dtype as ``clip_by_global_norm`` does, and makes no clipped
copy of the tree.  ``global_norm`` sums each slice's squares in f32 and
then the slices', which may move its last bits against one sum per leaf.
The fused path needs no slices: its kernels keep 64-bit offsets.

Under a profiler (``repro_torch.tracing``) ``update`` counts
``optim.elems``, the param elements it updated, and ``optim.fused_elems``,
those the fused path updated.

DTensor leaves (the sharded train step) update elementwise on each rank's
local shard, slices included, so params, grads and moments keep their
placements; the moments are zeros of the params' placements, which
``shardings(opt_state)`` gives them too.  ``global_norm`` sums each leaf's
local squares, then adds the sums of leaves split over a mesh dim across
that dim (one all-reduce a dim), so a replicated leaf counts once, not
once a rank; the leaves' sums are then added in the same order as
unsharded, so at one rank the norm is bit-equal to it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard

from .. import tracing
from ..kernels import adamw as fused
from ..tree import tree_leaves, tree_map, tree_map_with_path, tree_pick

_F32 = torch.float32
# the most elements of a leaf that one step of the norm, the clip or the
# update takes at once: 256 MB of f32 a temporary
SLICE_ELEMS = 1 << 26


def leaf_slices(*leaves: torch.Tensor):
    """Views of same-shaped ``leaves``, slice by slice of the leading
    dimension, each slice at most ``SLICE_ELEMS`` elements (at least one
    row); a leaf that fits, or a scalar, is one slice."""
    x = leaves[0]
    if x.ndim == 0 or x.numel() <= SLICE_ELEMS:
        return [leaves]
    rows = max(1, SLICE_ELEMS * x.shape[0] // x.numel())
    return zip(*(leaf.split(rows) for leaf in leaves))


def _sq_sum(leaf: torch.Tensor) -> torch.Tensor:
    return sum(torch.sum(torch.square(s.to(_F32)))
               for s, in leaf_slices(leaf))


def _on_card(t: torch.Tensor) -> bool:
    """Whether a leaf (its local shard) takes the fused path."""
    return t.device.type == "cuda"


def _sq_sums(leaves: list) -> list:
    """Each leaf's sum of squares, a 0-d f32 tensor: those on the card
    from one launch of the fused kernel, the rest from ``_sq_sum``."""
    mine = [i for i, g in enumerate(leaves) if _on_card(g)]
    sums = fused.sq_sums([leaves[i].contiguous() for i in mine]).unbind() \
        if mine else ()
    got = dict(zip(mine, sums))
    return [got[i] if i in got else _sq_sum(g) for i, g in enumerate(leaves)]


def _whole_sums(leaves: list) -> list:
    """Each DTensor leaf's sum of squares over the whole leaf: the local
    sums, added across every mesh dim that splits the leaf."""
    leaves = [g.redistribute(g.device_mesh, [p if not p.is_partial() else
                                             Replicate() for p in
                                             g.placements])
              if any(p.is_partial() for p in g.placements) else g
              for g in leaves]
    sums = torch.stack(_sq_sums([g.to_local() for g in leaves]))
    mesh = leaves[0].device_mesh
    for d in range(mesh.ndim):
        split = [isinstance(g.placements[d], Shard) for g in leaves]
        if any(split):
            split = torch.tensor(split, device=sums.device)
            total = funcol.all_reduce(torch.where(split, sums, 0.0), "sum",
                                      (mesh, d))
            sums = torch.where(split, total, sums)
    return list(sums.unbind())


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    if leaves and isinstance(leaves[0], DTensor):
        return torch.sqrt(sum(_whole_sums(leaves)))
    return torch.sqrt(sum(_sq_sums(leaves)))


def _clip_scale(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.to(_F32) * scale).to(g.dtype)


def clip_by_global_norm(tree, max_norm: float):
    g = global_norm(tree)
    scale = _clip_scale(g, max_norm)

    def clip(leaf):
        out = torch.empty_like(local_part(leaf))
        for s, o in leaf_slices(local_part(leaf), out):
            o.copy_(_clipped(s, scale))
        return placed_like(out, leaf)
    return tree_map(clip, tree), g


def local_part(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor; a plain tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def placed_like(local: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``local`` as the shard of a DTensor placed as ``t``, when ``t`` is
    one."""
    if not isinstance(t, DTensor):
        return local
    return DTensor.from_local(local, t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


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
        def zeros(p):
            loc = local_part(p)
            return placed_like(torch.zeros_like(loc, dtype=_F32), p)
        device = local_part(tree_leaves(params)[0]).device
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def update(grads, state, params):
        step = local_part(state["step"]) + 1
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, max_grad_norm)
        t = step.to(_F32)
        # filled on the card, not copied to it: a copy waits for the card
        b1c = 1 - torch.full((), b1, dtype=_F32, device=t.device) ** t
        b2c = 1 - torch.full((), b2, dtype=_F32, device=t.device) ** t
        lr_t = lr_fn(step).to(t.device)
        on_card = []    # leaves on the card, updated in one launch
        elems = [0, 0]  # param elements updated: all, fused

        def upd(path, g, m, v, p):
            decay = _ref_ndim(path, p) >= 2  # decay matrices only
            if isinstance(g, DTensor) and g.placements != p.placements:
                g = g.redistribute(p.device_mesh, p.placements)
            dp = p
            g, m, v, p = (local_part(t) for t in (g, m, v, p))
            new_p = torch.empty_like(p)
            m2, v2 = (m, v) if inplace else (torch.empty_like(m),
                                             torch.empty_like(v))
            elems[0] += p.numel()
            if _on_card(p):
                on_card.append((g.contiguous(), m, v, p, new_p, m2, v2,
                                decay))
                elems[1] += p.numel()
                return tuple(placed_like(t, dp) for t in (new_p, m2, v2))
            slices = leaf_slices(g, m, v, p, new_p, m2, v2)
            for gs, ms, vs, ps, ps2, ms2, vs2 in slices:
                gf = _clipped(gs, scale).to(_F32)
                if inplace:  # rounded as the expressions below are
                    ms.mul_(b1).add_((1 - b1) * gf)
                    vs.mul_(b2).add_((1 - b2) * torch.square(gf))
                else:
                    ms2.copy_(b1 * ms + (1 - b1) * gf)
                    vs2.copy_(b2 * vs + (1 - b2) * torch.square(gf))
                delta = (ms2 / b1c) / (torch.sqrt(vs2 / b2c) + eps)
                if decay:
                    delta = delta + weight_decay * ps.to(_F32)
                ps2.copy_((ps.to(_F32) - lr_t * delta).to(p.dtype))
            return tuple(placed_like(t, dp) for t in (new_p, m2, v2))

        out = tree_map_with_path(upd, grads, state["mu"], state["nu"], params)
        if on_card:
            fused.update(on_card, scale, b1c, b2c, lr_t, b1=b1, b2=b2,
                         eps=eps, weight_decay=weight_decay)
        tracing.count("optim.elems", elems[0])
        tracing.count("optim.fused_elems", elems[1])
        new_state = {"mu": tree_pick(out, 1), "nu": tree_pick(out, 2),
                     "step": placed_like(step, state["step"])}
        return tree_pick(out, 0), new_state, {"grad_norm": gnorm,
                                              "lr": lr_t}

    return Optimizer(init, update)


__all__ = ["Optimizer", "SLICE_ELEMS", "adamw", "clip_by_global_norm",
           "cosine_schedule", "global_norm", "leaf_slices", "linear_schedule",
           "local_part", "placed_like"]
