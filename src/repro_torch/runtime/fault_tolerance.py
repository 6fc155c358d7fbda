"""Fault-tolerant training loop.

The counterpart of ``repro/runtime/fault_tolerance.py``, with its
behaviours:

* periodic atomic checkpoints (keep-k) + resume-from-latest on start;
* non-finite loss detection -> roll back to the last checkpoint and skip
  ahead past the poisoned batch;
* failure injection (``inject_failure_at``) to exercise the recovery path;
* straggler monitor: per-step wall-time EMA + z-score; slow steps are
  logged and kept in the report.

Checkpoints hold the reference's stacked layer layout
(``convert.to_reference_layout`` of ``cfg``), so the JAX package's loop
resumes from them and this one from the JAX package's.  The report also
keeps every step's wall seconds.

On a sharded state (DTensor leaves, one process a rank) every rank runs the
loop: the loss it reads is the whole batch's, so every rank takes the same
rollback and resume decisions; each checkpoint is gathered and rank 0
writes it (``checkpoint.save_checkpoint``); a load places each leaf as
the state's leaf is placed (``checkpoint.restore_sharded``); and the
straggler monitor watches each rank's own step times.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .. import checkpoint as ckpt
from ..convert import from_reference_layout, to_reference_layout
from ..models.config import ArchConfig
from ..tree import tree_leaves, tree_map


@dataclasses.dataclass
class StragglerMonitor:
    ema: float = 0.0
    var: float = 0.0
    n: int = 0
    threshold: float = 3.0
    slow_steps: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        if self.n >= 5:
            std = max(self.var ** 0.5, 1e-6)
            z = (dt - self.ema) / std
            if z > self.threshold:
                self.slow_steps.append((step, dt, z))
                return True
        # EMA/EVar update (after the z-test so outliers flag first)
        a = 0.2 if self.n else 1.0
        delta = dt - self.ema
        self.ema += a * delta
        self.var = (1 - a) * (self.var + a * delta * delta)
        self.n += 1
        return False


@dataclasses.dataclass
class LoopReport:
    steps_run: int = 0
    rollbacks: int = 0
    resumed_from: int | None = None
    losses: list = dataclasses.field(default_factory=list)
    slow_steps: list = dataclasses.field(default_factory=list)
    step_seconds: list = dataclasses.field(default_factory=list)


class _Placed(NamedTuple):
    """Where a loaded leaf goes: a DTensor's mesh and placements."""
    mesh: object
    placements: tuple


def _save(cfg: ArchConfig, ckpt_dir: str, step: int, state: dict,
          keep: int) -> None:
    """A checkpoint of ``state``; a sharded one gathered on every rank and
    written by rank 0."""
    sharded = any(isinstance(t, DTensor) for t in tree_leaves(state))
    whole = tree_map(ckpt.store.gathered, state)
    if not sharded or dist.get_rank() == 0:
        ckpt.save_checkpoint(ckpt_dir, step, to_reference_layout(cfg, whole),
                             keep=keep)
    if sharded:
        dist.barrier()


def _load(cfg: ArchConfig, ckpt_dir: str, like: dict, step: int | None
          ) -> tuple[dict, int]:
    """The checkpoint at ``step`` (latest if None) on the devices, in the
    dtypes and with the placements of ``like``'s leaves."""
    shapes = to_reference_layout(cfg, tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), like))
    tree, step, _ = ckpt.load_checkpoint(ckpt_dir, shapes, step)
    state = from_reference_layout(cfg, tree)
    where = tree_map(lambda t: _Placed(t.device_mesh, t.placements)
                     if isinstance(t, DTensor) else t.device, like)
    return tree_map(ckpt.store.place_array, state, where), step


def train_loop(train_step: Callable, params, opt_state, data_iter,
               *, cfg: ArchConfig, steps: int, ckpt_dir: str,
               ckpt_every: int = 50, keep: int = 3,
               inject_failure_at: int | None = None,
               inject_nan_at: int | None = None,
               log_every: int = 10, logger=print) -> tuple:
    """Run ``steps`` optimizer steps with checkpoint/restart + NaN rollback.

    ``data_iter(step) -> batch`` must be random-access (resumable); ``cfg``
    gives the checkpoints their reference layout.  ``ckpt_every`` 0 writes
    no checkpoint (a run too large to save, timed or checked once); a
    non-finite loss then raises, with nothing to roll back to.  The loop
    keeps no reference to the ``params`` and ``opt_state`` it was given
    once a step has replaced them, so a caller that keeps none either
    frees them (at full width on one card, a second bf16 copy of the
    params takes 5-9 GB).  Returns (params, opt_state, LoopReport)."""
    report = LoopReport()
    state = {"params": params, "opt": opt_state}
    del params, opt_state

    start = 0
    latest = ckpt.latest_step(ckpt_dir)
    if latest is not None:
        state, start = _load(cfg, ckpt_dir, state, latest)
        report.resumed_from = start
        logger(f"[ft] resumed from checkpoint step {start}")
    elif ckpt_every > 0:
        _save(cfg, ckpt_dir, 0, state, keep)

    monitor = StragglerMonitor()
    step = start
    while step < steps:
        batch = data_iter(step)
        if inject_nan_at is not None and step == inject_nan_at:
            inject_nan_at = None  # only once
            if "weights" in batch:
                poisoned = np.asarray(batch["weights"], np.float32).copy()
                poisoned[..., 0] = np.nan
                batch = {**batch, "weights": poisoned}
        t0 = time.perf_counter()
        if inject_failure_at is not None and step == inject_failure_at:
            inject_failure_at = None
            raise InjectedFailure(step)
        new_params, new_opt, metrics = train_step(state["params"],
                                                  state["opt"], batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        report.step_seconds.append(dt)
        if monitor.observe(step, dt):
            logger(f"[ft] straggler: step {step} took {dt * 1e3:.1f} ms")

        if not np.isfinite(loss):
            if ckpt_every <= 0:
                raise FloatingPointError(f"non-finite loss at step {step}, "
                                         "and no checkpoint to roll back to")
            report.rollbacks += 1
            state, rb_step = _load(cfg, ckpt_dir, state, None)
            logger(f"[ft] non-finite loss at step {step}; rolled back to "
                   f"{rb_step}, skipping batch")
            step += 1  # skip the poisoned batch
            continue

        state = {"params": new_params, "opt": new_opt}
        report.losses.append(loss)
        report.steps_run += 1
        step += 1
        if ckpt_every > 0 and (step % ckpt_every == 0 or step == steps):
            _save(cfg, ckpt_dir, step, state, keep)
        if step % log_every == 0:
            logger(f"[train] step {step} loss {loss:.4f} "
                   f"({dt * 1e3:.0f} ms)")

    report.slow_steps = monitor.slow_steps
    return state["params"], state["opt"], report


class InjectedFailure(RuntimeError):
    def __init__(self, step):
        super().__init__(f"injected failure at step {step}")
        self.step = step


__all__ = ["InjectedFailure", "LoopReport", "StragglerMonitor", "train_loop"]
