"""Kind ``train``: the program's training step, driven for a window.

Set-up builds one object, the step of
``repro_torch.runtime.make_train_step(model.loss_fn, adamw(...,
inplace=True))`` for ``repro_torch.models.get_model(config, attn=...)``,
with the weights the benchmark makes from the seed and the optimizer's
first state, and drives it through its first ``check_steps`` steps with
the window's own call and feed.  From those steps it keeps the losses,
each leaf's first gradient as the optimizer got it (its first moment over
1 - b1) and each leaf's change.  The window then runs that same object on
(the loss read back each step, as a training loop logs it) until
``--seconds`` have passed.  Once it has closed, and the program's state
is freed, the reference takes the same weights and batches through the
same steps, and ``compare.train_numbers`` holds the two apart.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time

import torch
from torch.profiler import record_function

from .. import compare, traffic
from ..cell import Cell, arch_config
from ..reference.common import F32_PRECISION, fp32_matmuls, paths
from ..reference.training import leaf_name, readings


@dataclasses.dataclass
class Program:
    step_fn: object
    params: dict
    state: dict
    next_step: int = 1
    # CUDA event pairs around each optimizer update (traced runs)
    optim_events: list = dataclasses.field(default_factory=list)


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(opt, events: list):
    """``opt`` with CUDA events recorded on the stream before and after
    each update, inside a ``bench.optimizer`` span."""
    from repro_torch.optim import Optimizer

    def update(grads, state, params):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with record_function("bench.optimizer"):
            start.record()
            out = opt.update(grads, state, params)
            end.record()
        events.append((start, end))
        return out
    return Optimizer(opt.init, update)


def build(cell: Cell) -> Program:
    """The training step object with its first weights and state."""
    from repro_torch.models import get_model
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.runtime import make_train_step

    wl, o = cell.workload, cell.workload["optimizer"]
    model = get_model(arch_config(cell.config), device=cell.device,
                      attn=wl["attn"])
    opt = adamw(cosine_schedule(o["peak_lr"], o["warmup"], o["total_steps"],
                                o["lr_floor"]),
                b1=o["b1"], b2=o["b2"], eps=o["eps"],
                weight_decay=o["weight_decay"],
                max_grad_norm=o["max_grad_norm"], inplace=True)
    events: list = []
    if cell.trace:
        opt = _timed(opt, events)
    step_fn = make_train_step(model.loss_fn, opt,
                              microbatches=wl["microbatches"])
    weights = cell.weights()
    return Program(step_fn, weights, opt.init(weights), optim_events=events)


def step(prog: Program, cell: Cell) -> float:
    """One step of the window's call and feed; its loss, read back."""
    with record_function("bench.batch"):
        batch = traffic.train_batch(cell.workload, cell.config, cell.seed,
                                    prog.next_step, cell.device)
    with record_function("bench.train_step"):
        prog.params, prog.state, m = prog.step_fn(prog.params, prog.state,
                                                  batch)
    prog.next_step += 1
    with record_function("bench.loss_read"):
        return float(m["loss"])


def first_steps(prog: Program, cell: Cell) -> dict:
    """The program's readings of its first ``check_steps`` steps."""
    b1 = cell.workload["optimizer"]["b1"]
    losses, grads = [], None
    for k in range(cell.workload["check_steps"]):
        losses.append(step(prog, cell))
        if k == 0:
            grads = {leaf_name(p): float(m.float().norm()) / (1 - b1)
                     for p, m in paths(prog.state["mu"])}
    start = cell.weights()
    now = dict(paths(prog.params))
    change = {leaf_name(p): float((now[p].float() - s.float()).norm())
              for p, s in paths(start)}
    del start, now
    return {"losses": losses, "grad_norms": grads, "change_norms": change}


def window(prog: Program, cell: Cell) -> dict:
    """Steps until ``cell.seconds`` have passed: their count, the failed
    (non-finite) ones and the window's seconds."""
    failed, ends = 0, []
    t0 = time.perf_counter()
    while True:
        loss = step(prog, cell)
        failed += not math.isfinite(loss)
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= cell.seconds:
            break
    _sync(cell.device)
    return {"steps": len(ends), "failed": failed,
            "window_s": time.perf_counter() - t0,
            "unit_s": [b - a for a, b in zip([0.0] + ends, ends)]}


def batches(cell: Cell) -> list:
    """The first ``check_steps`` batches, as (tokens, targets)."""
    out = []
    for k in range(1, cell.workload["check_steps"] + 1):
        b = traffic.train_batch(cell.workload, cell.config, cell.seed, k,
                                cell.device)
        out.append((b["tokens"], b["targets"]))
    return out


def reference(cell: Cell, prec=F32_PRECISION, rows=slice(None)) -> dict:
    """The reference's readings of the same first steps, from the same
    weights and batches."""
    fp32_matmuls()
    return readings(cell.reference, cell.config, cell.workload["optimizer"],
                    cell.weights, batches(cell), prec, rows)


def free(prog: Program) -> None:
    prog.step_fn = prog.params = prog.state = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell: Cell) -> dict:
    from ..trace import traced

    prog = build(cell)
    built = cell.since_start()
    got = first_steps(prog, cell)
    _sync(cell.device)
    setup_s = cell.since_start()
    prog.optim_events.clear()
    on_card = torch.device(cell.device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    obs = window(prog, cell)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    wl = cell.workload
    tokens = obs["steps"] * wl["batch"] * wl["seq_len"]
    obs.update(config=cell.config, workload=wl, peak_bytes=peak,
               setup_parts={"start to weights and state": built,
                            "first steps": setup_s - built})
    if prog.optim_events:
        obs["optim_ms"] = sum(a.elapsed_time(b) for a, b in
                              prog.optim_events) / len(prog.optim_events)
    trace = None
    if cell.trace:
        trace = traced(lambda: [step(prog, cell)
                                for _ in range(wl["trace_units"])])
    obs["trace"] = trace
    free(prog)
    t0 = time.perf_counter()
    numbers = compare.train_numbers(got, reference(cell),
                                    wl["final_norm_leaf"])
    obs["reference_s"] = time.perf_counter() - t0
    return {"setup_s": setup_s,
            "end_to_end": {"train_tok_s": tokens / obs["window_s"]},
            "attempted": obs["steps"], "failed": obs["failed"],
            "obs": obs, "trace": trace, "memory_peak_bytes": peak,
            "numbers": numbers}
