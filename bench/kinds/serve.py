"""Kind ``serve``: the program's serving loop, driven for a window.

An offline queue that is always full: ``repro_torch.launch.serve.serve``
serves one batch of ``batch`` prompts at a time (prefill, then
``max_new`` greedy decode steps through the KV cache), and the window
runs batches until ``--seconds`` have passed, to the end of the batch in
flight.  Set-up makes the weights from the seed and serves one batch of
the cell's own shapes.  The model handed to ``serve`` is the program's
with its ``prefill`` and ``decode_step`` wrapped: the wrapper keeps the
logits the timed path returned for ``rows_kept`` rows of each batch, the
next slots of the batch in turn from one drawn from the seed, with the
prompts they came from; it counts as failed each request whose logits
were ever not finite, and times the calls.  Once the window has closed,
``sample_requests`` of the kept requests, drawn from the seed and spread
over the batch's slots (one a slot before a second in any), go through
the reference's full forward over each prompt and its served tokens, and
``compare.serve_numbers`` holds the two apart.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import compare, traffic
from ..cell import Cell, arch_config
from ..params import derive
from ..reference.common import F32_PRECISION, fp32_matmuls


@dataclasses.dataclass
class Kept:
    """What the wrapper keeps of one batch: the kept rows' prompts, their
    logits at each step, the tokens served."""
    rows: list
    prompts: torch.Tensor | None = None
    logits: list = dataclasses.field(default_factory=list)
    served: np.ndarray | None = None


class Wrapped:
    """The program's model with ``prefill`` and ``decode_step`` wrapped to
    keep a batch's sampled rows and to time the calls: prefill on the
    host clock around a synchronize (when ``sync_prefill``), decode by the
    host clock between one step's call and the next's.  ``bad`` marks
    the batch's rows whose logits were not finite at some step."""

    def __init__(self, model, sync_prefill: bool):
        self.model = model
        self.sync = sync_prefill
        self.batch: Kept | None = None
        self.bad: torch.Tensor | None = None
        self.prefill_s: list[float] = []
        self.decode_gaps: list[float] = []
        self._last_decode: float | None = None

    def as_model(self):
        return dataclasses.replace(self.model, prefill=self.prefill,
                                   decode_step=self.decode_step)

    def prefill(self, params, inputs, cache):
        self._last_decode = None
        if self.sync:
            torch.cuda.synchronize()
        t = time.perf_counter()
        with record_function("bench.prefill"):
            logits, cache = self.model.prefill(params, inputs, cache)
        if self.sync:
            torch.cuda.synchronize()
            self.prefill_s.append(time.perf_counter() - t)
        self.bad = ~torch.isfinite(logits).all(-1)
        b = self.batch
        if b is not None:
            b.prompts = inputs["tokens"][b.rows].clone()
            b.logits.append(logits[b.rows].clone())
        return logits, cache

    def decode_step(self, params, tok, cache):
        now = time.perf_counter()
        if self._last_decode is not None:
            self.decode_gaps.append(now - self._last_decode)
        self._last_decode = now
        with record_function("bench.decode_step"):
            logits, cache = self.model.decode_step(params, tok, cache)
        self.bad |= ~torch.isfinite(logits).all(-1)
        if self.batch is not None:
            self.batch.logits.append(logits[self.batch.rows].clone())
        return logits, cache


def serve_batch(cell: Cell, model, weights, index: int) -> tuple:
    """One batch of the window's traffic through ``serve``: (its tokens
    (batch, 1 + max_new), the new tokens it counts)."""
    from repro_torch.launch.serve import serve

    wl = cell.workload
    prompts = traffic.serve_prompts(wl, cell.config, cell.seed, index)
    outs, new = serve(model, weights, prompts, batch=wl["batch"],
                      max_new=wl["max_new"], max_len=wl["max_len"])
    return outs[0], new


def _rows(cell: Cell, index: int) -> list:
    """The slots batch ``index`` keeps: the next ``rows_kept`` in turn,
    from a first slot drawn from the seed."""
    batch, n = cell.workload["batch"], cell.workload["rows_kept"]
    first = derive(cell.seed, "kept rows") % batch
    return sorted((first + n * index + j) % batch for j in range(n))


def window(cell: Cell, wrapped: Wrapped, weights, first_index: int = 0
           ) -> dict:
    """Batches until ``cell.seconds`` have passed."""
    model = wrapped.as_model()
    kept, tokens, failed, ends = [], 0, 0, []
    t0 = time.perf_counter()
    while True:
        i = first_index + len(ends)
        wrapped.batch = Kept(_rows(cell, i))
        served, new = serve_batch(cell, model, weights, i)
        wrapped.batch.served = served[wrapped.batch.rows]
        kept.append(wrapped.batch)
        tokens += new
        failed += int(wrapped.bad.sum())
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= cell.seconds:
            break
    wrapped.batch = None
    return {"window_s": time.perf_counter() - t0, "batches": len(ends),
            "new_tokens": tokens, "failed": failed, "kept": kept,
            "unit_s": [b - a for a, b in zip([0.0] + ends, ends)]}


def sample(cell: Cell, kept: list, n: int) -> tuple:
    """(prompts (N, P), served tokens (N, 1 + max_new), the timed path's
    logits at them (N, 1 + max_new, V)) of ``n`` kept requests drawn
    from the seed, in a random order of the requests taken a slot in
    turn: every slot kept once before any twice."""
    reqs = [(b, j) for b in kept for j in range(len(b.rows))
            if len(b.logits) == b.served.shape[1]]
    rng = np.random.default_rng(derive(cell.seed, "sample"))
    order, turn, seen = rng.permutation(len(reqs)), {}, {}
    for i in order:
        slot = reqs[i][0].rows[reqs[i][1]]
        turn[i] = seen.get(slot, 0)
        seen[slot] = turn[i] + 1
    pick = sorted(sorted(order, key=lambda i: turn[i])[:n])
    prompts = torch.stack([reqs[i][0].prompts[reqs[i][1]] for i in pick])
    served = torch.as_tensor(np.stack([reqs[i][0].served[reqs[i][1]]
                                       for i in pick]),
                             device=prompts.device)
    logits = torch.stack([torch.stack([s[reqs[i][1]]
                                       for s in reqs[i][0].logits])
                          for i in pick])
    return prompts, served, logits


def reference_logits(cell: Cell, weights, prompts, served,
                     prec=F32_PRECISION) -> torch.Tensor:
    """The reference's logits at every served position: its full forward
    over each prompt and all but the last of its served tokens."""
    fp32_matmuls()
    seqs = torch.cat([prompts, served[:, :-1]], 1)
    return cell.reference.logits_at(cell.config, weights, seqs,
                                    prompts.shape[1] - 1, prec)


def run(cell: Cell) -> dict:
    from repro_torch.models import get_model

    from ..trace import traced

    wl = cell.workload
    on_card = torch.device(cell.device).type == "cuda"
    model = get_model(arch_config(cell.config), device=cell.device,
                      attn=wl["attn"])
    weights = cell.weights()
    if on_card:
        torch.cuda.synchronize()
    built = cell.since_start()
    serve_batch(cell, model, weights, -1)        # the cell's own shapes
    wrapped = Wrapped(model, sync_prefill=cell.trace and on_card)
    if on_card:
        torch.cuda.synchronize()
    setup_s = cell.since_start()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    obs = window(cell, wrapped, weights)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    obs.update(config=cell.config, workload=wl, peak_bytes=peak,
               setup_parts={"start to weights": built,
                            "warm-up batch": setup_s - built})
    if wrapped.decode_gaps:
        obs["decode_step_ms"] = 1e3 * sum(wrapped.decode_gaps) \
            / len(wrapped.decode_gaps)
    if wrapped.prefill_s:
        obs["prefill_ms"] = 1e3 * sum(wrapped.prefill_s) \
            / len(wrapped.prefill_s)
    trace = None
    if cell.trace:
        spans = Wrapped(model, sync_prefill=False).as_model()
        trace = traced(lambda: serve_batch(cell, spans, weights,
                                           obs["batches"]))
    obs["trace"] = trace
    kept = obs.pop("kept")
    prompts, served, logits = sample(cell, kept, wl["sample_requests"])
    del kept, wrapped, model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = reference_logits(cell, weights, prompts, served)
    numbers = compare.serve_numbers(served, logits, ref)
    obs["reference_s"] = time.perf_counter() - t0
    requests = obs["batches"] * wl["batch"]
    return {"setup_s": setup_s,
            "end_to_end": {"serve_tok_s": obs["new_tokens"]
                           / obs["window_s"]},
            "attempted": requests, "failed": obs["failed"], "obs": obs,
            "trace": trace,
            "memory_peak_bytes": peak, "numbers": numbers}
