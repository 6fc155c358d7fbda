"""Readings that set a cell's limits, at the cell's own size, on several
seeds in one process (not run by the benchmark's runs).

    python bench/control.py --workload <cell> --seeds 11,12,13

For every seed it prints one JSON line of the numbers that decide
``correct`` (``compare``), for each side against the f32 reference:

* ``program``: the timed path (the lower readings);
* ``control``: the reference computed with every product's operands in
  float8 e4m3, the precision below the configuration's bf16 (an upper
  reading);
* training only, ``control_layers``: the same with the head's product
  left in f32, so that only the layers' products are rounded;
* training only, ``half_batch``: the reference taking half of each
  batch's rows, the mean over the rest, a fault a step can have (an upper
  reading where it reads ten times the lower one or more).

A serve cell keeps ``sample_requests`` rows of its first batch, so one
batch gives as many requests as a run compares; the control reads, at
each served position, the reference's gap of the token the float8
forward puts first.
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402

# a serve seed's window: one batch, which keeps every row
SECONDS = 1.0


def _clean(numbers: dict) -> dict:
    return {k: {"value": v, "where": w} for k, (v, w) in numbers.items()}


def _peak_gib() -> float:
    import torch

    if not torch.cuda.is_available():
        return 0.0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    return peak


def train_seed(cell) -> dict:
    from bench import compare
    from bench.kinds import train
    from bench.reference.common import FP8_LAYERS, FP8_PRECISION

    prog = train.build(cell)
    raw = {"program": train.first_steps(prog, cell)}
    train.free(prog)
    peaks = {"program": _peak_gib()}
    raw["reference"] = train.reference(cell)
    peaks["reference"] = _peak_gib()
    raw["control"] = train.reference(cell, FP8_PRECISION)
    peaks["control"] = _peak_gib()
    raw["control_layers"] = train.reference(cell, FP8_LAYERS)
    raw["half_batch"] = train.reference(
        cell, rows=slice(0, cell.workload["batch"] // 2))
    out = {k: _clean(compare.train_numbers(
        raw[k], raw["reference"], cell.workload["final_norm_leaf"]))
        for k in ("program", "control", "control_layers", "half_batch")}
    # every side's losses and leaf norms, for numbers worked out later
    return {**out, "peak_gib": peaks, "raw": raw}


def serve_seed(cell) -> dict:
    import torch

    from bench import compare
    from bench.kinds import serve
    from bench.reference.common import FP8_PRECISION
    from repro_torch.models import get_model

    from bench.cell import arch_config

    wl = cell.workload
    model = get_model(arch_config(cell.config), device=cell.device,
                      attn=wl["attn"])
    weights = cell.weights()
    obs = serve.window(cell, serve.Wrapped(model, False), weights)
    prompts, served, logits = serve.sample(cell, obs["kept"],
                                           wl["sample_requests"])
    del obs, model
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    ref = serve.reference_logits(cell, weights, prompts, served)
    out = {"program": compare.serve_numbers(served, logits, ref)}
    low = serve.reference_logits(cell, weights, prompts, served,
                                 FP8_PRECISION)
    out["control"] = compare.serve_numbers(low.argmax(-1), low, ref)
    return {k: _clean(v) for k, v in out.items()}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    args = ap.parse_args(argv)

    import torch

    from bench import cell as cells

    entry, config, workload = cells.find(args.workload)
    if workload["kind"] == "serve":
        workload = {**workload, "rows_kept": min(workload["batch"],
                                                 workload["sample_requests"])}
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"control.{args.workload}.jsonl")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = cells.Cell(name=entry["name"], chips=entry["chips"],
                          config=config, workload=workload, seed=seed,
                          seconds=SECONDS, trace=False, device="cuda",
                          started=t0)
        fn = train_seed if workload["kind"] == "train" else serve_seed
        line = {"seed": seed, **fn(cell),
                "seconds": time.perf_counter() - t0,
                "device": torch.cuda.get_device_name(0)}
        print(json.dumps(line), flush=True)
        with open(path, "a") as f:
            f.write(json.dumps(line) + "\n")
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
