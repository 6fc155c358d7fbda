"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds, for the
benchmark's own tests: the configuration's widths replaced by small ones
(its kind, family and every mechanism kept), the traffic shortened."""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import cell as cells  # noqa: E402

WIDTHS = {
    "olmoe-1b-7b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                        d_ff=32, vocab=512, n_experts=8, top_k=2,
                        moe_d_ff=32),
    "stablelm-12b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab=512),
}
TRAFFIC = {"train": dict(seq_len=32),
           "serve": dict(batch=4, prompt_len=24, max_new=4, max_len=28,
                         rows_kept=2, sample_requests=4)}
CELLS = [w["name"] for w in cells.spec()["workloads"]]


def smoke_cell(name: str, dtype: str = "float32", seed: int = 2 ** 31 + 7,
               seconds: float = 0.5, widths: dict | None = None,
               **traffic) -> cells.Cell:
    entry, config, workload = cells.find(name)
    config = {**config, **WIDTHS[entry["config"]], **(widths or {}),
              "param_dtype": dtype, "compute_dtype": dtype}
    workload = {**workload, **TRAFFIC[workload["kind"]], **traffic}
    return cells.Cell(name=name, chips=1, config=config, workload=workload,
                      seed=seed, seconds=seconds, trace=False, device="cpu",
                      started=time.perf_counter())


def run_line(cell: cells.Cell) -> dict:
    """The result line of a run of ``cell`` on the CPU (the look for a
    card skipped)."""
    import torch

    from bench.run import result_line

    bench = cells.spec()
    entry = next(w for w in bench["workloads"] if w["name"] == cell.name)
    out = cells.kind_module(cell.workload["kind"]).run(cell)
    name = torch.cuda.get_device_name
    torch.cuda.get_device_name = lambda *_: "cpu"
    try:
        return result_line(cell, entry, bench, out)
    finally:
        torch.cuda.get_device_name = name
