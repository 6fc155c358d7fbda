"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  It makes the cell's weights and traffic from
the seed, warms up the cell's own shapes (set-up), measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints, as the last line of its standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``: each number compared beside its limit, also printed as the
last lines of standard error.  It exits non-zero, and prints no result,
where there is no CUDA card or fewer than the cell asks for, or where the
JAX package or JAX itself was loaded.
"""
from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The ``perf_counter`` reading at which this process started."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


STARTED = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program builds its kernel libraries into build/kernels/ of this
# checkout, a fixed path, so only a checkout's first run builds them
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import argparse  # noqa: E402
import json  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, as a whole, is JAX's, flax's
    or the JAX package's (``repro_torch`` is none of them)."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def result_line(cell, entry: dict, bench: dict, out: dict) -> dict:
    from bench import cell as cells, compare

    ok, checks = compare.judged(out["numbers"], cell.workload["limits"])
    if cell.trace:
        metrics = {}
        for m in cells.metrics_of(bench, entry["name"], "per_layer"):
            value = cells.metric_reader(m["name"])(out["obs"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": out["setup_s"], **out["end_to_end"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cells.metrics_of(bench, entry["name"],
                                             "end_to_end")}
    import torch

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": entry["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": ok and out["failed"] == 0 and out["attempted"] > 0,
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    trace = out["trace"]
    if cell.trace and trace is not None:
        device.update(busy_s=trace.busy_s, window_s=trace.window_s)
        line["breakdown"] = trace.breakdown()
    line["checks"] = checks
    return line


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench import cell as cells

    bench = cells.spec()
    entry, config, workload = cells.find(args.workload, bench)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"[bench] {args.workload} needs {entry['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    imported = time.perf_counter() - STARTED
    torch.cuda.init()
    torch.empty(1, device="cuda")
    cuda_ready = time.perf_counter() - STARTED
    # the load comes from this one process; its host work is dispatch,
    # which no pool of CPU threads speeds up
    torch.set_num_threads(1)
    cell = cells.Cell(name=entry["name"], chips=entry["chips"],
                      config=config, workload=workload, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      device="cuda", started=STARTED)
    out = cells.kind_module(workload["kind"]).run(cell)
    bad = forbidden_modules()
    if bad:
        print(f"[bench] the run loaded {bad}: the benchmark and the program "
              f"it measures must not load JAX or the JAX package",
              file=sys.stderr)
        return 3
    line = result_line(cell, entry, bench, out)
    parts = ", ".join(f"{k} {v:.1f} s" for k, v in
                      [("imports", imported), ("CUDA", cuda_ready)]
                      + list(out["obs"].get("setup_parts", {}).items()))
    units = sorted(out["obs"].get("unit_s", [0.0]))
    print(f"[bench] {len(units)} units of the window: min {units[0]:.4f} "
          f"median {units[len(units) // 2]:.4f} max {units[-1]:.4f} s",
          file=sys.stderr)
    print(f"[bench] set-up {out['setup_s']:.1f} s ({parts}), window "
          f"{out['obs']['window_s']:.1f} s, reference "
          f"{out['obs'].get('reference_s', 0):.1f} s", file=sys.stderr)
    for name, (value, where) in out["numbers"].items():
        if name not in line["checks"]:
            print(f"[bench] not compared: {name} {value!r} ({where})",
                  file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r} "
              f"({c['where']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
