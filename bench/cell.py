"""A cell of ``BENCHMARK.json``, found by name: its configuration file,
its workload file, its kind's module and its per-layer metrics' readers.

Everything a cell needs is named by data: ``BENCHMARK.json`` gives the
cell's configuration and traffic, ``bench/configs/<config>.json`` the
model as it is run, ``bench/workloads/<cell>.json`` the traffic and the
comparison's limits, and the workload's ``kind`` names
``bench/kinds/<kind>.py``; each per-layer metric is read by
``bench/metrics/<metric>.py``.  A later cell, configuration, kind or
metric is a new file and a new entry, never an edit.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def config_file(name: str) -> Path:
    return BENCH / "configs" / f"{name}.json"


def workload_file(name: str) -> Path:
    return BENCH / "workloads" / f"{name}.json"


def kind_module(kind: str):
    return importlib.import_module(f"bench.kinds.{kind}")


def reference_module(family: str):
    return importlib.import_module(f"bench.reference.{family}")


def metric_reader(name: str):
    """The ``read(obs)`` of ``bench/metrics/<name>.py`` (a metric's name
    may hold dots, so the file is loaded by its path)."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Cell:
    """One cell as a run sees it."""
    name: str
    chips: int
    config: dict       # the configuration file's keys
    workload: dict     # the workload file's keys
    seed: int
    seconds: float
    trace: bool
    device: str
    started: float     # perf_counter of the process's start

    def since_start(self) -> float:
        return time.perf_counter() - self.started

    @property
    def reference(self):
        return reference_module(self.config["family"])

    def weights(self) -> dict:
        """The weights both sides take, made on the device from the seed."""
        from .params import for_workload

        return for_workload(self.reference.layout(self.config),
                            self.workload, self.seed, self.device)


def find(name: str, bench: dict | None = None) -> tuple[dict, dict, dict]:
    """(the cell's BENCHMARK.json entry, its configuration, its workload)."""
    bench = bench if bench is not None else spec()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; "
                       f"cells: {sorted(cells)}")
    entry = cells[name]
    config = load_json(config_file(entry["config"]))
    workload = load_json(workload_file(name))
    if workload["traffic"] != entry["traffic"]:
        raise ValueError(f"{workload_file(name)} holds traffic "
                         f"{workload['traffic']!r}, BENCHMARK.json "
                         f"{entry['traffic']!r}")
    return entry, config, workload


def arch_config(config: dict):
    """The program's ``ArchConfig`` of a configuration file: every key
    that names one of its fields."""
    from repro_torch.models.config import ArchConfig

    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in config.items() if k in fields}
    return ArchConfig(**kw)


def metrics_of(bench: dict, cell: str, table: str) -> list[dict]:
    """The metrics of ``table`` ("end_to_end" or "per_layer") a cell
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[table] if cell in m.get("workloads", [cell])]
