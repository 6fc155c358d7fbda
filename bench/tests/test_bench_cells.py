"""BENCHMARK.json and the files it names: each found by name, each within
the contract's limits."""
from __future__ import annotations

import json
import os
import re

import pytest

from bench_smoke import ROOT, cells

BENCH = cells.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(entry):
    assert NAME.match(entry["name"])
    cfg = cells.load_json(cells.config_file(entry["name"]))
    assert entry["file"] == f"bench/configs/{entry['name']}.json"
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    for key in entry["reduced"]:
        assert key in cfg["published"] or key == "n_layers"
        assert not key.endswith(("_dim", "_rank")) and key != "top_k"
    cells.reference_module(cfg["family"]).layout(cfg)
    assert 1 <= len(entry["why"]) <= 200


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(entry):
    _, config, workload = cells.find(entry["name"])
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert entry["chips"] == 1
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    kind = cells.kind_module(workload["kind"])
    assert callable(kind.run)
    assert set(workload["limits"]) == {
        "train": {"final_norm_grad_gap", "grad_gap_mean", "change_gap"},
        "serve": {"token_gap", "logit_err"}}[workload["kind"]]
    e2e = cells.metrics_of(BENCH, entry["name"], "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert cells.metrics_of(BENCH, entry["name"], "per_layer")


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    assert callable(cells.metric_reader(metric["name"]))
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert metric["source"] in {"device_trace", "program_span",
                                "program_counter", "host_clock"}
    for cell in metric["workloads"]:
        moved = next(m for m in BENCH["end_to_end"]
                     if m["name"] == metric["moves"])
        assert cell in moved.get("workloads", [cell])


def test_metrics_named_once_with_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_every_kind_and_metric_file_is_named():
    """No stray reader or workload file: each is named in BENCHMARK.json."""
    bench_dir = os.path.join(ROOT, "bench")
    metrics = {f[:-3] for f in os.listdir(os.path.join(bench_dir, "metrics"))
               if f.endswith(".py")}
    assert metrics == {m["name"] for m in BENCH["per_layer"]}
    workloads = {f[:-5] for f in os.listdir(os.path.join(bench_dir,
                                                         "workloads"))}
    assert workloads == {w["name"] for w in BENCH["workloads"]}
    configs = {f[:-5] for f in os.listdir(os.path.join(bench_dir, "configs"))}
    assert configs == {c["name"] for c in BENCH["configs"]}
    json.dumps(BENCH)
