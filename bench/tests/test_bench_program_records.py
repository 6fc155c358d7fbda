"""The per-layer metrics read from the program's own spans and counters
(``repro_torch.tracing``): None where there are no records or no such
module, and the values of a hand-made record set."""
from __future__ import annotations

import sys

import pytest

from bench_smoke import CELLS, smoke_cell
from bench import cell as cells

READERS = ("decode_enqueue_ms.serve", "decode_wait_ms.serve",
           "moe_dispatch_ms.train", "moe_drop_pct.train")


def _span(calls, host_s, device_self_s=None):
    return {"calls": calls, "host_s": host_s, "self_s": host_s,
            "device_s": device_self_s, "device_self_s": device_self_s,
            "parents": [None]}


RECORDS = {
    "spans": {
        "serve.decode": _span(16, 0.8),
        "serve.readback": _span(16, 0.08),
        "train.step": _span(3, 1.8, 1.8),
        "moe.route": _span(48, 0.1, 0.012),
        "moe.dispatch": _span(48, 0.1, 0.03),
        "moe.experts": _span(48, 0.1, 5.0),
        "moe.combine": _span(48, 0.1, 0.06),
        "moe.combine.bwd": _span(24, 0.1, 0.45),
        "moe.dispatch.bwd": _span(24, 0.1, 0.03),
        "moe.route.bwd": _span(24, 0.1, 0.018),
    },
    "counters": {"moe.assignments": 786400, "moe.dropped": 7864},
}
WANT = {"decode_enqueue_ms.serve": 50.0, "decode_wait_ms.serve": 5.0,
        "moe_dispatch_ms.train": 200.0, "moe_drop_pct.train": 1.0}


@pytest.fixture
def tracing():
    from repro_torch import tracing

    tracing.reset()
    yield tracing
    tracing.reset()


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_without_records(name, tracing):
    assert tracing.records() == {"spans": {}, "counters": {}}
    assert cells.metric_reader(name)({}) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_for_a_program_without_tracing(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert cells.metric_reader(name)({}) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_values_from_hand_made_records(name, tracing, monkeypatch):
    monkeypatch.setattr(tracing, "records", lambda: RECORDS)
    assert cells.metric_reader(name)({}) == pytest.approx(WANT[name])


def test_dispatch_time_needs_the_card(tracing, monkeypatch):
    spans = {**RECORDS["spans"], "moe.route": _span(48, 0.1)}
    monkeypatch.setattr(tracing, "records",
                        lambda: {**RECORDS, "spans": spans})
    assert cells.metric_reader("moe_dispatch_ms.train")({}) is None


def test_drop_share_of_a_traced_smoke_step(tracing):
    """The program's counters under a CPU profiler, as a traced window
    turns them on: assignments T*k a layer, some dropped at a small
    capacity."""
    from torch.profiler import ProfilerActivity, profile

    from bench.kinds import train

    cell = smoke_cell(CELLS[0])
    cell.config["capacity_factor"] = 0.25
    prog = train.build(cell)
    with profile(activities=[ProfilerActivity.CPU]):
        train.step(prog, cell)
    counts = tracing.records()["counters"]
    wl, cfg = cell.workload, cell.config
    assert counts["moe.assignments"] == \
        cfg["n_layers"] * wl["batch"] * wl["seq_len"] * cfg["top_k"]
    share = cells.metric_reader("moe_drop_pct.train")({})
    assert 0 < share < 100
    assert cells.metric_reader("moe_dispatch_ms.train")({}) is None
    assert tracing.records()["spans"]["train.step"]["calls"] == 1
