"""``optim_fused_pct.train``, the share of the optimizer's updated param
elements that its fused kernel took: None where there are no records, the
share of a hand-made record set, and 0 for a traced smoke step on the CPU,
whose leaves all take the eager path."""
from __future__ import annotations

import pytest

from bench_smoke import CELLS, smoke_cell
from bench import cell as cells

NAME = "optim_fused_pct.train"


@pytest.fixture
def tracing():
    from repro_torch import tracing

    tracing.reset()
    yield tracing
    tracing.reset()


def test_reader_gives_none_without_records(tracing):
    assert tracing.records() == {"spans": {}, "counters": {}}
    assert cells.metric_reader(NAME)({}) is None


@pytest.mark.parametrize("fused, want", [(3_000, 75.0), (4_000, 100.0),
                                         (0, 0.0)])
def test_reader_values_from_hand_made_records(tracing, monkeypatch, fused,
                                              want):
    counters = {"optim.elems": 4_000, "optim.fused_elems": fused}
    monkeypatch.setattr(tracing, "records",
                        lambda: {"spans": {}, "counters": counters})
    assert cells.metric_reader(NAME)({}) == pytest.approx(want)


def test_share_of_a_traced_smoke_step_on_the_cpu(tracing):
    """The program's counters under a CPU profiler, as a traced window
    turns them on: every param element counted once a step, none fused."""
    from torch.profiler import ProfilerActivity, profile

    from bench.kinds import train
    from repro_torch.tree import tree_leaves

    cell = smoke_cell(CELLS[0])
    prog = train.build(cell)
    with profile(activities=[ProfilerActivity.CPU]):
        train.step(prog, cell)
    counts = tracing.records()["counters"]
    assert counts["optim.elems"] == sum(t.numel() for t in
                                        tree_leaves(prog.params))
    assert cells.metric_reader(NAME)({}) == 0.0
