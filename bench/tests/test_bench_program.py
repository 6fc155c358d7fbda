"""The benchmark against the program at a size the CPU holds: its weights
have the program's tree, its reference computes the program's function,
and each kind runs a cell end to end."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from bench_smoke import CELLS, cells, run_line, smoke_cell
from bench import compare, params as bench_params
from bench.reference.common import FP8_PRECISION, paths


def _program_tree(config: dict, device: str = "cpu"):
    from repro_torch.models import get_model

    model = get_model(cells.arch_config(config), device=device)
    return model.init_params(0)


@pytest.mark.parametrize("name", CELLS)
def test_init_writes_the_programs_tree(name):
    cell = smoke_cell(name, dtype="bfloat16")
    ours = bench_params.make(cell.reference.layout(cell.config), 1, "cpu")
    theirs = _program_tree(cell.config)
    a = {p: (tuple(t.shape), t.dtype) for p, t in paths(ours)}
    b = {p: (tuple(t.shape), t.dtype) for p, t in paths(theirs)}
    assert a == b


@pytest.mark.parametrize("name", CELLS)
def test_init_writes_the_programs_tree_at_full_size(name):
    from torch._subclasses.fake_tensor import FakeTensorMode

    _, config, _ = cells.find(name)
    with FakeTensorMode():
        theirs = _program_tree(config)
        b = {p: (tuple(t.shape), t.dtype) for p, t in paths(theirs)}
    layout = cells.reference_module(config["family"]).layout(config)
    assert {p: (tuple(s), getattr(torch, d)) for p, s, d, _ in layout} == b


def test_same_seed_same_weights_other_seed_other_weights():
    cell = smoke_cell(CELLS[0])
    layout = cell.reference.layout(cell.config)
    a, b, c = (bench_params.make(layout, s, "cpu") for s in (5, 5, 2 ** 31 + 9))
    for (_, x), (_, y), (_, z) in zip(paths(a), paths(b), paths(c)):
        assert torch.equal(x, y)
        if x.std() > 0:
            assert not torch.equal(x, z)


@pytest.mark.parametrize("name", CELLS)
def test_kind_runs_a_cell_and_is_correct(name):
    line = run_line(smoke_cell(name))
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) >= {"setup_s"}
    assert list(line)[-1] == "checks"
    # float32 on both sides: the reference computes the program's function
    for name_, c in line["checks"].items():
        assert c["value"] < 1e-4, (name_, c)


def _train_numbers(cell, prec=None, rows=slice(None)):
    from bench.kinds import train

    prog = train.build(cell)
    got = train.first_steps(prog, cell)
    train.free(prog)
    ref = train.reference(cell)
    if prec is not None:
        got = train.reference(cell, prec, rows)
    return compare.train_numbers(got, ref, cell.workload["final_norm_leaf"])


def test_float8_control_fails_the_train_limits():
    """In bf16 the program reads closer to the reference than the
    reference itself computed with float8 products (the control), which
    fails the cell's limits."""
    cell = smoke_cell(CELLS[0], dtype="bfloat16")
    prog = _train_numbers(cell)
    ctrl = _train_numbers(cell, FP8_PRECISION)
    for name in cell.workload["limits"]:
        assert ctrl[name][0] > prog[name][0], name
    ok, _ = compare.judged(ctrl, cell.workload["limits"])
    assert not ok


def test_float8_control_fails_the_serve_limits():
    """At 16 layers of heads of 160 (the cell's head size), the control's
    rounding grows through the depth as at the cell's own size."""
    from bench.kinds import serve

    deep = dict(n_layers=16, d_model=320, n_heads=2, n_kv_heads=1,
                d_ff=864, vocab=4096)
    cell = smoke_cell(CELLS[1], dtype="bfloat16", widths=deep, rows_kept=4,
                      prompt_len=64, max_len=68)
    from repro_torch.models import get_model

    model = get_model(cells.arch_config(cell.config), device="cpu")
    weights = bench_params.make(cell.reference.layout(cell.config),
                                cell.seed, "cpu")
    obs = serve.window(cell, serve.Wrapped(model, False), weights)
    prompts, served, logits = serve.sample(cell, obs["kept"], 4)
    ref = serve.reference_logits(cell, weights, prompts, served)
    low = serve.reference_logits(cell, weights, prompts, served,
                                 FP8_PRECISION)
    prog = compare.serve_numbers(served, logits, ref)
    ctrl = compare.serve_numbers(low.argmax(-1), low, ref)
    assert ctrl["logit_err"][0] > 3 * prog["logit_err"][0]
    assert compare.judged(prog, cell.workload["limits"])[0]
    assert not compare.judged(ctrl, cell.workload["limits"])[0]


# --- faults planted under the timed path: each must read not correct ---


def _patch_step(monkeypatch, wrap):
    import repro_torch.runtime as runtime

    real = runtime.make_train_step
    monkeypatch.setattr(runtime, "make_train_step",
                        lambda *a, **k: wrap(real(*a, **k)))


def test_fault_step_returns_state_unchanged(monkeypatch):
    def wrap(step):
        def same(params, state, batch):
            _, _, m = step(params, state, batch)
            return params, state, m
        return same
    _patch_step(monkeypatch, wrap)
    line = run_line(smoke_cell(CELLS[0]))
    assert line["correct"] is False
    assert line["checks"]["change_gap"]["value"] > 0.5


def test_fault_half_of_the_batch_left_out(monkeypatch):
    import repro_torch.models as models

    real = models.get_model

    def half(*a, **k):
        m = real(*a, **k)
        def loss_fn(params, batch):
            n = batch["tokens"].shape[0] // 2
            return m.loss_fn(params, {k_: v[:n] for k_, v in batch.items()})
        return dataclasses.replace(m, loss_fn=loss_fn)
    monkeypatch.setattr(models, "get_model", half)
    line = run_line(smoke_cell(CELLS[0]))
    assert line["correct"] is False


def test_fault_token_altered_where_produced(monkeypatch):
    import repro_torch.models as models

    real = models.get_model

    def altered(*a, **k):
        m = real(*a, **k)
        def decode_step(params, tok, cache):
            logits, cache = m.decode_step(params, tok, cache)
            logits = logits.clone()
            rows = torch.arange(logits.shape[0])
            second = logits.topk(2, -1).indices[:, 1]
            logits[rows, second] = logits.amax(-1) + 1.0
            return logits, cache
        return dataclasses.replace(m, decode_step=decode_step)
    monkeypatch.setattr(models, "get_model", altered)
    line = run_line(smoke_cell(CELLS[1]))
    assert line["correct"] is False
    assert line["checks"]["token_gap"]["value"] > 0


def test_relabelled_draw_changes_the_labels_and_keeps_the_function():
    """A ``relabelled`` cell takes one draw of weights and batches for
    every seed, relabelled by the seed: other expert weights, other token
    ids, the same loss."""
    from bench import traffic
    from bench.reference.common import F32_PRECISION

    cell = smoke_cell(CELLS[0], relabelled=True)
    cells_ = [dataclasses.replace(cell, seed=s) for s in (5, 2 ** 31 + 9)]
    a, b = (c.weights() for c in cells_)
    moved = {p[-2] if p[0] == "embed" else p[2] for (p, x), (_, y)
             in zip(paths(a), paths(b)) if not torch.equal(x, y)}
    assert moved == {"embed", "ffn"}
    assert torch.equal(cells_[0].weights()["embed"]["tokens"],
                       a["embed"]["tokens"])
    batches = [traffic.train_batch(c.workload, c.config, c.seed, 1, "cpu")
               for c in cells_]
    assert not torch.equal(batches[0]["tokens"], batches[1]["tokens"])
    la, lb = (cell.reference.loss(cell.config, w, bt["tokens"],
                                  bt["targets"], F32_PRECISION)
              for w, bt in zip((a, b), batches))
    assert abs(float(la) - float(lb)) < 1e-5


def test_layers_control_leaves_the_head_in_f32():
    from bench.reference.common import FP8_LAYERS

    a, b = torch.randn(8, 16), torch.randn(16, 4)
    assert torch.equal(FP8_LAYERS.head_mm(a, b), a @ b)
    assert not torch.equal(FP8_LAYERS.mm(a, b), a @ b)
    assert not torch.equal(FP8_PRECISION.head_mm(a, b), a @ b)


def test_serve_sample_spreads_over_every_slot():
    from bench.kinds import serve

    cell = smoke_cell(CELLS[1], batch=4, rows_kept=1)
    kept = []
    for i in range(6):
        b = serve.Kept(serve._rows(cell, i))
        b.prompts = torch.zeros(1, 3, dtype=torch.long)
        b.logits = [torch.full((1, 5), float(i))] * 2
        b.served = torch.zeros(1, 2, dtype=torch.long).numpy()
        kept.append(b)
    assert sorted(b.rows[0] for b in kept[:4]) == [0, 1, 2, 3]
    _, _, logits = serve.sample(cell, kept, 4)
    slots = {kept[int(x)].rows[0] for x in logits[:, 0, 0]}
    assert slots == {0, 1, 2, 3}


def test_fault_non_finite_logits_count_as_failed(monkeypatch):
    import repro_torch.models as models

    real = models.get_model

    def nan_row(*a, **k):
        m = real(*a, **k)
        def decode_step(params, tok, cache):
            logits, cache = m.decode_step(params, tok, cache)
            logits = logits.clone()
            logits[-1, 0] = float("nan")
            return logits, cache
        return dataclasses.replace(m, decode_step=decode_step)
    monkeypatch.setattr(models, "get_model", nan_row)
    line = run_line(smoke_cell(CELLS[1]))
    assert line["failed"] > 0
    assert line["correct"] is False
