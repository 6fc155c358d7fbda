"""The port's own spans and counters (``repro_torch.tracing``) on the CPU.

Tracing is on only under ``torch.profiler``: without it nothing is
recorded, and a traced run computes the same bits as an untraced one.
Under the profiler the serving loop records its prefill, each decode
step's enqueue (a batch's first apart) and each token's read back, the train step its step,
forward and backward, and update, and the MoE layer its four stages
forward and backward, with the assignments it routed and dropped counted
once a forward, activation checkpointing's recompute included.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.launch.serve import serve
from repro_torch.models import get_model, moe
from repro_torch.optim import adamw
from repro_torch.runtime import make_loss_with_accum, make_train_step

SERVE = dict(batch=2, max_new=3, max_len=12)
PROMPT, REQUESTS = 8, 4
STAGES = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


@pytest.fixture(autouse=True)
def fresh_records():
    tracing.reset()
    yield
    tracing.reset()


def _traced(fn):
    """(fn's result, the profiler's events) with fn run under the
    profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _span_events(events):
    return [e for e in events if e.name.startswith(("serve.", "train.",
                                                     "moe."))]


def _serve_run(arch="stablelm-12b"):
    """A SMOKE serve of ``REQUESTS`` prompts: (its tokens, every logits the
    model returned, in order)."""
    cfg = get_config(arch, smoke=True)
    model = get_model(cfg, device="cpu")
    params = model.init_params(0)
    seen = []

    def keep(fn):
        def call(*args):
            logits, cache = fn(*args)
            seen.append(logits.clone())
            return logits, cache
        return call

    wrapped = dataclasses.replace(model, prefill=keep(model.prefill),
                                  decode_step=keep(model.decode_step))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab, PROMPT) for _ in range(REQUESTS)]
    outs, _ = serve(wrapped, params, prompts, **SERVE)
    return outs, seen


def _olmoe(capacity_factor=0.25, remat=True):
    cfg = get_config("olmoe-1b-7b", smoke=True).replace(
        capacity_factor=capacity_factor, remat=remat)
    model = get_model(cfg, device="cpu")
    tokens = torch.randint(2, cfg.vocab, (4, 64),
                           generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    return cfg, model, model.init_params(0), batch


def _grads(model, params, batch):
    return make_loss_with_accum(model.loss_fn, 1)(params, batch)


def test_tracing_off_records_nothing_and_traced_numbers_are_bit_equal(
        monkeypatch):
    outs, logits = _serve_run()
    cfg, model, params, batch = _olmoe()
    loss, grads = _grads(model, params, batch)
    assert tracing.records() == {"spans": {}, "counters": {}}

    (t_outs, t_logits), _ = _traced(_serve_run)
    (t_loss, t_grads), _ = _traced(lambda: _grads(model, params, batch))
    assert tracing.records()["spans"]
    assert all(np.array_equal(a, b) for a, b in zip(outs, t_outs))
    assert len(logits) == len(t_logits)
    assert all(torch.equal(a, b) for a, b in zip(logits, t_logits))
    assert torch.equal(loss, t_loss)
    for a, b in zip(torch.utils._pytree.tree_leaves(grads),
                    torch.utils._pytree.tree_leaves(t_grads)):
        assert torch.equal(a, b)

    # with tracing's check off, the profiler sees none of the spans
    tracing.reset()
    monkeypatch.setattr(tracing, "on", lambda: False)
    _, events = _traced(_serve_run)
    (o_loss, _), more = _traced(lambda: _grads(model, params, batch))
    assert _span_events(list(events) + list(more)) == []
    assert tracing.records() == {"spans": {}, "counters": {}}
    assert torch.equal(loss, o_loss)


def _inside(outer, inner) -> bool:
    return outer.thread == inner.thread and \
        outer.time_range.start <= inner.time_range.start and \
        inner.time_range.end <= outer.time_range.end


def test_serve_spans_once_a_prefill_and_a_step_around_their_ops():
    (outs, _), events = _traced(_serve_run)
    steps = sum(o.shape[1] - 1 for o in outs)
    spans = tracing.records()["spans"]
    assert spans["serve.prefill"]["calls"] == len(outs)
    assert spans["serve.first_decode"]["calls"] == len(outs)
    assert spans["serve.decode"]["calls"] == steps - len(outs)
    assert spans["serve.readback"]["calls"] == steps
    assert spans["serve.decode"]["parents"] == [None]
    for name, op in (("serve.prefill", "aten::argmax"),
                     ("serve.first_decode", "aten::argmax"),
                     ("serve.decode", "aten::argmax"),
                     ("serve.readback", "aten::to")):
        outer = [e for e in events if e.name == name]
        ops = [e for e in events if e.name == op]
        assert len(outer) == spans[name]["calls"]
        assert all(any(_inside(o, e) for e in ops) for o in outer), name
    for s in spans.values():
        assert s["device_s"] is None
        assert 0 <= s["self_s"] <= s["host_s"]


@pytest.mark.parametrize("blocks", [1, 2])
def test_moe_counts_dropped_assignments(blocks):
    cfg, _, params, _ = _olmoe()
    x = torch.randn(4, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    cfg = cfg.replace(moe_block_tokens=4 * 64 // blocks)
    p = params["layers"][0]["ffn"]
    _traced(lambda: moe.moe_ffn(cfg, p, x))
    kept = int(moe.kept_assignments(cfg, p, x).sum())
    t_k = 4 * 64 * cfg.top_k
    assert tracing.records()["counters"] == {"moe.assignments": t_k,
                                             "moe.dropped": t_k - kept}
    assert kept < t_k
    spans = tracing.records()["spans"]
    assert all(spans[s]["calls"] == blocks for s in STAGES)


def test_remat_counts_each_forward_once():
    counts, spans = {}, {}
    for remat in (True, False):
        cfg, model, params, batch = _olmoe(remat=remat)
        tracing.reset()
        _traced(lambda: _grads(model, params, batch))
        counts[remat] = tracing.records()["counters"]
        spans[remat] = tracing.records()["spans"]
    n = cfg.n_layers - cfg.first_dense
    assert counts[True] == counts[False]
    assert counts[True]["moe.assignments"] == n * 4 * 64 * cfg.top_k
    assert counts[True]["moe.dropped"] > 0
    for s in STAGES:
        assert spans[True][s]["calls"] == 2 * n      # forward and recompute
        assert spans[False][s]["calls"] == n
        assert spans[True][s + ".bwd"]["calls"] == n
        assert spans[False][s + ".bwd"]["calls"] == n
    # the recompute runs inside a backward span, as a span of its own
    assert spans[True]["moe.layer"]["calls"] == 2 * cfg.n_layers
    assert "moe.combine.bwd" in spans[True]["moe.layer"]["parents"]


def test_combine_gather_backward_inside_combine_bwd():
    """The backward of the combine's gather of the expert outputs
    (``IndexBackward0``, by its forward op's sequence number) falls inside
    ``moe.combine.bwd``; those of the dispatch's and the router's gathers
    fall outside it."""
    cfg, model, params, batch = _olmoe(remat=False)
    _, events = _traced(lambda: _grads(model, params, batch))
    events = list(events)
    combine = [e for e in events if e.name == "moe.combine"]
    bwd = [e for e in events if e.name == "moe.combine.bwd"]
    fwd_index = [e for e in events if e.name == "aten::index"
                 and e.sequence_nr >= 0]
    ours = {e.sequence_nr for e in fwd_index
            if any(_inside(c, e) for c in combine)}
    others = {e.sequence_nr for e in fwd_index} - ours
    back = [e for e in events
            if e.name == "autograd::engine::evaluate_function: IndexBackward0"]
    assert len(ours) == len(bwd) == cfg.n_layers - cfg.first_dense
    mine = [e for e in back if e.sequence_nr in ours]
    rest = [e for e in back if e.sequence_nr in others]
    assert len(mine) == len(ours) and rest
    assert all(any(_inside(b, e) for b in bwd) for e in mine)
    assert not any(any(_inside(b, e) for b in bwd) for e in rest)


def test_train_step_spans():
    cfg, model, params, batch = _olmoe()
    opt = adamw(1e-3)
    step = make_train_step(model.loss_fn, opt, microbatches=2)
    _traced(lambda: step(params, opt.init(params), batch))
    spans = tracing.records()["spans"]
    assert spans["train.step"]["calls"] == 1
    assert spans["train.grad"]["calls"] == 2
    assert spans["train.update"]["calls"] == 1
    assert spans["train.grad"]["parents"] == ["train.step"]
    assert spans["train.update"]["parents"] == ["train.step"]
    assert spans["train.step"]["self_s"] < spans["train.step"]["host_s"]


class _Event:
    """A CUDA timing event on a card whose clock the test sets: it reads
    the time at ``record`` and is reached once ``now[0]`` has passed it."""

    made = 0

    def __init__(self, now, enable_timing=True):
        self.now, self.t = now, None
        _Event.made += 1

    def record(self, stream=None):
        self.t = self.now[0]

    def query(self):
        return self.t < self.now[0]

    def elapsed_time(self, other):
        return other.t - self.t


def _fake_card(monkeypatch):
    """The card's clock (ms), with ``torch.cuda``'s events and synchronise
    stubbed on it; a span timed on the stub stream."""
    from types import SimpleNamespace as NS

    now = [0.0]
    _Event.made = 0
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda enable_timing=False: _Event(now))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: now.__setitem__(0, 1e9))
    stream = NS(device=torch.device("cuda", 0))
    return now, lambda name: tracing._Span(name, stream)


def test_timed_spans_fold_as_the_card_reaches_them(monkeypatch):
    """A long profile holds a bounded number of timed spans: past
    ``FOLD_AT`` those the card has reached are read into sums, their
    events reused; the sums, and a span's self time less the timed span
    inside it, are those of reading all at once."""
    now, span = _fake_card(monkeypatch)
    monkeypatch.setattr(tracing, "FOLD_AT", 8)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(100):
            with span("moe.layer"):
                now[0] += 1.0
                with span("moe.route"):
                    now[0] += 2.0
                now[0] += 0.5
        now[0] += 1.0
        assert len(tracing._STORE.pending) < 8
    assert _Event.made <= 2 * 8 + 4
    spans = tracing.records()["spans"]
    assert spans["moe.route"]["calls"] == 100
    assert spans["moe.route"]["device_s"] == pytest.approx(0.2)
    assert spans["moe.layer"]["device_s"] == pytest.approx(0.35)
    assert spans["moe.layer"]["device_self_s"] == pytest.approx(0.15)
    assert spans["moe.route"]["parents"] == ["moe.layer"]


def test_a_span_waits_for_the_timed_spans_inside_it(monkeypatch):
    """A span the card has reached is not read before the spans inside
    it are: its self time needs theirs."""
    now, span = _fake_card(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]):
        with span("moe.layer") as outer:
            with span("moe.route"):
                now[0] += 2.0
            now[0] += 1.0
        inner = tracing._STORE.pending[0]
        inner.end.t = now[0] + 5.0        # not reached yet
        now[0] += 1.0
        tracing._STORE.fold(wait=False)
        assert tracing._STORE.pending == [inner, outer.timed]
        now[0] += 10.0
        tracing._STORE.fold(wait=False)
        assert tracing._STORE.pending == []


def test_tensor_counts_fold_into_one(monkeypatch):
    monkeypatch.setattr(tracing, "FOLD_AT", 4)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(10):
            tracing.count("moe.dropped", torch.tensor([i, 1]))
            tracing.count("moe.assignments", 2)
        assert len(tracing._STORE.tensors["moe.dropped"]) < 4
    assert tracing.records()["counters"] == {"moe.dropped": 55,
                                             "moe.assignments": 20}
