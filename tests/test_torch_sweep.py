"""The port's sweep coordinator (``repro_torch.core.sweep``), its CLI
(``python -m repro_torch.sweep``), ``compile_many(parallel=N)`` and the
registry facade (``repro_torch.targets``).

The first part holds the port against the reference in one process, on
the reference tests' own plan (``tests/test_sweep.py``): plan labels and
shard sizes, per-(layer, target, opt) cycles and statuses of a serial and
a 2-worker process sweep, the per-layer winners and the summary counts.
Keys are left out of the comparison: a store entry carries its
compiler's signature, so each package reads the other's entries as
stale.  The second part covers, for the port alone, each behaviour the
reference's sweep tests cover.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest

import repro
import repro_torch
from repro.core import sweep as ref_sweep
from repro.core.store import ArtifactStore as RefStore
from repro_torch.core import sweep as sweep_mod
from repro_torch.core.store import ArtifactStore
from repro_torch.core.sweep import (SweepReport, UnitResult, expand_plan,
                                    partition, plan_id, run_external_worker)

pytestmark = pytest.mark.sweep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = ["DLRM-FC2", "DLRM-FC3", "DLRM-FC4"]
VARIANTS = ["dnnweaver@pe=32x32", "dnnweaver@pe=16x16"]


@pytest.fixture
def store(tmp_path):
    repro_torch.clear_cache()
    yield ArtifactStore(str(tmp_path / "store"))
    repro_torch.clear_cache()


def _labels(units) -> list[tuple]:
    return [(u.layer, u.target, u.opt) for u in units]


def _by_label(report) -> dict:
    return {(r.layer, r.target, r.opt): (r.status, r.cycles)
            for r in report.results}


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("searches", [None, "axis"])
@pytest.mark.parametrize("workers", [1, 2, 4, 9])
def test_plan_and_partition_match_reference(searches, workers):
    if searches:
        axis = [None, dict(generations=2, population=4, seed=0)]
        mine = [s and repro_torch.SearchOptions(**s) for s in axis]
        theirs = [s and repro.SearchOptions(**s) for s in axis]
    else:
        mine = theirs = None
    a = expand_plan(LAYERS, VARIANTS, searches=mine)
    b = ref_sweep.expand_plan(LAYERS, VARIANTS, searches=theirs)
    assert _labels(a) == _labels(b)
    assert [len(s) for s in partition(a, workers)] == \
        [len(s) for s in ref_sweep.partition(b, workers)]


@pytest.mark.parametrize("workers", [1, 2])
def test_sweep_matches_reference(tmp_path, workers):
    repro.clear_cache()
    repro_torch.clear_cache()
    mine = repro_torch.sweep(LAYERS, VARIANTS, workers=workers,
                             store=ArtifactStore(str(tmp_path / "port")))
    theirs = repro.sweep(LAYERS, VARIANTS, workers=workers,
                         store=RefStore(str(tmp_path / "ref")))
    assert mine.backend == theirs.backend
    assert _by_label(mine) == _by_label(theirs)
    assert len(mine.results) == len(LAYERS) * len(VARIANTS)
    assert {k: (r.target, r.cycles) for k, r in
            mine.best_by_layer().items()} == \
        {k: (r.target, r.cycles) for k, r in theirs.best_by_layer().items()}
    assert mine.counts() == theirs.counts()
    assert mine.stages_run() == theirs.stages_run()
    repro.clear_cache()
    repro_torch.clear_cache()


def _run_targets(pkg: str) -> list[str]:
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run([sys.executable, "-m", f"{pkg}.targets"],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout.splitlines()


def test_targets_cli_matches_reference():
    mine, theirs = _run_targets("repro_torch"), _run_targets("repro")
    h100 = [line for line in mine if line.startswith("ok   h100:")]
    assert len(h100) == 1
    # the bundled dnnweaver, example, hvx and tpu_v5e lines and both
    # derived-variant sweep lines, cycles included
    assert [line for line in mine if line not in h100] == theirs
    assert sum("@" in line for line in mine) == 6
    assert mine[-1] == "targets-validate: all bundled specs valid"


def test_targets_facade_matches_reference():
    from repro_torch import targets

    assert repro_torch.targets is targets
    assert targets.list() == sorted(repro.targets.list() + ["h100"])
    assert targets.derive("dnnweaver", pe="32x32").fingerprint() == \
        repro.targets.derive("dnnweaver", pe="32x32").fingerprint()
    assert targets.get("h100").name == "h100"
    assert targets.get is targets.get_target
    assert targets.register is targets.register_spec
    assert targets.H100_SPEC is targets.BUNDLED_SPECS["h100"]
    assert targets.validate_bundled(sweep=False, emit=lambda _: None) == 0
    assert set(targets.__all__) >= set(repro.targets.__all__)


# ---------------------------------------------------------------------------
# plan expansion + partition determinism
# ---------------------------------------------------------------------------


def test_expand_plan_is_deterministic_and_order_independent():
    a = expand_plan(LAYERS, VARIANTS)
    b = expand_plan(list(reversed(LAYERS)), list(reversed(VARIANTS)))
    assert [u.key for u in a] == [u.key for u in b]
    assert len(a) == len(LAYERS) * len(VARIANTS)
    assert [u.key for u in a] == sorted(u.key for u in a)
    c = expand_plan(LAYERS + LAYERS, VARIANTS)
    assert [u.key for u in c] == [u.key for u in a]
    assert plan_id(a) == plan_id(b) == plan_id(c)


def test_partition_is_deterministic_and_complete():
    units = expand_plan(LAYERS, VARIANTS)
    shards = partition(units, 2)
    again = partition(list(reversed(units)), 2)
    assert [[u.key for u in s] for s in shards] == \
        [[u.key for u in s] for s in again]
    flat = [u.key for s in shards for u in s]
    assert sorted(flat) == [u.key for u in units]
    assert abs(len(shards[0]) - len(shards[1])) <= 1
    wide = partition(units, len(units) + 3)
    assert sum(len(s) for s in wide) == len(units)


def test_search_axis_creates_distinct_units():
    searches = [None, repro_torch.SearchOptions(generations=2, population=4,
                                                seed=0)]
    units = expand_plan(["DLRM-FC4"], ["hvx"], searches=searches)
    assert len(units) == 2
    assert {u.opt for u in units} == \
        {"heuristic", "search:evolutionary@g2p4s0"}


def test_workunit_json_roundtrip():
    searches = [repro_torch.SearchOptions(generations=2, population=4,
                                          seed=3)]
    for unit in expand_plan(LAYERS[:1], VARIANTS, searches=searches):
        back = sweep_mod.WorkUnit.from_json(
            json.loads(json.dumps(unit.to_json())))
        assert back == unit


def test_search_options_json_roundtrip():
    sopts = repro_torch.SearchOptions(strategy="beam", beam_width=5,
                                      warm_start=True, patience=3)
    opts = repro_torch.CompileOptions(search=sopts)
    rt = sweep_mod.options_from_json(
        json.loads(json.dumps(sweep_mod.options_to_json(opts))))
    assert rt.search == sopts
    assert rt.fingerprint() == opts.fingerprint()


def test_layer_gemm_and_bf16_descriptor_workloads():
    from repro_torch.launch.layers import LayerGemm

    g = LayerGemm("blk_ffn_in", 4, 64, 32)
    i8 = sweep_mod.workload_of(g)
    assert i8 == ("gemm", {"m": 4, "n": 64, "k": 32, "name": "blk_ffn_in"})
    bf16 = sweep_mod.workload_of(("gemm", dict(i8[1], in_dtype="bf16",
                                               acc_dtype="f32")))
    for workload, built in ((i8, g.build()),
                            (bf16, g.build("bf16", "f32"))):
        assert repro_torch.compile_key(sweep_mod.build_workload(workload),
                                       "h100") == \
            repro_torch.compile_key(built, "h100")
    assert sweep_mod._workload_label(bf16) == "blk_ffn_in"


# ---------------------------------------------------------------------------
# reports: merge identity, winners
# ---------------------------------------------------------------------------


def test_serial_sweep_matches_sequential_compile_many(store):
    pairs = [(layer, v) for layer in LAYERS for v in VARIANTS]
    arts = repro_torch.compile_many(pairs)
    expected = {a.key: a.cycles() for a in arts}
    report = repro_torch.sweep(LAYERS, VARIANTS, store=store)
    assert report.cycles_by_key() == expected
    assert report.counts()["ok"] == len(pairs)
    assert len(store) == len(pairs)


def test_report_merge_is_identity_and_idempotent(tmp_path):
    full = SweepReport(sweep_id="s", results=[
        UnitResult(key=f"{i:02x}", layer=f"L{i % 3}", target="t",
                   cycles=float(i), source="compiled")
        for i in range(6)])
    parts = [SweepReport(sweep_id="s", results=full.results[:2]),
             SweepReport(sweep_id="s", results=full.results[2:]),
             SweepReport(sweep_id="s", results=full.results[1:4])]
    merged = SweepReport.merge(parts)
    assert merged.cycles_by_key() == full.cycles_by_key()
    again = SweepReport.merge([merged, merged])
    assert again.cycles_by_key() == full.cycles_by_key()
    skip = UnitResult(key="00", layer="L0", target="t", status="skipped")
    m = SweepReport.merge([SweepReport(sweep_id="s", results=[skip]), full])
    assert m.cycles_by_key()["00"] == 0.0
    path = str(tmp_path / "report.json")
    merged.save(path)
    assert SweepReport.load(path).to_json() == merged.to_json()


def test_best_by_layer_picks_lowest_cycles():
    rep = SweepReport(sweep_id="s", results=[
        UnitResult(key="aa", layer="L", target="big", cycles=100.0),
        UnitResult(key="ab", layer="L", target="small", cycles=40.0),
        UnitResult(key="ac", layer="L", target="broken", status="failed"),
    ])
    assert rep.best_by_layer()["L"].target == "small"
    assert "small" in rep.best_table()


# ---------------------------------------------------------------------------
# dedup against the store
# ---------------------------------------------------------------------------


def test_dedup_skips_already_stored_units(store):
    warm_key = repro_torch.compile(
        LAYERS[0], VARIANTS[0], repro_torch.CompileOptions(store=store)).key
    repro_torch.clear_cache()
    report = repro_torch.sweep(LAYERS, VARIANTS, store=store)
    by_key = {r.key: r for r in report.results}
    assert by_key[warm_key].source == "dedup"
    assert by_key[warm_key].stages_run == 0
    assert sum(1 for r in report.results if r.source == "compiled") == \
        len(report.results) - 1
    counts = store.journal(report.sweep_id).compile_counts()
    assert warm_key not in counts
    assert set(counts.values()) == {1}


@pytest.mark.parametrize("workers", [1, 2])
def test_warm_sweep_is_all_dedup_and_compiles_each_unit_once(store,
                                                             workers):
    cold = repro_torch.sweep(LAYERS, VARIANTS, workers=workers, store=store)
    c = cold.counts()
    assert c["ok"] == c["compiled"] == len(LAYERS) * len(VARIANTS)
    if workers > 1:
        assert {r.worker for r in cold.results} == {"w0", "w1"}
    counts = store.journal(cold.sweep_id).compile_counts()
    assert len(counts) == c["ok"] and set(counts.values()) == {1}
    repro_torch.clear_cache()
    warm = repro_torch.sweep(LAYERS, VARIANTS, workers=workers, store=store)
    assert warm.counts()["dedup"] == c["ok"]
    assert warm.stages_run() == 0
    assert warm.cycles_by_key() == cold.cycles_by_key()


# ---------------------------------------------------------------------------
# external workers: claims + stale-claim reclaim
# ---------------------------------------------------------------------------


def test_live_claim_is_respected_stale_claim_is_reclaimed(store):
    units = expand_plan(["DLRM-FC4"], ["hvx", "dnnweaver"])
    sid = plan_id(units)
    assert store.claim(sid, units[0].key, "other-worker")
    rep = run_external_worker(units, store, "me", sweep_id=sid,
                              stale_claim_timeout=600, drain_timeout=0)
    by_key = {r.key: r for r in rep.results}
    assert by_key[units[0].key].status == "skipped"
    assert by_key[units[1].key].status == "ok"
    claim = store._claim_path(sid, units[0].key)
    past = os.stat(claim).st_mtime - 3600
    os.utime(claim, (past, past))
    rep2 = run_external_worker(units, store, "me", sweep_id=sid,
                               stale_claim_timeout=60)
    by_key = {r.key: r for r in rep2.results}
    assert by_key[units[0].key].status == "ok"
    assert by_key[units[0].key].source == "compiled"
    assert store.stats["reclaims"] == 1
    merged = SweepReport.merge([rep, rep2])
    assert all(r.status == "ok" for r in merged.results)
    assert set(store.journal(sid).compile_counts().values()) == {1}


def test_claim_heartbeat_keeps_long_compiles_alive(tmp_path):
    path = tmp_path / "unit.claim"
    path.write_text("{}")
    with sweep_mod._ClaimHeartbeat(str(path), interval=0.05):
        past = os.stat(path).st_mtime - 3600
        os.utime(path, (past, past))
        time.sleep(0.3)
        assert time.time() - os.stat(path).st_mtime < 10
    past = os.stat(path).st_mtime - 3600
    os.utime(path, (past, past))
    time.sleep(0.15)
    assert time.time() - os.stat(path).st_mtime >= 3600 - 60


def test_survivor_drains_units_of_a_worker_that_crashed_mid_claim(store):
    units = expand_plan(["DLRM-FC4"], ["hvx"])
    sid = plan_id(units)
    assert store.claim(sid, units[0].key, "crashed-worker")
    rep = run_external_worker(units, store, "survivor", sweep_id=sid,
                              stale_claim_timeout=1.0, drain_timeout=30)
    by_key = {r.key: r for r in rep.results}
    assert by_key[units[0].key].status == "ok"
    assert by_key[units[0].key].source == "compiled"
    assert store.stats["reclaims"] == 1


def test_two_external_workers_drain_the_plan_without_double_work(store):
    units = expand_plan(LAYERS, VARIANTS[:1])
    sid = plan_id(units)
    reps = [run_external_worker(units, store, w, sweep_id=sid)
            for w in ("w-a", "w-b")]
    merged = SweepReport.merge(reps)
    assert merged.counts()["ok"] == len(units)
    counts = store.journal(sid).compile_counts()
    assert len(counts) == len(units) and set(counts.values()) == {1}


# ---------------------------------------------------------------------------
# compile_many(parallel=) and the launch layer's parallel=
# ---------------------------------------------------------------------------


def test_compile_many_parallel_matches_sequential(store):
    pairs = [(layer, v) for layer in LAYERS for v in VARIANTS]
    opts = repro_torch.CompileOptions(store=store)
    arts = repro_torch.compile_many(pairs, options=opts, parallel=2)
    assert all(a.ctx.executed == [] for a in arts)
    assert repro_torch.cache_stats()["store_hits"] == len(pairs)
    parallel_cycles = [a.cycles() for a in arts]
    repro_torch.clear_cache()
    assert parallel_cycles == [a.cycles() for a in
                               repro_torch.compile_many(pairs)]


def test_compile_many_parallel_without_store_warns_and_falls_back():
    repro_torch.clear_cache()
    with pytest.warns(UserWarning, match="parallel"):
        arts = repro_torch.compile_many(["DLRM-FC4"], parallel=2)
    assert arts[0].cycles() > 0
    repro_torch.clear_cache()


def test_layer_gemms_parallel_match_serial(store):
    from repro_torch import configs
    from repro_torch.launch.layers import compile_layer_gemms, variant_report

    cfg = configs.get_config("qwen3-0.6b")
    opts = repro_torch.CompileOptions(store=store)
    par = compile_layer_gemms(cfg, 4, options=opts, parallel=2)
    assert all(art.ctx.executed == [] for _, art in par)
    targets = ["h100", "dnnweaver@pe=32x32"]
    par_report = variant_report(cfg, 4, targets, options=opts, parallel=2)
    repro_torch.clear_cache()
    serial = compile_layer_gemms(cfg, 4)
    assert [a.cycles() for _, a in par] == [a.cycles() for _, a in serial]
    assert par_report == variant_report(cfg, 4, targets)


# ---------------------------------------------------------------------------
# the CLI (python -m repro_torch.sweep)
# ---------------------------------------------------------------------------


def _cli(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH="src",
               REPRO_TORCH_CACHE_DIR=str(tmp_path / "store"))
    return subprocess.run([sys.executable, "-m", "repro_torch.sweep", *args],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=600)


def _plan_cli(tmp_path, *extra):
    return _cli(tmp_path, "--layers", ",".join(LAYERS), "--targets",
                ",".join(VARIANTS), "--workers", "2", *extra)


def test_cli_cold_then_warm_enforces_the_contract(tmp_path):
    cold = _plan_cli(tmp_path, "--assert-unique-compiles")
    assert cold.returncode == 0, cold.stdout + cold.stderr
    assert "compiled exactly once" in cold.stdout
    warm = _plan_cli(tmp_path, "--assert-unique-compiles",
                     "--expect-store-hits")
    assert warm.returncode == 0, warm.stdout + warm.stderr
    assert "zero pipeline stages executed" in warm.stdout


@pytest.mark.parametrize("args,rc,err", [
    (("--layers", ",".join(LAYERS), "--targets", ",".join(VARIANTS),
      "--workers", "2", "--expect-store-hits"), 1, "FAIL"),
    (("--layers", "DLRM-FC4", "--targets", "hvx", "--search", "beam",
      "--race"), 2, "two"),
    (("--layers", "DLRM-FC4", "--targets", "hvx", "--search", "bem"), 2,
     "error: --search"),
    (("--layers", "DLRM-FC4", "--targets", "hvx", "--search",
      "generations=lots"), 2, "error: --search"),
], ids=["store-hits-cold", "race-one-search", "unknown-strategy",
        "non-integer"])
def test_cli_refuses(tmp_path, args, rc, err):
    r = _cli(tmp_path, *args)
    assert r.returncode == rc, (r.stdout, r.stderr)
    assert err in r.stderr
    assert "Traceback" not in r.stderr


def test_cli_needs_a_store_for_workers(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "REPRO_TORCH_CACHE_DIR"}
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.sweep", "--layers", "DLRM-FC4",
         "--targets", "hvx", "--workers", "2"],
        capture_output=True, text=True, env=dict(env, PYTHONPATH="src"),
        cwd=ROOT, timeout=600)
    assert r.returncode == 2
    assert "REPRO_TORCH_CACHE_DIR" in r.stderr


# ---------------------------------------------------------------------------
# strategy racing + cross-backend determinism
# ---------------------------------------------------------------------------

RACE_SEARCHES = [
    repro_torch.SearchOptions(strategy="beam", generations=2, population=6,
                              seed=0, max_candidates=128),
    repro_torch.SearchOptions(strategy="evolutionary", generations=2,
                              population=6, seed=0, max_candidates=128),
]


@pytest.mark.search
def test_race_pins_winner_per_layer_and_journals_exactly_once(store):
    layers = ["DLRM-FC3", "DLRM-FC4"]
    report = repro_torch.sweep(layers, ["hvx"], store=store,
                               searches=RACE_SEARCHES, race=True)
    assert report.counts()["ok"] == 4
    assert len(report.pins) == len(layers)
    counts = store.journal(report.sweep_id).compile_counts()
    assert len(counts) == 4 and set(counts.values()) == {1}
    by_layer = {r.layer: [] for r in report.ok}
    for r in report.ok:
        by_layer[r.layer].append(r)
    for pin in report.pins:
        assert pin["cycles"] == min(r.cycles for r in by_layer[pin["layer"]])
        assert pin["strategy"] in ("beam", "evolutionary")
        assert sorted(pin["raced"]) == pin["raced"] and len(pin["raced"]) == 2
        assert store.load_pin(store.pin_name(pin["layer"], "hvx")) is not None
    assert "winner" in report.race_table()
    warm = repro_torch.sweep(layers, ["hvx"], store=store,
                             searches=RACE_SEARCHES, race=True)
    assert warm.counts()["dedup"] == 4
    assert [p["key"] for p in warm.pins] == [p["key"] for p in report.pins]
    counts = store.journal(report.sweep_id).compile_counts()
    assert set(counts.values()) == {1}


@pytest.mark.parametrize("store_given,searches,match", [
    (False, RACE_SEARCHES, "ArtifactStore"),
    (True, RACE_SEARCHES[:1], "two"),
], ids=["no-store", "one-strategy"])
def test_race_refuses(store, store_given, searches, match):
    with pytest.raises(ValueError, match=match):
        repro_torch.sweep(["DLRM-FC4"], ["hvx"], searches=searches,
                          race=True, store=store if store_given else None)


def test_race_pins_survivor_when_rival_strategy_fails(store):
    units = expand_plan(["DLRM-FC4"], ["hvx"], searches=RACE_SEARCHES)
    ok_unit, failed_unit = units
    art = repro_torch.compile(
        "DLRM-FC4", "hvx", dataclasses.replace(ok_unit.options, store=store))
    report = SweepReport(sweep_id="x", results=[
        UnitResult(key=ok_unit.key, layer="DLRM-FC4", target="hvx",
                   opt=ok_unit.opt, status="ok", source="compiled",
                   cycles=art.cycles()),
        UnitResult(key=failed_unit.key, layer="DLRM-FC4", target="hvx",
                   opt=failed_unit.opt, status="failed", error="boom"),
    ])
    pins = sweep_mod._pin_race_winners(units, report, store, None)
    assert len(pins) == 1
    assert pins[0]["key"] == ok_unit.key


@pytest.mark.search
def test_search_traces_byte_identical_across_fork_and_spawn(tmp_path):
    import multiprocessing as mp

    methods = [m for m in ("fork", "spawn")
               if m in mp.get_all_start_methods()]
    if len(methods) < 2:
        pytest.skip("platform offers a single mp start method")
    digests = {}
    for method in methods:
        repro_torch.clear_cache()
        st = ArtifactStore(str(tmp_path / method))
        report = repro_torch.sweep(["DLRM-FC4"], ["hvx"], store=st,
                                   workers=2, searches=RACE_SEARCHES,
                                   backend="process", mp_start=method)
        assert report.counts()["ok"] == 2, report.summary()
        entries = {}
        for r in report.ok:
            s = (st.peek(r.key) or {}).get("search")
            assert s is not None
            entries[r.key] = json.dumps(s, sort_keys=True)
        digests[method] = entries
    assert digests[methods[0]] == digests[methods[1]]
    repro_torch.clear_cache()


@pytest.mark.search
def test_cli_race_prints_winners_and_asserts_unique(tmp_path):
    r = _cli(tmp_path, "--layers", "DLRM-FC4", "--targets", "hvx",
             "--search", "strategy=beam,generations=2,population=6,seed=0,"
                         "max_candidates=128",
             "--search", "strategy=evolutionary,generations=2,population=6,"
                         "seed=0,max_candidates=128",
             "--race", "--assert-unique-compiles")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "winner" in r.stdout
    assert "compiled exactly once" in r.stdout
