"""Multi-process sweep coordinator over the shared artifact store.

The paper's compiler wins by evaluating *many* execution mappings per
layer per architecture; this module is that loop at fleet scale.  A
**sweep plan** is the cross product

    layers x target variants x (optional) search configs

expanded into **work units** whose identity is the driver's
content-addressed compile key — ``(codelet fingerprint, covenant-spec
fingerprint, options fingerprint, pipeline fingerprint)`` — exactly the
key the in-process cache and the disk ``ArtifactStore`` use.  That shared
identity is what makes the coordinator correct by construction:

* **dedup** — units whose key already sits in the store are reported
  straight from the stored entry (``store.peek``), never dispatched;
* **partition** — remaining units are sharded across N worker processes
  deterministically (key-sorted round robin: a function of the unit-key
  set and N only, independent of plan order);
* **merge** — every worker compiles *through the driver* with the store
  configured, so results land in the shared measurement database and the
  coordinator's ``SweepReport`` is just the union of unit records.

Three backends:

* ``serial`` — in-process, the reference semantics (``SweepReport`` merge
  identity vs a plain ``compile_many`` is a test invariant);
* ``process`` — the coordinator forks/spawns N workers
  (``multiprocessing``) over a static partition;
* ``external`` — *this* process is one of N independently launched
  workers (``python -m repro_torch.sweep ... --external``) that claim units
  through store-side claim files (``ArtifactStore.claim``) with a
  stale-claim timeout, so a crashed worker's units are reclaimed by the
  survivors and the sweep always drains.

Every unit outcome is appended to the store's monotonic ``SweepJournal``;
CI asserts "each work unit compiled exactly once, warm re-runs recompile
nothing" as pure journal queries (``python -m repro_torch.sweep
--assert-unique-compiles --expect-store-hits``).

The port's copy of ``repro.core.sweep``, with the same logic.  Like the
rest of ``core`` it imports no ``torch``, so a worker process never
touches the card.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Iterable, Sequence

from . import library as library_mod
from . import store as store_mod
from .codelet import Codelet
from .pipeline import CompileOptions
from .search import SearchOptions

# ---------------------------------------------------------------------------
# workload descriptors — the serialisable half of a work unit
# ---------------------------------------------------------------------------

# A workload is ("kind", payload) where payload is JSON-able for every
# kind except "local" (an in-memory Codelet/builder: serial backend only).
_BUILDERS = {
    "gemm": library_mod.gemm,
    "fc": library_mod.fc,
    "conv2d": library_mod.conv2d,
    "elementwise": library_mod.elementwise,
}


def workload_of(layer) -> tuple:
    """Normalise a sweep ``layers`` item into a workload descriptor.

    Accepts paper-layer keys, ``library.LayerSpec``, launch-layer GEMM
    records (anything with ``tokens``/``n``/``k``/``name``), explicit
    ``("gemm"|"fc"|"conv2d"|"elementwise", {kwargs})`` descriptors, and —
    for the serial backend only — raw Codelets or builder thunks."""
    if isinstance(layer, str):
        return ("paper", layer)
    if isinstance(layer, library_mod.LayerSpec):
        if any(s.key == layer.key for s in library_mod.PAPER_LAYERS):
            return ("paper", layer.key)
        return ("local", layer.build)
    if all(hasattr(layer, a) for a in ("tokens", "n", "k", "name")):
        # launch.layers.LayerGemm (duck-typed: launch depends on torch,
        # the sweep core must not); its i8 codelet, as the reference's.  A
        # bf16 unit is the explicit descriptor ("gemm", {..., "in_dtype":
        # "bf16", "acc_dtype": "f32"})
        return ("gemm", {"m": int(layer.tokens), "n": int(layer.n),
                         "k": int(layer.k), "name": str(layer.name)})
    if isinstance(layer, tuple) and len(layer) == 2 \
            and layer[0] in _BUILDERS and isinstance(layer[1], dict):
        return (layer[0], dict(layer[1]))
    if isinstance(layer, Codelet) or callable(layer):
        return ("local", layer)
    raise TypeError(f"cannot express {layer!r} as a sweep workload")


def build_workload(workload: tuple) -> Codelet:
    kind, payload = workload
    if kind == "paper":
        return library_mod.paper_layer(payload)
    if kind == "local":
        return payload() if callable(payload) else payload
    builder = _BUILDERS.get(kind)
    if builder is None:
        raise ValueError(f"unknown workload kind {kind!r}")
    return builder(**payload)


def _workload_serialisable(workload: tuple) -> bool:
    return workload[0] != "local"


def _workload_label(workload: tuple) -> str:
    kind, payload = workload
    if kind == "paper":
        return payload
    if kind == "local":
        obj = payload
        name = getattr(obj, "name", None) or getattr(obj, "__name__", None)
        return str(name or "local")
    if kind == "gemm" and "name" in payload:
        return str(payload["name"])
    return f"{kind}:" + ",".join(f"{k}={v}"
                                 for k, v in sorted(payload.items()))


# ---------------------------------------------------------------------------
# options (de)serialisation — JSON plans for external/spawned workers
# ---------------------------------------------------------------------------

_OPTION_FIELDS = ("vectorize", "unroll", "pack", "unroll_factor",
                  "max_mnemonics", "check_covenant")


def options_to_json(opts: CompileOptions) -> dict:
    d = {f: getattr(opts, f) for f in _OPTION_FIELDS}
    if opts.search is not None:
        d["search"] = dataclasses.asdict(opts.search)
    return d


def options_from_json(d: dict) -> CompileOptions:
    search = None
    if d.get("search") is not None:
        s = dict(d["search"])
        s["unroll_choices"] = tuple(s.get("unroll_choices", (1, 2, 4, 8)))
        search = SearchOptions(**s)
    return CompileOptions(**{f: d[f] for f in _OPTION_FIELDS if f in d},
                          search=search)


def _options_label(opts: CompileOptions) -> str:
    if opts.search is not None:
        return (f"search:{opts.search.strategy}"
                f"@g{opts.search.generations}p{opts.search.population}"
                f"s{opts.search.seed}")
    return "heuristic"


# ---------------------------------------------------------------------------
# work units + results
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WorkUnit:
    """One ``(codelet, target-variant, options)`` point of a sweep plan,
    identified by the driver's content-addressed compile ``key``."""

    layer: str            # display label (paper key / codelet name)
    target: str           # registry name, incl. derived variants
    workload: tuple       # serialisable descriptor (see workload_of)
    options: CompileOptions
    key: str              # = repro_torch.core.driver.compile_key(...)

    @property
    def opt(self) -> str:
        return _options_label(self.options)

    def to_json(self) -> dict:
        assert _workload_serialisable(self.workload), \
            f"local workload {self.layer!r} cannot cross a process boundary"
        return {"layer": self.layer, "target": self.target,
                "workload": list(self.workload),
                "options": options_to_json(self.options), "key": self.key}

    @classmethod
    def from_json(cls, d: dict) -> "WorkUnit":
        return cls(layer=d["layer"], target=d["target"],
                   workload=tuple(d["workload"]),
                   options=options_from_json(d["options"]), key=d["key"])


@dataclasses.dataclass
class UnitResult:
    """Outcome of one work unit.

    ``source``: ``compiled`` (ran the pipeline/search), ``store`` (warm
    artifact-store restore — zero pipeline stages), ``cache`` (in-process
    cache hit), ``dedup`` (coordinator skipped dispatch: the key was
    already in the store), ``none`` (failed/skipped before compiling)."""

    key: str
    layer: str
    target: str
    opt: str = "heuristic"
    status: str = "ok"          # ok | failed | skipped
    source: str = "none"
    cycles: float | None = None
    stages_run: int = 0
    worker: str = "coordinator"
    error: str | None = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "UnitResult":
        return cls(**d)


_STATUS_RANK = {"ok": 0, "failed": 1, "skipped": 2}


@dataclasses.dataclass
class SweepReport:
    """Merged outcome of a sweep: per-unit records + roll-ups.

    ``merge`` is associative and idempotent over unit keys (the best
    record per key wins: ok > failed > skipped), so partial reports from
    any number of workers — or from a re-run — combine into the same
    final report.  ``pins`` records the winners a ``race=True`` sweep
    pinned in the store (coordinator-side, attached after the merge)."""

    sweep_id: str
    results: list[UnitResult] = dataclasses.field(default_factory=list)
    backend: str = "serial"
    workers: int = 1
    pins: list[dict] = dataclasses.field(default_factory=list)

    # -- roll-ups ------------------------------------------------------------
    def counts(self) -> dict:
        c = {"units": len(self.results), "ok": 0, "failed": 0, "skipped": 0,
             "compiled": 0, "store": 0, "cache": 0, "dedup": 0}
        for r in self.results:
            c[r.status] = c.get(r.status, 0) + 1
            if r.source in c:
                c[r.source] += 1
        return c

    @property
    def ok(self) -> list[UnitResult]:
        return [r for r in self.results if r.status == "ok"]

    def stages_run(self) -> int:
        return sum(r.stages_run for r in self.results)

    def cycles_by_key(self) -> dict:
        return {r.key: r.cycles for r in self.ok}

    def best_by_layer(self) -> dict:
        """{layer: winning UnitResult} — lowest analytic cycles across the
        target-variant x options axes (the fig14 table)."""
        best: dict[str, UnitResult] = {}
        for r in self.ok:
            if r.cycles is None:
                continue
            cur = best.get(r.layer)
            if cur is None or r.cycles < cur.cycles:
                best[r.layer] = r
        return best

    def best_table(self) -> str:
        best = self.best_by_layer()
        if not best:
            return "(no successful units)"
        width = max(len(k) for k in best)
        lines = [f"{'layer':{width}s} {'best variant':>28s} "
                 f"{'options':>24s} {'cycles':>14s}"]
        for layer in sorted(best):
            r = best[layer]
            lines.append(f"{layer:{width}s} {r.target:>28s} "
                         f"{r.opt:>24s} {r.cycles:14.0f}")
        return "\n".join(lines)

    def race_table(self) -> str:
        """Human-readable table of the strategy race winners (``pins``)."""
        if not self.pins:
            return "(no race winners pinned)"
        width = max(len(p["layer"]) for p in self.pins)
        lines = [f"{'layer':{width}s} {'target':>24s} {'winner':>14s} "
                 f"{'cycles':>14s}"]
        for p in sorted(self.pins, key=lambda p: (p["layer"], p["target"])):
            lines.append(f"{p['layer']:{width}s} {p['target']:>24s} "
                         f"{p['strategy']:>14s} {p['cycles']:14.0f}")
        return "\n".join(lines)

    def summary(self) -> str:
        c = self.counts()
        pinned = f", {len(self.pins)} winners pinned" if self.pins else ""
        return (f"sweep {self.sweep_id}: {c['units']} units via "
                f"{self.backend}x{self.workers} — {c['ok']} ok "
                f"({c['compiled']} compiled, {c['store']} store, "
                f"{c['cache']} cache, {c['dedup']} dedup), "
                f"{c['failed']} failed, {c['skipped']} skipped, "
                f"{self.stages_run()} pipeline stages run{pinned}")

    # -- merge ---------------------------------------------------------------
    @classmethod
    def merge(cls, reports: "Iterable[SweepReport]",
              sweep_id: str | None = None) -> "SweepReport":
        by_key: dict[str, UnitResult] = {}
        sid, backend, workers = sweep_id, "serial", 0
        for rep in reports:
            sid = sid or rep.sweep_id
            backend = rep.backend
            workers = max(workers, rep.workers)
            for r in rep.results:
                cur = by_key.get(r.key)
                if cur is None or _STATUS_RANK.get(r.status, 3) \
                        < _STATUS_RANK.get(cur.status, 3):
                    by_key[r.key] = r
        out = cls(sweep_id=sid or "?", backend=backend,
                  workers=max(workers, 1))
        out.results = sorted(by_key.values(), key=lambda r: r.key)
        return out

    # -- (de)serialisation ---------------------------------------------------
    def to_json(self) -> dict:
        return {"sweep_id": self.sweep_id, "backend": self.backend,
                "workers": self.workers, "pins": list(self.pins),
                "results": [r.to_json() for r in self.results]}

    @classmethod
    def from_json(cls, d: dict) -> "SweepReport":
        return cls(sweep_id=d["sweep_id"], backend=d.get("backend", "?"),
                   workers=d.get("workers", 1), pins=d.get("pins", []),
                   results=[UnitResult.from_json(r) for r in d["results"]])

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_json(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "SweepReport":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_json(json.load(f))


# ---------------------------------------------------------------------------
# plan expansion + deterministic partition
# ---------------------------------------------------------------------------


def expand_plan(layers: Iterable, targets: Sequence[str] = ("hvx",),
                options: CompileOptions | None = None,
                searches: Sequence[SearchOptions | None] | None = None,
                ) -> list[WorkUnit]:
    """layers x targets x search configs -> key-sorted, key-deduped work
    units.  ``searches`` adds an options axis: each entry replaces
    ``options.search`` (``None`` = the one-shot heuristic)."""
    from . import driver as driver_mod  # local: driver imports sweep lazily

    base = options if options is not None else CompileOptions()
    if getattr(base, "store", None) is not None:
        base = dataclasses.replace(base, store=None)  # location, not input
    axis = [base] if not searches else \
        [dataclasses.replace(base, search=s) for s in searches]
    units: dict[str, WorkUnit] = {}
    for layer in layers:
        workload = workload_of(layer)
        cdlt = build_workload(workload)
        label = _workload_label(workload)
        for target in targets:
            if not isinstance(target, str):
                raise TypeError(
                    f"sweep targets must be registry names (got "
                    f"{type(target)!r}); register the spec first")
            for opts in axis:
                key = driver_mod.compile_key(cdlt, target, opts)
                units.setdefault(key, WorkUnit(
                    layer=label, target=target, workload=workload,
                    options=opts, key=key))
    return sorted(units.values(), key=lambda u: u.key)


def partition(units: Sequence[WorkUnit],
              workers: int) -> list[list[WorkUnit]]:
    """Shard units across ``workers`` deterministically: key-sorted round
    robin.  A pure function of the unit-key set and ``workers`` — plan
    order, duplicates and process identity do not change the shards."""
    assert workers >= 1
    shards: list[list[WorkUnit]] = [[] for _ in range(workers)]
    for i, u in enumerate(sorted(units, key=lambda u: u.key)):
        shards[i % workers].append(u)
    return shards


def plan_id(units: Sequence[WorkUnit]) -> str:
    """Stable sweep id: digest of the sorted unit-key set.  Cold and warm
    runs of the same plan share a journal — "compiled exactly once" holds
    *across* runs, which is the CI invariant."""
    h = hashlib.sha256()
    for u in sorted(units, key=lambda u: u.key):
        h.update(u.key.encode())
        h.update(b"\x00")
    return h.hexdigest()[:12]


# ---------------------------------------------------------------------------
# unit execution (shared by every backend)
# ---------------------------------------------------------------------------


def _journal_safe(journal, record: dict) -> None:
    """Journaling is telemetry: a wedged/raced journal lock must never
    fail a unit whose compile already landed in the store.  A dropped
    'compiled' event is still surfaced — the CLI's
    ``--assert-unique-compiles`` reports units that compiled without a
    journal entry."""
    if journal is None:
        return
    try:
        journal.append(record)
    except Exception:
        pass


def _compile_unit(unit: WorkUnit, store, journal, worker: str) -> UnitResult:
    """Compile one unit through the driver, classify the source from the
    driver's stats delta, and journal the outcome."""
    from . import driver as driver_mod

    opts = unit.options if store is None \
        else dataclasses.replace(unit.options, store=store)
    before = driver_mod.cache_stats()
    try:
        art = driver_mod.compile(build_workload(unit.workload), unit.target,
                                 opts)
        cycles = art.cycles()
    except Exception as e:  # a broken covenant/unit must not sink the sweep
        res = UnitResult(key=unit.key, layer=unit.layer, target=unit.target,
                         opt=unit.opt, status="failed", error=str(e),
                         worker=worker)
        _journal_safe(journal, {"event": "failed", "key": unit.key,
                                "layer": unit.layer, "target": unit.target,
                                "worker": worker, "error": str(e)[:500]})
        return res
    after = driver_mod.cache_stats()
    if after["store_hits"] > before["store_hits"]:
        source, event = "store", "store_hit"
    elif after["hits"] > before["hits"]:
        source, event = "cache", "cache_hit"
    else:
        source, event = "compiled", "compiled"
    res = UnitResult(key=unit.key, layer=unit.layer, target=unit.target,
                     opt=unit.opt, status="ok", source=source, cycles=cycles,
                     stages_run=len(art.ctx.executed), worker=worker)
    _journal_safe(journal, {"event": event, "key": unit.key,
                            "layer": unit.layer, "target": unit.target,
                            "worker": worker, "cycles": cycles})
    return res


def _dedup_result(unit: WorkUnit, entry: dict, worker: str) -> UnitResult:
    return UnitResult(key=unit.key, layer=unit.layer, target=unit.target,
                      opt=unit.opt, status="ok", source="dedup",
                      cycles=store_mod.entry_cycles(entry), stages_run=0,
                      worker=worker)


# ---------------------------------------------------------------------------
# process backend
# ---------------------------------------------------------------------------


def _run_worker_shard(payload: str) -> str:
    """Top-level worker entry (spawn-importable).  JSON in, JSON out —
    no pickled live objects cross the process boundary."""
    import repro_torch

    args = json.loads(payload)
    repro_torch.clear_cache()  # forked workers must not inherit warm
    #                            in-process state: unit sources stay
    #                            store/compiled only
    store = store_mod.resolve(args["store"]) if args["store"] else None
    journal = store.journal(args["sweep_id"]) if store is not None else None
    worker = args["worker"]
    results = []
    for d in args["units"]:
        unit = WorkUnit.from_json(d)
        results.append(_compile_unit(unit, store, journal, worker).to_json())
    return json.dumps(results)


def _process_backend(shards: list[list[WorkUnit]], store, sweep_id: str,
                     mp_start: str | None = None) -> list[UnitResult]:
    import multiprocessing as mp

    if mp_start is None:
        mp_start = "fork" if "fork" in mp.get_all_start_methods() \
            else "spawn"
    ctx = mp.get_context(mp_start)
    payloads, labels = [], []
    for i, shard in enumerate(shards):
        if not shard:
            continue
        worker = f"w{i}"
        labels.append((worker, shard))
        payloads.append(json.dumps({
            "units": [u.to_json() for u in shard],
            "store": store.root if store is not None else None,
            "sweep_id": sweep_id, "worker": worker}))
    if not payloads:
        return []
    results: list[UnitResult] = []
    # one future per shard on a ProcessPoolExecutor: a worker dying hard
    # (segfault/OOM) raises BrokenProcessPool instead of wedging the
    # coordinator (the mp.Pool failure mode), and it fails only the
    # shards that had not finished — completed shards keep their results,
    # and every finished unit is in the store either way
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(max_workers=len(payloads),
                             mp_context=ctx) as pool:
        futures = [pool.submit(_run_worker_shard, p) for p in payloads]
        for (worker, shard), fut in zip(labels, futures):
            try:
                out = fut.result()
            except Exception as e:
                results.extend(
                    UnitResult(key=u.key, layer=u.layer, target=u.target,
                               opt=u.opt, status="failed",
                               error=f"worker {worker} died: {e}",
                               worker=worker)
                    for u in shard)
                continue
            results.extend(UnitResult.from_json(d) for d in json.loads(out))
    return results


# ---------------------------------------------------------------------------
# external (claim-based) backend
# ---------------------------------------------------------------------------


class _ClaimHeartbeat:
    """Touch a held claim file on a background timer while its unit
    compiles, so a unit that legitimately takes longer than the
    stale-claim timeout (search-enabled compiles, huge layers) is never
    mistaken for a crashed worker's and double-compiled.  A worker that
    really dies stops beating, its claim ages out, and the unit is
    reclaimed — exactly the intended split."""

    def __init__(self, path: str, interval: float):
        import threading
        self.path = path
        self.interval = max(interval, 0.05)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._beat, daemon=True)

    def _beat(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                os.utime(self.path, None)
            except OSError:
                return  # claim gone (released/broken): nothing to keep warm

    def __enter__(self) -> "_ClaimHeartbeat":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


def run_external_worker(units: Sequence[WorkUnit], store, worker: str,
                        sweep_id: str | None = None,
                        stale_claim_timeout: float = 60.0,
                        drain_timeout: float | None = None) -> SweepReport:
    """Act as one independently launched worker of a fleet: walk the plan
    in key order, skip units already stored, claim the rest through
    store-side claim files, compile, journal, release.  Claims older than
    ``stale_claim_timeout`` (a crashed worker) are broken and reclaimed;
    held claims are heartbeat-refreshed while their unit compiles.

    Units another live worker holds are re-visited until they appear in
    the store (that worker finished) or their claim goes stale and is
    reclaimed (that worker died) — so the *last surviving* worker still
    drains the whole plan.  ``drain_timeout`` (default: 10x the stale
    timeout) bounds that wait; units still held by a live-and-beating
    claim when it expires are reported ``skipped``."""
    import time as time_mod

    if store is None:
        raise ValueError("external workers need a shared ArtifactStore")
    sweep_id = sweep_id or plan_id(units)
    if drain_timeout is None:
        drain_timeout = 10 * stale_claim_timeout
    journal = store.journal(sweep_id)
    done: dict[str, UnitResult] = {}
    pending = sorted(units, key=lambda u: u.key)
    deadline = time_mod.monotonic() + drain_timeout
    while pending:
        waiting = []
        for unit in pending:
            entry = store.peek(unit.key)
            if entry is not None:
                done[unit.key] = _dedup_result(unit, entry, worker)
                continue
            if not store.claim(sweep_id, unit.key, worker,
                               stale_timeout=stale_claim_timeout):
                done[unit.key] = UnitResult(
                    key=unit.key, layer=unit.layer, target=unit.target,
                    opt=unit.opt, status="skipped", source="none",
                    worker=worker, error="claimed by another worker")
                waiting.append(unit)
                continue
            try:
                with _ClaimHeartbeat(store._claim_path(sweep_id, unit.key),
                                     stale_claim_timeout / 3):
                    done[unit.key] = _compile_unit(unit, store, journal,
                                                   worker)
            finally:
                store.release_claim(sweep_id, unit.key, worker)
        pending = waiting
        if pending and time_mod.monotonic() >= deadline:
            break
        if pending:
            time_mod.sleep(min(1.0, stale_claim_timeout / 4))
    results = [done[k] for k in sorted(done)]
    return SweepReport(sweep_id=sweep_id, results=results,
                       backend="external", workers=1)


# ---------------------------------------------------------------------------
# strategy racing — pin the per-(layer, target) winner in the store
# ---------------------------------------------------------------------------


def _pin_race_winners(units: Sequence[WorkUnit], report: SweepReport,
                      store, journal) -> list[dict]:
    """Race the ``searches=`` axis: among each (layer, target)'s search
    units pick the lowest-cycles winner, write it as a store pin
    (``ArtifactStore.pin``) and journal a ``pinned`` event.  Returns the
    pin records (also attached to the report).  Winners feed the
    warm-start index, so a race permanently upgrades later searches of
    same-shaped layers."""
    reported = {r.key: r for r in report.ok if r.cycles is not None}
    groups: dict[tuple[str, str], list[tuple[float, WorkUnit]]] = {}
    for u in units:
        if u.options.search is None:
            continue
        # trust the store over this worker's partial view: a unit another
        # fleet member compiled (this report says skipped/failed) must
        # still race, or a drain-timeout could pin the losing strategy
        r = reported.get(u.key)
        cycles = r.cycles if r is not None else \
            store_mod.entry_cycles(store.peek(u.key) or {})
        if cycles is None:
            continue
        groups.setdefault((u.layer, u.target), []).append((cycles, u))
    pins: list[dict] = []
    for (layer, target), cs in sorted(groups.items()):
        # a rival strategy failing must not cost the group its pin: the
        # surviving strategies still raced (the plan guaranteed >= 2),
        # and the best of them is strictly better than no record at all
        cycles, unit = min(cs, key=lambda cu: (cu[0], cu[1].key))
        entry = store.peek(unit.key) or {}
        search = entry.get("search") or {}
        rec = {"layer": layer, "target": target, "key": unit.key,
               "strategy": unit.options.search.strategy,
               "opt": unit.opt, "cycles": cycles,
               "point": {"tiling": entry.get("tiling"),
                         "unroll_factor": entry.get("unroll_factor", 1)},
               "space_sig": search.get("space_sig"),
               "raced": sorted(u.opt for _, u in cs)}
        store.pin(store.pin_name(layer, target), rec)
        pins.append(rec)
        _journal_safe(journal, {"event": "pinned", "key": unit.key,
                                "layer": layer, "target": target,
                                "worker": "coordinator",
                                "cycles": cycles,
                                "strategy": rec["strategy"]})
    return pins


# ---------------------------------------------------------------------------
# the coordinator
# ---------------------------------------------------------------------------


def sweep(layers: Iterable, targets: Sequence[str] = ("hvx",), *,
          options: CompileOptions | None = None,
          searches: Sequence[SearchOptions | None] | None = None,
          workers: int = 1, store=None, backend: str | None = None,
          sweep_id: str | None = None, dedup: bool = True,
          race: bool = False,
          stale_claim_timeout: float = 60.0,
          mp_start: str | None = None) -> SweepReport:
    """Run a sweep plan and merge the outcome into a ``SweepReport``.

    ``layers`` — paper-layer keys / ``LayerSpec`` / launch GEMM records /
    ``("gemm", {...})`` descriptors (serial backend also takes raw
    Codelets); ``targets`` — registry names incl. derived variants
    (``"dnnweaver@pe=32x32"``); ``searches`` — optional third axis of
    ``SearchOptions`` (``None`` entry = heuristic).

    ``store`` (or ``REPRO_TORCH_CACHE_DIR``) names the shared measurement
    database; with one configured, already-stored units are *deduplicated*
    (reported, not dispatched) and every worker compile lands in the store
    and the sweep journal.  ``backend`` defaults to ``process`` when
    ``workers > 1`` else ``serial``; ``external`` turns this process into
    one claim-based worker of an independently launched fleet.

    ``race=True`` treats the ``searches=`` axis as a per-layer strategy
    race: every strategy runs under its own (equal) budget, and each
    (layer, target)'s lowest-cycles winner is *pinned* in the store
    (``report.pins`` / ``report.race_table()``) for later compiles and
    warm-started searches to reuse."""
    if store is None and options is not None \
            and getattr(options, "store", None) is not None:
        store = options.store  # honour the compile()/compile_many() idiom
    st = store_mod.resolve(store)
    if race:
        if st is None:
            raise ValueError("race=True needs a shared ArtifactStore to "
                             "pin winners in")
        if not searches or sum(s is not None for s in searches) < 2:
            raise ValueError("race=True needs a searches= axis of at "
                             "least two strategies to race")
    units = expand_plan(layers, targets, options=options, searches=searches)
    sweep_id = sweep_id or plan_id(units)
    if backend is None:
        backend = "process" if workers > 1 else "serial"
    if backend == "external":
        report = run_external_worker(units, st, worker=f"pid{os.getpid()}",
                                     sweep_id=sweep_id,
                                     stale_claim_timeout=stale_claim_timeout)
        if race:
            report.pins = _pin_race_winners(units, report, st,
                                            st.journal(sweep_id))
        return report

    results: list[UnitResult] = []
    todo: list[WorkUnit] = []
    journal = st.journal(sweep_id) if st is not None else None
    for unit in units:
        entry = st.peek(unit.key) if (dedup and st is not None) else None
        if entry is not None:
            res = _dedup_result(unit, entry, "coordinator")
            if res.cycles is None:
                # entry present but unreadable analytics: recompile
                todo.append(unit)
                continue
            _journal_safe(journal, {"event": "dedup", "key": unit.key,
                                    "layer": unit.layer,
                                    "target": unit.target,
                                    "worker": "coordinator",
                                    "cycles": res.cycles})
            results.append(res)
        else:
            todo.append(unit)

    if backend == "process" and workers > 1 and todo:
        serialisable = [u for u in todo
                        if _workload_serialisable(u.workload)]
        local = [u for u in todo if not _workload_serialisable(u.workload)]
        shards = partition(serialisable, workers)
        results.extend(_process_backend(shards, st, sweep_id,
                                        mp_start=mp_start))
        for unit in local:  # raw codelets cannot cross processes
            results.append(_compile_unit(unit, st, journal, "coordinator"))
    elif backend in ("serial", "process"):
        for unit in todo:
            results.append(_compile_unit(unit, st, journal, "coordinator"))
    else:
        raise ValueError(f"unknown sweep backend {backend!r}")

    report = SweepReport.merge(
        [SweepReport(sweep_id=sweep_id, results=results)],
        sweep_id=sweep_id)
    report.backend = backend
    report.workers = workers
    if race:
        report.pins = _pin_race_winners(units, report, st, journal)
    return report


__all__ = ["SweepReport", "UnitResult", "WorkUnit", "build_workload",
           "expand_plan", "options_from_json", "options_to_json",
           "partition", "plan_id", "run_external_worker", "sweep",
           "workload_of"]
