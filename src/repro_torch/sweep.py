"""``repro_torch.sweep`` — fleet-scale sweeps over the shared artifact
store.

A thin facade over ``repro_torch.core.sweep`` (see that module for the
design): call it as a function *or* run it as a module —

    import repro_torch
    report = repro_torch.sweep(["DLRM-FC1", "DLRM-FC2"],
                               targets=["dnnweaver", "dnnweaver@pe=32x32"],
                               workers=2, store=".repro-torch-store")
    print(report.best_table())

    # the same sweep from the shell:
    REPRO_TORCH_CACHE_DIR=.repro-torch-store python -m repro_torch.sweep \
        --layers DLRM-FC1,DLRM-FC2 \
        --targets dnnweaver,dnnweaver@pe=32x32 \
        --workers 2 --assert-unique-compiles

Contract flags: ``--assert-unique-compiles`` fails unless the sweep
journal shows every work unit compiled *exactly once* (across cold + warm
runs of the same plan); ``--expect-store-hits`` fails unless every unit
was served from the store with zero pipeline stages executed (the warm
re-run check).  ``--external`` makes this process one claim-based worker
of an independently launched fleet instead of a forking coordinator.

The port's copy of ``repro.sweep``, with the same flags and contracts;
the store falls back to ``$REPRO_TORCH_CACHE_DIR``.
"""
from __future__ import annotations

import sys
import types

from repro_torch.core.store import ArtifactStore, SweepJournal, WarmStartIndex
from repro_torch.core.sweep import (SweepReport, UnitResult, WorkUnit,
                                    expand_plan, partition, plan_id,
                                    run_external_worker, sweep,
                                    workload_of)

__all__ = ["ArtifactStore", "SweepJournal", "SweepReport", "UnitResult",
           "WarmStartIndex", "WorkUnit", "expand_plan", "partition",
           "plan_id", "run_external_worker", "sweep", "workload_of"]


class _CallableModule(types.ModuleType):
    """``import repro_torch.sweep`` rebinds the ``repro_torch.sweep``
    attribute from the function exported by ``repro_torch/__init__`` to
    this module; making the module itself callable keeps
    ``repro_torch.sweep(...)`` working either way."""

    def __call__(self, *args, **kwargs):
        return sweep(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableModule


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _parse_search(text: str):
    """``strategy=beam,generations=4,population=10,beam_width=8,
    warm_start=1`` -> SearchOptions; a bare strategy name is shorthand
    (``beam`` == ``strategy=beam``)."""
    from repro_torch.core.search import STRATEGIES, SearchOptions
    kwargs: dict = {}
    for part in text.split(","):
        if not part:
            continue
        k, _, v = part.partition("=")
        k = k.strip()
        if not v:
            if k in STRATEGIES:
                kwargs["strategy"] = k
                continue
            raise ValueError(
                f"--search: {k!r} is neither a registered strategy "
                f"({sorted(STRATEGIES)}) nor a K=V setting")
        if k == "strategy":
            kwargs[k] = v.strip()
        elif k == "warm_start":
            kwargs[k] = v.strip().lower() in ("1", "true", "yes")
        elif k == "patience":
            kwargs[k] = None if v.strip().lower() == "none" else int(v)
        else:
            try:
                kwargs[k] = int(v)
            except ValueError:
                raise ValueError(
                    f"--search: {k}={v!r} is not an integer") from None
    try:
        return SearchOptions(**kwargs)
    except TypeError as e:
        raise ValueError(f"--search: {e}") from None


def _main(argv=None) -> int:
    import argparse
    import os

    from repro_torch.core import library, store as store_mod

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sweep",
        description="shard a (layers x target-variants) compile sweep "
                    "across worker processes over a shared artifact store")
    ap.add_argument("--layers", default=None,
                    help="comma list of paper-layer keys "
                         "(default: every Table-2 layer)")
    ap.add_argument("--targets", default="hvx,dnnweaver",
                    help="comma list of registry names, incl. derived "
                         "variants like dnnweaver@pe=32x32")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--backend", default=None,
                    choices=("serial", "process", "external"))
    ap.add_argument("--external", action="store_true",
                    help="act as one claim-based worker of an "
                         "independently launched fleet")
    ap.add_argument("--store", default=None,
                    help="artifact-store directory "
                         "(default: $REPRO_TORCH_CACHE_DIR)")
    ap.add_argument("--search", action="append", default=None,
                    metavar="K=V,...",
                    help="add a search axis entry (repeatable), e.g. "
                         "'strategy=evolutionary,generations=4,"
                         "population=10,seed=0' or just 'beam'; repeat "
                         "the flag to race several strategies")
    ap.add_argument("--race", action="store_true",
                    help="race the --search strategies per (layer, "
                         "target) under equal budgets and pin each "
                         "winner in the store")
    ap.add_argument("--stale-claim-timeout", type=float, default=60.0)
    ap.add_argument("--no-dedup", action="store_true",
                    help="dispatch already-stored units anyway (they "
                         "still warm-restore inside the workers)")
    ap.add_argument("--gc-max-age", type=float, default=None, metavar="S",
                    help="age-GC the store before sweeping")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the SweepReport as JSON")
    ap.add_argument("--assert-unique-compiles", action="store_true",
                    help="fail unless the sweep journal shows every work "
                         "unit compiled exactly once")
    ap.add_argument("--expect-store-hits", action="store_true",
                    help="fail unless every unit came from the store with "
                         "zero pipeline stages executed (warm-run check)")
    args = ap.parse_args(argv)

    layers = args.layers.split(",") if args.layers \
        else [s.key for s in library.PAPER_LAYERS]
    targets = args.targets.split(",")
    store = args.store or os.environ.get(store_mod.ENV_DIR)
    needs_store = (args.external or args.backend == "external"
                   or args.assert_unique_compiles
                   or args.expect_store_hits or args.workers > 1
                   or args.race)
    if store is None and needs_store:
        print("error: multi-worker / journal-asserted / racing sweeps need "
              "a store (--store DIR or REPRO_TORCH_CACHE_DIR)",
              file=sys.stderr)
        return 2
    st = store_mod.resolve(store) if store else None
    if st is not None and args.gc_max_age is not None:
        print(f"gc: {st.gc(max_age=args.gc_max_age)}")
    try:
        searches = [_parse_search(s) for s in args.search] if args.search \
            else None
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.race and (not searches or len(searches) < 2):
        print("error: --race needs at least two --search strategies",
              file=sys.stderr)
        return 2
    backend = args.backend or ("external" if args.external else None)

    report = sweep(layers, targets, searches=searches, workers=args.workers,
                   store=st, backend=backend, dedup=not args.no_dedup,
                   race=args.race,
                   stale_claim_timeout=args.stale_claim_timeout)

    for r in report.results:
        cyc = f"{r.cycles:.0f}" if r.cycles is not None else "-"
        line = (f"{r.status:7s} {r.source:8s} {r.worker:12s} "
                f"{r.layer} @ {r.target} [{r.opt}] cycles={cyc}")
        if r.error:
            line += f" error={r.error}"
        print(line)
    print()
    print(report.best_table())
    if args.race:
        print()
        print(report.race_table())
    print()
    print(report.summary())
    if args.json:
        report.save(args.json)

    failures = 0
    if report.counts()["failed"]:
        print(f"FAIL: {report.counts()['failed']} unit(s) failed",
              file=sys.stderr)
        failures += 1
    if args.assert_unique_compiles:
        counts = st.journal(report.sweep_id).compile_counts()
        dupes = {k: n for k, n in counts.items() if n != 1}
        missing = [r.key for r in report.results
                   if r.key not in counts and r.source == "compiled"]
        if dupes or missing:
            print(f"FAIL: journal shows non-unique compiles "
                  f"(dupes={dupes}, unjournaled={missing})",
                  file=sys.stderr)
            failures += 1
        else:
            print(f"journal: {len(counts)} unit(s) compiled exactly once")
    if args.expect_store_hits:
        cold = [r for r in report.results
                if r.source not in ("store", "dedup")]
        stages = report.stages_run()
        if cold or stages:
            print(f"FAIL: expected an all-store warm sweep, but "
                  f"{len(cold)} unit(s) (re)compiled and {stages} "
                  f"pipeline stage(s) ran", file=sys.stderr)
            failures += 1
        else:
            print(f"warm: all {len(report.results)} units served from the "
                  f"store, zero pipeline stages executed")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(_main())
