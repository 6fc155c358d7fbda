"""Cost-model-guided search depth: beam vs evolutionary, strategy racing,
and cross-layer warm-starting from the artifact store.

    PYTHONPATH=src python -m repro_torch.examples.warm_start_search
    PYTHONPATH=src python -m repro_torch.examples.warm_start_search \
        --store /tmp/ws

Three acts:

1. **Budget-matched race** — ``repro_torch.sweep(..., searches=[beam, evo],
   race=True)`` runs both strategies per layer under one evaluation
   budget and *pins* each winner in the store (``report.race_table()``).
2. **Warm-started search** — a later search of a same-shaped layer seeds
   its population from the store's best recorded points
   (``SearchOptions(warm_start=True)`` via the ``WarmStartIndex`` built
   from the sweep journal + pins) and converges in fewer evaluations.
3. The winning schedules persist content-addressed: re-running this
   script against the same ``--store`` recompiles nothing.

The port's copy of ``examples/warm_start_search.py``.
"""
import argparse
import dataclasses
import tempfile

import repro_torch

LAYERS = ["DLRM-FC1", "DLRM-FC2", "DLRM-FC3"]
BUDGET = dict(generations=4, population=10, seed=0, max_candidates=512)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--store", default=None)
    ap.add_argument("--target", default="hvx")
    args = ap.parse_args()
    store = args.store or tempfile.mkdtemp(prefix="covenant-warm-")

    # -- act 1: race beam vs evolutionary, pin winners ----------------------
    searches = [repro_torch.SearchOptions(strategy="beam", **BUDGET),
                repro_torch.SearchOptions(strategy="evolutionary", **BUDGET)]
    report = repro_torch.sweep(LAYERS, [args.target], store=store,
                               searches=searches, race=True)
    print(report.summary())
    print()
    print(report.race_table())

    # -- act 2: warm-start a fresh search from the recorded points ----------
    print("\nwarm-starting InceptionV3-FC1 (same GEMM shape family):")
    base = repro_torch.SearchOptions(strategy="evolutionary",
                                     generations=10, population=10, seed=3,
                                     max_candidates=512, patience=2)
    for warm in (False, True):
        repro_torch.clear_cache()  # make both runs search, not cache-hit
        sopts = dataclasses.replace(base, warm_start=warm)
        art = repro_torch.compile(
            "InceptionV3-FC1", args.target,
            repro_torch.CompileOptions(search=sopts, store=store))
        s = art.search
        print(f"  warm_start={warm!s:5s} -> {s.best_cycles:10.0f} cycles, "
              f"{s.evaluated:3d} evaluations, {len(s.trace)} generations, "
              f"{s.seeded} seed(s) injected")

    idx = repro_torch.WarmStartIndex.from_store(
        repro_torch.ArtifactStore(store))
    print(f"\nwarm-start index: {len(idx)} recorded points "
          f"(store: {store})")


if __name__ == "__main__":
    main()
