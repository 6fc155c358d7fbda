"""Distributed design-space sweep: shard (paper layers x derived PE-array
variants) across worker processes over a shared artifact store, then read
the best-variant-per-layer table off the merged ``SweepReport``.

    PYTHONPATH=src python -m repro_torch.examples.sweep_variants
    PYTHONPATH=src python -m repro_torch.examples.sweep_variants \
        --workers 4 --store /tmp/covenant-store

A second run against the same store deduplicates every work unit — the
coordinator reports them straight from the stored entries without
dispatching a single worker (watch the ``dedup`` counts and the
``0 pipeline stages run`` summary).  The same sweep is scriptable as
``python -m repro_torch.sweep`` and, claim-file-coordinated, as a fleet
of independently launched ``--external`` workers.

The port's copy of ``examples/sweep_variants.py``.
"""
import argparse
import tempfile

import repro_torch

LAYERS = ["DLRM-FC1", "DLRM-FC2", "DLRM-FC3", "DLRM-FC4",
          "BERT-LG-GEMM1", "BERT-LG-GEMM2"]
VARIANTS = ["dnnweaver", "dnnweaver@pe=32x32", "dnnweaver@pe=16x16",
            "hvx", "hvx@issue_slots=8"]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--store", default=None)
    args = ap.parse_args()
    store = args.store or tempfile.mkdtemp(prefix="covenant-store-")

    for run in ("cold", "warm"):
        report = repro_torch.sweep(LAYERS, VARIANTS, workers=args.workers,
                                   store=store)
        print(f"[{run}] {report.summary()}")
    print()
    print(report.best_table())
    journal = repro_torch.ArtifactStore(store).journal(report.sweep_id)
    counts = journal.compile_counts()
    assert set(counts.values()) == {1}, counts  # each unit compiled once
    print(f"\njournal: {len(counts)} work units, each compiled exactly "
          f"once across both runs (store: {store})")


if __name__ == "__main__":
    main()
