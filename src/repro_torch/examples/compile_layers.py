"""Table-2 sweep: batch-compile all 17 paper layers for both targets with
``repro_torch.compile_many`` and print the per-layer cycle summary (the data
behind Figs 11/13).  Artifacts are cached content-addressed, so re-running
a sweep (or overlapping one, e.g. the Fig-12 ablation) re-uses compiles.

Extra positional arguments are target names — any ``repro_torch.targets``
name, including derived variants — appended as columns:

    PYTHONPATH=src python -m repro_torch.examples.compile_layers
    PYTHONPATH=src python -m repro_torch.examples.compile_layers h100

The port's copy of ``examples/compile_layers.py``.
"""
import sys

import repro_torch
from repro_torch.core import library

OPT = repro_torch.CompileOptions(vectorize=True, unroll=True, pack=True)
BASE = repro_torch.CompileOptions(vectorize=False, unroll=False, pack=False)


def main(extra_targets: list[str] = ()) -> None:
    base_arts = repro_torch.compile_many(library.PAPER_LAYERS, target="hvx",
                                         options=BASE)
    opt_arts = repro_torch.compile_many(library.PAPER_LAYERS, target="hvx",
                                        options=OPT)
    dnnw_arts = repro_torch.compile_many(library.PAPER_LAYERS,
                                         target="dnnweaver", options=OPT)
    # one heterogeneous batch covers every (layer, extra target) point
    extra = repro_torch.compile_many(
        [(spec, t) for t in extra_targets for spec in library.PAPER_LAYERS],
        options=OPT)
    cols = "".join(f" {t[:20]:>20s}" for t in extra_targets)
    print(f"{'layer':22s} {'base(HVX)':>12s} {'opt(HVX)':>12s} "
          f"{'speedup':>8s} {'opt(DNNW)':>12s}{cols}")
    n = len(library.PAPER_LAYERS)
    for i, (spec, b, o, d) in enumerate(zip(library.PAPER_LAYERS, base_arts,
                                            opt_arts, dnnw_arts)):
        base, opt, dn = b.cycles(), o.cycles(), d.cycles()
        row = (f"{spec.key:22s} {base:12.0f} {opt:12.0f} {base / opt:8.1f} "
               f"{dn:12.0f}")
        for t in range(len(extra_targets)):
            row += f" {extra[t * n + i].cycles():20.0f}"
        print(row)


if __name__ == "__main__":
    main(sys.argv[1:])
