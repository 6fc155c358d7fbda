"""Quickstart: the paper's pipeline end-to-end on two targets, via the
unified compile driver.

One ``repro_torch.compile(codelet, target)`` call runs the whole Covenant flow
(placement -> compute mapping -> Algorithm-1 tiling -> transfer insertion ->
optimization passes) and returns a cached ``CompiledArtifact``; the
macro-mnemonic program, stream execution and analytic cycle count hang off
the artifact.  Retargeting is the ``target=`` argument — nothing else
changes.

    PYTHONPATH=src python -m repro_torch.examples.quickstart

The port's copy of ``examples/quickstart.py``.
"""
import numpy as np

import repro_torch
from repro_torch.core import library


def main() -> None:
    rng = np.random.default_rng(0)
    cdlt = library.gemm(16, 32, 24, in_dtype="u8", acc_dtype="i32")
    A = rng.integers(0, 8, (16, 24)).astype(np.uint8)
    B = rng.integers(0, 8, (24, 32)).astype(np.uint8)
    want = (A.astype(np.int64) @ B.astype(np.int64)).astype(np.int32)

    for target in ("hvx", "dnnweaver"):
        art = repro_torch.compile(cdlt, target)
        print(f"=== {target} ===")
        for note in art.schedule_notes:
            print("  ", note)
        prog = art.program
        print(f"   {len(prog)} mnemonics ({prog.bytes} bytes); first 5:")
        for line in art.listing(5).splitlines():
            print("    ", line)
        res = art.run({"A": A, "B": B})
        ok = np.array_equal(res.outputs["C"], want)
        print(f"   correct={ok} serial={res.serial_cycles:.0f}cyc "
              f"packed={res.packed_cycles:.0f}cyc "
              f"(analytic {art.cycles():.0f})")
        assert ok
        # a repeated compile of the same (codelet, target, options) is served
        # from the content-addressed cache: the very same artifact comes back
        assert repro_torch.compile(cdlt, target) is art

    # targets are addressable by name everywhere — including *derived
    # variants*: the registry parses "base@key=value" and derives the
    # covenant spec on the fly (the paper's adaptability claim, one string)
    half = repro_torch.compile("DLRM-FC1", "dnnweaver@pe=32x32")
    full = repro_torch.compile("DLRM-FC1", "dnnweaver")
    print(f"=== DLRM-FC1 on dnnweaver@pe=32x32 ===\n   "
          f"{half.cycles():.0f} cyc vs {full.cycles():.0f} cyc on the "
          f"64x64 array (distinct store keys: {half.key != full.key})")

    stats = repro_torch.cache_stats()
    print(f"compile cache: {stats['hits']} hits / {stats['misses']} misses")


if __name__ == "__main__":
    main()
