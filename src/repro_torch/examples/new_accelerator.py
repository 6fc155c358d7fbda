"""Defining a brand-new accelerator purely as a covenant spec.

The paper's adaptability claim: the ACG lets a compiler absorb accelerator
design changes "without complete compiler redevelopment".  This example
makes that claim concrete — it declares a new edge-NPU-style target as
*data* (an ``ACGSpec``: memories, capabilities, edges; the mnemonic
vocabulary is generated), registers it by name, and compiles every paper
layer through the unchanged driver.  Zero edits to ``repro_torch/core``.

It then derives a scaled family member (quarter-size PE array) with
``spec.derive`` and shows the two variants get distinct store keys and
distinct cost reports — the paper's design-space sweep as three lines of
code.

    PYTHONPATH=src python -m repro_torch.examples.new_accelerator

The port's copy of ``examples/new_accelerator.py``.
"""
import repro_torch
from repro_torch import targets
from repro_torch.core import library
from repro_torch.core.spec import acg_spec, scap, scu, sedge, smem, sop

# A 16x16 weight-stationary NPU: DRAM-backed, one unified scratchpad (SPM)
# feeding a 16x16 int8 systolic array and a 16-lane vector unit.
EDGE_NPU = acg_spec(
    "edge_npu",
    memories=[
        smem("DRAM", data_width=8, banks=1, depth=1 << 30, offchip=True),
        smem("SPM", data_width=32, banks=64, depth=8192),   # 2 MiB
    ],
    computes=[
        scu("PEGRID", [
            scap("GEMM", sop("i32", 16),
                 [sop("i8", 16), sop("i8", 16, 16), sop("i32", 16)],
                 geometry=(1, 16, 16)),
            scap("MAC", sop("i32", 16),
                 [sop("i8", 16), sop("i8", 16, 16), sop("i32", 16)],
                 geometry=(1, 16, 16)),
        ], slot="grid"),
        scu("VLANES", [
            *(scap(n, sop("i32", 16), [sop("i32", 16)] * 2)
              for n in ("ADD", "SUB", "MUL", "MAX", "MIN")),
            *(scap(n, sop("i32", 16), [sop("i32", 16)])
              for n in ("RELU", "SIGMOID", "TANH")),
        ], slot="vector"),
    ],
    edges=[
        sedge("DRAM", "SPM", bandwidth=128, bidir=True),
        sedge("SPM", "PEGRID", bandwidth=32 * 16, bidir=True),
        sedge("SPM", "VLANES", bandwidth=32 * 16, bidir=True),
    ],
    loop_overhead=0,   # hardware loop sequencer
    addr_bits=24,
)


def main() -> None:
    repro_torch.validate_spec(EDGE_NPU)   # structural soundness up front
    targets.register(EDGE_NPU)            # addressable by name everywhere
    print(f"registered {EDGE_NPU.name!r} "
          f"(fingerprint {EDGE_NPU.fingerprint()[:12]}); "
          f"targets: {targets.list()}")

    arts = repro_torch.compile_many(library.PAPER_LAYERS, target="edge_npu")
    print(f"\n{'layer':22s} {'edge_npu':>12s} {'@pe=8x8':>12s}")
    small = repro_torch.compile_many(library.PAPER_LAYERS,
                                     target="edge_npu@pe=8x8")
    for spec, a, s in zip(library.PAPER_LAYERS, arts, small):
        print(f"{spec.key:22s} {a.cycles():12.0f} {s.cycles():12.0f}")
        assert a.key != s.key, "derived variant must key separately"

    # the derived family member is just data, too
    variant = EDGE_NPU.derive(pe="8x8")
    print(f"\nderived {variant.name!r}: "
          f"fingerprint {variant.fingerprint()[:12]} "
          f"(base {EDGE_NPU.fingerprint()[:12]})")
    stats = repro_torch.cache_stats()
    print(f"compile cache: {stats['hits']} hits / {stats['misses']} misses")


if __name__ == "__main__":
    main()
