"""Bundled accelerator targets as declarative covenant specs, plus the
string-addressable target registry.

Every target here is *data* — an ``spec.ACGSpec`` listing memories,
capabilities, edges and mnemonic layouts (Table 3 attributes for the two
evaluation targets, the Figure-2 example, the reference's TPU-v5e
adaptation, and the port's ``h100``) —
materialized through ``ACG.from_spec``.  Nothing in this module teaches
the compiler anything: adding an accelerator is ``core.targets.register_spec
(acg_spec(...))``, never a compiler edit (the BYOC seam, arXiv 2105.03215).

The registry resolves *names*, including derived-variant names:

    get_target("dnnweaver")                      # bundled spec
    get_target("dnnweaver@pe=32x32")             # spec.derive() on the fly
    get_target("hvx@issue_slots=8,VRF.depth=64") # multiple overrides

Mnemonic vocabularies follow §2.1.4: each target declares opcode + field
layouts; the *semantics* live in the simulator, never in the compiler.

The port's copy of ``repro.core.targets``, with the same logic.
"""
from __future__ import annotations

from .acg import ACG
from .h100 import H100_SPEC
from .spec import (ACGSpec, BINARY, UNARY, acg_spec, parse_overrides, scap,
                   scu, sedge, smem, sop)

# ---------------------------------------------------------------------------
# bundled specs
# ---------------------------------------------------------------------------

# Figure-2 running example: DRAM <-> Global Scratchpad (data_width=32,
# banks=7, depth=1024 => 28,672 B) feeding Scalar / 2-wide Vector / 2x2
# Matrix units.
EXAMPLE_SPEC = acg_spec(
    "example",
    memories=[
        smem("DRAM", data_width=32, banks=1, depth=1 << 28, offchip=True),
        smem("GSP", data_width=32, banks=7, depth=1024),
    ],
    computes=[
        scu("SCALAR", [
            *(scap(n, sop("i16", 1), [sop("i16", 1)]) for n in UNARY),
            *(scap(n, sop("i16", 1), [sop("i16", 1)] * 2) for n in BINARY),
            scap("MAC", sop("i32", 1),
                 [sop("i16", 1), sop("i16", 1), sop("i32", 1)],
                 geometry=(1, 1, 1)),
        ], slot="scalar"),
        scu("VECTOR", [
            *(scap(n, sop("i16", 2), [sop("i16", 2)]) for n in UNARY),
            *(scap(n, sop("i16", 2), [sop("i16", 2)] * 2) for n in BINARY),
        ], slot="vector"),
        scu("MATRIX", [
            scap("MMUL", sop("i16", 2, 2), [sop("i16", 2, 2), sop("i16", 2, 2)],
                 geometry=(2, 2, 2)),
            scap("GEMM", sop("i32", 2, 2),
                 [sop("i16", 2, 2), sop("i16", 2, 2), sop("i32", 2, 2)],
                 geometry=(2, 2, 2)),
            scap("MAC", sop("i32", 2, 2),
                 [sop("i16", 2, 2), sop("i16", 2, 2), sop("i32", 2, 2)],
                 geometry=(2, 2, 2)),
        ], slot="matrix"),
    ],
    edges=[
        sedge("DRAM", "GSP", bandwidth=224, bidir=True),  # Mem. Interface
        *(sedge("GSP", u, bandwidth=224, bidir=True)
          for u in ("SCALAR", "VECTOR", "MATRIX")),
    ],
    addr_bits=24,
)


# DNNWeaver (Table 3): 64x64 systolic array + 64-lane SIMD, per-operand
# buffers (IBUF/WBUF/OBUF/BBUF/VMEM1/VMEM2), hardware loop sequencer.
DNNWEAVER_SPEC = acg_spec(
    "dnnweaver",
    memories=[
        smem("DRAM", data_width=8, banks=1, depth=32_000_000_000,
             offchip=True),
        smem("IBUF", data_width=8, banks=64, depth=2048),
        smem("WBUF", data_width=8, banks=4096, depth=4096),
        smem("OBUF", data_width=32, banks=64, depth=2048),
        smem("BBUF", data_width=32, banks=64, depth=1024),
        smem("VMEM1", data_width=32, banks=64, depth=2048),
        smem("VMEM2", data_width=32, banks=64, depth=2048),
    ],
    computes=[
        scu("SYSTOLIC", [
            # one invocation: 64-wide input row x 64x64 weights -> 64 psums
            scap("GEMM", sop("i32", 64),
                 [sop("i8", 64), sop("i8", 64, 64), sop("i32", 64)],
                 geometry=(1, 64, 64)),
            scap("MAC", sop("i32", 64),
                 [sop("i8", 64), sop("i8", 64, 64), sop("i32", 64)],
                 geometry=(1, 64, 64)),
            scap("MVMUL", sop("i32", 64), [sop("i8", 64), sop("i8", 64, 64)],
                 geometry=(1, 64, 64)),
        ], slot="systolic"),
        scu("SIMD", [
            *(scap(n, sop("i32", 64), [sop("i32", 64)] * 2) for n in BINARY),
            *(scap(n, sop("i32", 64), [sop("i32", 64)]) for n in UNARY),
            scap("MAC", sop("i32", 64),
                 [sop("i32", 64), sop("i32", 64), sop("i32", 64)],
                 geometry=(1, 64, 1)),
        ], slot="simd"),
    ],
    edges=[
        # off-chip interface: 256-bit AXI per transfer op
        *(sedge("DRAM", buf, bandwidth=256)
          for buf in ("IBUF", "WBUF", "BBUF")),
        sedge("OBUF", "DRAM", bandwidth=256),
        sedge("DRAM", "VMEM1", bandwidth=256, bidir=True),
        sedge("DRAM", "VMEM2", bandwidth=256, bidir=True),
        # on-chip: buffers feed the systolic array (unidirectional, §5.1.1)
        sedge("IBUF", "SYSTOLIC", bandwidth=8 * 64),
        sedge("WBUF", "SYSTOLIC", bandwidth=8 * 4096),
        sedge("BBUF", "SYSTOLIC", bandwidth=32 * 64),
        sedge("SYSTOLIC", "OBUF", bandwidth=32 * 64),
        sedge("OBUF", "SIMD", bandwidth=32 * 64),  # SIMD consumes OBUF
        sedge("VMEM1", "SIMD", bandwidth=32 * 64, bidir=True),
        sedge("VMEM2", "SIMD", bandwidth=32 * 64, bidir=True),
    ],
    # dedicated per-operand staging buffers of the systolic array
    operand_ports={("SYSTOLIC", c): ("IBUF", "WBUF", "OBUF", "OBUF")
                   for c in ("GEMM", "MAC", "MVMUL")},
    loop_overhead=0,  # hardware loop sequencer (FSM-driven walkers)
    addr_bits=32,
)


# Qualcomm HVX (Table 3): scalar CORE (GRF) and 32-lane x 128B vector unit
# (VRF), both fed from L2.  L2 is the operand home: DRAM<->L2 is
# hardware-managed (paper: DRAM absent from the ACG), so L2 carries
# offchip=True = "operands live here".  4-wide VLIW issue.
HVX_SPEC = acg_spec(
    "hvx",
    memories=[
        smem("L2", data_width=8, banks=32, depth=1024 * 4, offchip=True),
        smem("GRF", data_width=32, banks=4, depth=32),
        smem("VRF", data_width=1024, banks=32, depth=32),
    ],
    computes=[
        scu("CORE", [
            scap("ADD", sop("u8", 8), [sop("u8", 8)] * 2),
            scap("ADD", sop("i32", 1), [sop("i32", 1)] * 2),
            scap("SUB", sop("i32", 1), [sop("i32", 1)] * 2),
            scap("MUL", sop("i32", 1), [sop("i32", 1)] * 2),
            scap("MAX", sop("i32", 1), [sop("i32", 1)] * 2),
            scap("MIN", sop("i32", 1), [sop("i32", 1)] * 2),
            scap("MAC", sop("i32", 1),
                 [sop("u8", 4), sop("u8", 4), sop("i32", 1)],
                 geometry=(1, 1, 4)),
            *(scap(n, sop("i32", 1), [sop("i32", 1)]) for n in UNARY),
        ], slot="scalar"),
        scu("HVX", [
            *(scap(n, sop("i32", 32), [sop("i32", 32)] * 2) for n in BINARY),
            *(scap(n, sop("i32", 32), [sop("i32", 32)]) for n in UNARY),
            scap("MVMUL", sop("i32", 32), [sop("u8", 32, 4), sop("u8", 4)],
                 geometry=(1, 32, 4)),
            scap("GEMM", sop("i32", 32),
                 [sop("u8", 32, 4), sop("u8", 4), sop("i32", 32)],
                 geometry=(1, 32, 4)),
            scap("GEMM", sop("u32", 32),
                 [sop("u8", 32, 4), sop("u8", 4), sop("u32", 32)],
                 geometry=(1, 32, 4)),
            scap("MAC", sop("i32", 32),
                 [sop("u8", 32, 4), sop("u8", 4), sop("i32", 32)],
                 geometry=(1, 32, 4)),
        ], slot="vector"),
    ],
    edges=[
        sedge("L2", "GRF", bandwidth=32 * 4, bidir=True),
        sedge("L2", "VRF", bandwidth=1024, bidir=True),
        sedge("GRF", "CORE", bandwidth=32 * 4, bidir=True),
        sedge("VRF", "HVX", bandwidth=1024 * 2, bidir=True),
    ],
    issue_slots=4,
    addr_bits=20,
)


# TPU v5e, the reference's adaptation target, as its spec describes it
# (the reference's roofline constants stay in the reference):
# * HBM -> VMEM edge bandwidth: 819 GB/s / 940 MHz ~= 871 B/cycle => 7168
#   bits per 'transfer op' (128 lanes * 56 bits; bandwidth only drives
#   cost, not correctness).
# * VMEM: (8,128) f32 native tile = 4096 B addressable element.
# * MXU: 128x128 systolic bf16 GEMM; VPU: 8x128 f32 vector ALU.
TPU_V5E_SPEC = acg_spec(
    "tpu_v5e",
    memories=[
        smem("HBM", data_width=256, banks=32,
             depth=(16 * 2**30 * 8) // (256 * 32), offchip=True),
        # elem = 32 bits * 1024 banks = 4096 B = one (8,128) f32 tile
        smem("VMEM", data_width=32, banks=1024,
             depth=(128 * 2**20) // 4096),
        smem("SMEM", data_width=32, banks=1, depth=4096),
    ],
    computes=[
        scu("MXU", [
            scap("GEMM", sop("f32", 128, 128),
                 [sop("bf16", 128, 128), sop("bf16", 128, 128),
                  sop("f32", 128, 128)],
                 geometry=(128, 128, 128)),
            scap("MAC", sop("f32", 128, 128),
                 [sop("bf16", 128, 128), sop("bf16", 128, 128),
                  sop("f32", 128, 128)],
                 geometry=(128, 128, 128)),
            scap("MMUL", sop("f32", 128, 128),
                 [sop("bf16", 128, 128), sop("bf16", 128, 128)],
                 geometry=(128, 128, 128)),
            scap("GEMM", sop("i32", 128, 128),
                 [sop("i8", 128, 128), sop("i8", 128, 128),
                  sop("i32", 128, 128)],
                 geometry=(128, 128, 128)),
        ], slot="mxu"),
        scu("VPU", [
            *(scap(n, sop("f32", 8, 128), [sop("f32", 8, 128)] * 2)
              for n in BINARY),
            *(scap(n, sop("f32", 8, 128), [sop("f32", 8, 128)])
              for n in UNARY),
            scap("MAC", sop("f32", 8, 128), [sop("f32", 8, 128)] * 3,
                 geometry=(8, 128, 1)),
            *(scap(n, sop("i32", 8, 128), [sop("i32", 8, 128)] * 2)
              for n in BINARY),
        ], slot="vpu"),
    ],
    edges=[
        sedge("HBM", "VMEM", bandwidth=7168, bidir=True),
        sedge("VMEM", "MXU", bandwidth=32 * 1024, bidir=True),
        sedge("VMEM", "VPU", bandwidth=32 * 1024, bidir=True),
        sedge("SMEM", "VPU", bandwidth=32, bidir=True),
    ],
    addr_bits=32,
)


# the port's own covenant, ``core.h100.H100_SPEC``, beside the
# reference's four (which never registers it)
BUNDLED_SPECS: dict[str, ACGSpec] = {
    s.name: s for s in (EXAMPLE_SPEC, DNNWEAVER_SPEC, HVX_SPEC, TPU_V5E_SPEC,
                        H100_SPEC)
}


# ---------------------------------------------------------------------------
# the registry: string names (incl. derived variants) -> ACGs
# ---------------------------------------------------------------------------

# name -> zero-arg ACG factory.  Spec-registered entries carry the spec on
# the factory (``factory.spec``) so variants derive from data, not from a
# graph snapshot; plain factories (``driver.register_target``) still work
# and are snapshotted on demand.
TARGETS: dict[str, object] = {}


def _spec_factory(spec: ACGSpec):
    def factory() -> ACG:
        return ACG.from_spec(spec)

    factory.spec = spec
    factory.__name__ = f"{spec.name}_from_spec"
    return factory


def register_spec(spec: ACGSpec, name: str | None = None,
                  validate: bool = True) -> ACGSpec:
    """Register a declarative target.  ``repro_torch.compile(layer, name)``
    (and
    every other driver entry point) resolves it — including ``name@k=v``
    derived variants — from then on.  Registering under an alias renames
    the spec, so canonical derived-variant names stay resolvable."""
    import dataclasses

    from .spec import validate_spec

    if name is not None and name != spec.name:
        spec = dataclasses.replace(spec, name=name)
    if validate:
        validate_spec(spec)
    TARGETS[spec.name] = _spec_factory(spec)
    return spec


for _spec in BUNDLED_SPECS.values():
    register_spec(_spec, validate=False)


def list_targets() -> list[str]:
    return sorted(TARGETS)


def _lookup(name: str):
    """-> (factory, registered_spec_or_None, overrides_suffix).  THE name
    resolution rule: an exact registered name wins — including names that
    themselves contain ``@`` (e.g. a registered derived spec) — before
    falling back to the ``base@overrides`` variant grammar."""
    factory = TARGETS.get(name)
    if factory is not None:
        return factory, getattr(factory, "spec", None), ""
    base, _, overrides = name.partition("@")
    factory = TARGETS.get(base)
    if factory is None:
        raise KeyError(
            f"unknown target {base!r}; known: {list_targets()}")
    return factory, getattr(factory, "spec", None), overrides


def resolve_factory(name: str):
    """The registered factory a target name resolves against, or None —
    a thin view over ``_lookup`` so the driver's memo-invalidation
    identity and actual resolution can never diverge."""
    try:
        return _lookup(name)[0]
    except KeyError:
        return None


def get_spec(name: str) -> ACGSpec:
    """The covenant spec behind a target name.  Variant names
    (``base@k=v``) return the derived spec; factory-registered targets are
    snapshotted via ``acg.to_spec()``."""
    factory, spec, overrides = _lookup(name)
    if spec is None:
        spec = factory().to_spec()
    if overrides:
        spec = spec.derive(**parse_overrides(overrides))
    return spec


def get_target(name: str) -> ACG:
    """Resolve a target name to a fresh ACG.  ``base@key=value,...`` names
    derive a variant from the base spec on the fly; BYOC pass hooks
    installed by the base factory carry over to variants."""
    factory, spec, overrides = _lookup(name)
    if not overrides:
        return factory()
    hooks_donor = None
    if spec is None:
        hooks_donor = factory()
        spec = hooks_donor.to_spec()
    acg = ACG.from_spec(spec.derive(**parse_overrides(overrides)))
    if hooks_donor is not None:
        acg.pass_overrides.update(hooks_donor.pass_overrides)
        acg.extra_passes.extend(hooks_donor.extra_passes)
    return acg


# ---------------------------------------------------------------------------
# thin back-compat constructors
# ---------------------------------------------------------------------------


def example_acg() -> ACG:
    return ACG.from_spec(EXAMPLE_SPEC)


def dnnweaver_acg() -> ACG:
    return ACG.from_spec(DNNWEAVER_SPEC)


def hvx_acg() -> ACG:
    return ACG.from_spec(HVX_SPEC)


def tpu_v5e_acg() -> ACG:
    return ACG.from_spec(TPU_V5E_SPEC)


__all__ = [
    "BINARY", "BUNDLED_SPECS", "DNNWEAVER_SPEC", "EXAMPLE_SPEC", "HVX_SPEC",
    "H100_SPEC", "TARGETS", "TPU_V5E_SPEC", "UNARY", "dnnweaver_acg",
    "example_acg", "get_spec", "get_target", "hvx_acg", "list_targets",
    "register_spec", "resolve_factory", "tpu_v5e_acg",
]
