"""Declarative Covenant specs — the ACG as *data*.

The paper's adaptability claim (§2: design changes absorbed "without
complete compiler redevelopment") only holds if an accelerator can be
described without writing compiler-adjacent code.  An ``ACGSpec`` is that
description: a frozen, serializable value covering everything an ACG
carries — memories, compute capabilities, edges, mnemonic layouts, cost
attributes — with

* ``ACG.from_spec(spec)`` / ``acg.to_spec()`` round-tripping losslessly
  (byte-identical instruction streams, tested per paper layer);
* ``spec.fingerprint()`` — a canonical content hash that is the ACG
  component of every compile-cache and ``ArtifactStore`` key, so two
  distinct in-memory ACGs can never alias on a name and a mutated ACG can
  never collect a stale warm hit;
* ``spec.derive(**overrides)`` — architecture families as data: scale the
  PE array (``pe="32x32"``), resize a scratchpad (``memories={"VMEM1":
  {"depth": 4096}}``), re-rate an interconnect, and recompile every paper
  layer against the variant.  Derived specs get a canonical
  ``base@key=value`` name that the target registry resolves directly
  (``repro_torch.compile(layer, "dnnweaver@pe=32x32")``).

``validate_spec`` performs the structural half of covenant validation
(``core/covenant.py`` holds the codelet-vs-ACG half): every problem is a
named, actionable message instead of a ``KeyError`` three passes deep.

The port's copy of ``repro.core.spec``, with the same logic.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Iterable, Mapping, Sequence

from .dtypes import dt

# ---------------------------------------------------------------------------
# spec data model — frozen, hashable, JSON-serializable
# ---------------------------------------------------------------------------

# One capability operand as data: (dtype name, *shape), e.g. ("i8", 64, 64).
Operand = tuple


@dataclasses.dataclass(frozen=True)
class MemorySpec:
    name: str
    data_width: int   # bits per bank access
    banks: int
    depth: int
    offchip: bool = False


@dataclasses.dataclass(frozen=True)
class CapabilitySpec:
    name: str
    outputs: tuple[Operand, ...]
    inputs: tuple[Operand, ...]
    cycles: int = 1
    geometry: tuple[int, int, int] | None = None


@dataclasses.dataclass(frozen=True)
class ComputeSpec:
    name: str
    capabilities: tuple[CapabilitySpec, ...]
    slot: str | None = None


@dataclasses.dataclass(frozen=True)
class EdgeSpec:
    src: str
    dst: str
    bandwidth: int    # bits per transfer operation
    latency: int = 1


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    name: str
    bits: int
    enum: tuple[str, ...] | None = None   # efield when set, ifield otherwise
    rw: str | None = None                 # "r" | "w" | None


@dataclasses.dataclass(frozen=True)
class MnemonicSpec:
    name: str
    opcode: int
    fields: tuple[FieldSpec, ...]
    attrs: tuple[tuple[str, object], ...] = ()


@dataclasses.dataclass(frozen=True)
class ACGSpec:
    """A complete, declarative covenant: everything ``ACG.from_spec`` needs.

    Node order is significant — mnemonic enum fields index memories and
    compute units by declaration order — so ``memories`` / ``computes`` /
    ``edges`` / ``mnemonics`` are ordered tuples, not sets.
    """

    name: str
    memories: tuple[MemorySpec, ...]
    computes: tuple[ComputeSpec, ...]
    edges: tuple[EdgeSpec, ...]
    mnemonics: tuple[MnemonicSpec, ...]
    issue_slots: int = 1
    loop_overhead: int = 1
    # ((compute node, capability name), (staging memory per operand, output last))
    operand_ports: tuple[tuple[tuple[str, str], tuple[str, ...]], ...] = ()

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> dict:
        # hand-rolled (dataclasses.asdict recursion is ~8x slower, and this
        # runs on every compile to fingerprint the target)
        return {
            "name": self.name,
            "issue_slots": self.issue_slots,
            "loop_overhead": self.loop_overhead,
            "memories": [
                {"name": m.name, "data_width": m.data_width,
                 "banks": m.banks, "depth": m.depth, "offchip": m.offchip}
                for m in self.memories],
            "computes": [
                {"name": c.name, "slot": c.slot, "capabilities": [
                    {"name": k.name,
                     "outputs": [list(o) for o in k.outputs],
                     "inputs": [list(i) for i in k.inputs],
                     "cycles": k.cycles,
                     "geometry": (list(k.geometry)
                                  if k.geometry is not None else None)}
                    for k in c.capabilities]}
                for c in self.computes],
            "edges": [
                {"src": e.src, "dst": e.dst, "bandwidth": e.bandwidth,
                 "latency": e.latency} for e in self.edges],
            # attrs and operand_ports are canonically ordered HERE, not only
            # in spec_of(): the fingerprint must be identical no matter how
            # the spec was constructed (builder, from_json, direct), or the
            # round-trip identity and the driver's spec memo break
            "mnemonics": [
                {"name": m.name, "opcode": m.opcode, "fields": [
                    {"name": f.name, "bits": f.bits,
                     "enum": (list(f.enum) if f.enum is not None else None),
                     "rw": f.rw} for f in m.fields],
                 "attrs": sorted((list(kv) for kv in m.attrs),
                                 key=lambda kv: kv[0])}
                for m in self.mnemonics],
            "operand_ports": sorted(
                ([list(k), list(v)] for k, v in self.operand_ports),
                key=lambda e: e[0]),
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "ACGSpec":
        return cls(
            name=d["name"],
            memories=tuple(MemorySpec(**m) for m in d["memories"]),
            computes=tuple(
                ComputeSpec(
                    name=c["name"],
                    capabilities=tuple(
                        CapabilitySpec(
                            name=k["name"],
                            outputs=tuple(tuple(o) for o in k["outputs"]),
                            inputs=tuple(tuple(i) for i in k["inputs"]),
                            cycles=k.get("cycles", 1),
                            geometry=(tuple(k["geometry"])
                                      if k.get("geometry") else None),
                        ) for k in c["capabilities"]),
                    slot=c.get("slot"),
                ) for c in d["computes"]),
            edges=tuple(EdgeSpec(**e) for e in d["edges"]),
            mnemonics=tuple(
                MnemonicSpec(
                    name=m["name"], opcode=m["opcode"],
                    fields=tuple(
                        FieldSpec(name=f["name"], bits=f["bits"],
                                  enum=(tuple(f["enum"]) if f.get("enum")
                                        else None),
                                  rw=f.get("rw"))
                        for f in m["fields"]),
                    attrs=tuple((k, v) for k, v in m.get("attrs", ())),
                ) for m in d["mnemonics"]),
            issue_slots=d.get("issue_slots", 1),
            loop_overhead=d.get("loop_overhead", 1),
            operand_ports=tuple(
                ((n, c), tuple(ports))
                for (n, c), ports in d.get("operand_ports", ())),
        )

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ACGSpec":
        return cls.from_dict(json.loads(text))

    def fingerprint(self) -> str:
        """Canonical content hash — the ACG component of compile-cache and
        artifact-store keys.  Covers *everything* in the spec, including
        mnemonic field layouts (which the old describe()-based hash missed),
        so structurally different targets can never alias.

        Mnemonic ``attrs`` holding non-JSON values hash via ``repr``:
        reprs that embed object addresses make the fingerprint
        process-local — distinct values never alias (the safe direction,
        same policy as the pipeline's closure-capture tags), at the cost
        of cross-process warm store hits for such exotic targets."""
        payload = json.dumps(self.to_dict(), sort_keys=True,
                             separators=(",", ":"), default=repr)
        return hashlib.sha256(payload.encode()).hexdigest()

    # -- derivation ----------------------------------------------------------
    def derive(self, name: str | None = None, *, pe: str | tuple | None = None,
               issue_slots: int | None = None, loop_overhead: int | None = None,
               memories: Mapping[str, Mapping] | None = None,
               edges: Mapping[tuple[str, str], Mapping] | None = None,
               ) -> "ACGSpec":
        """A perturbed copy of this spec — one member of an architecture
        family (the paper's adaptability claim as a runnable sweep).

        * ``pe="32x32"`` (or ``(32, 32)``) rescales the PE array: on the
          PE-grid unit (the one owning the largest matmul geometry by
          invocation size), dimensions equal to the base array dimension
          are replaced in operand shapes and geometry alike; every other
          unit — including SIMD/vector lanes that happen to match the
          array width — is untouched, so the sweep varies one design
          axis.  Square arrays only.
        * ``memories={"VMEM1": {"depth": 4096}}`` resizes storage nodes.
        * ``edges={("DRAM", "IBUF"): {"bandwidth": 512}}`` re-rates
          interconnect.
        * ``issue_slots`` / ``loop_overhead`` override the scalar knobs.

        Unless ``name`` is given, the derived spec is named canonically —
        ``base@key=value,...`` with sorted tokens — which the target
        registry parses back, so the name alone reproduces the variant.
        """
        new_mem = self.memories
        new_cu = self.computes
        new_edges = self.edges
        tokens: dict[str, str] = _name_tokens(self.name)
        base = self.name.partition("@")[0]

        if pe is not None:
            rows, cols = _parse_pe(pe)
            grid = _pe_grid(self.computes)
            if grid is None:
                raise SpecError(self.name, [
                    "pe override: no capability with matmul-family geometry "
                    "to rescale"])
            unit, old = grid
            if rows != cols:
                raise SpecError(self.name, [
                    f"pe override {rows}x{cols}: only square PE arrays are "
                    f"derivable (base array is {old}x{old})"])
            new_cu = tuple(_scale_compute(c, old, rows) if c.name == unit
                           else c for c in new_cu)
            tokens["pe"] = f"{rows}x{cols}"
        if memories:
            by_name = {m.name: m for m in new_mem}
            for mname, fields in memories.items():
                if mname not in by_name:
                    raise SpecError(self.name, [
                        f"memory override: no memory node {mname!r} "
                        f"(have: {sorted(by_name)})"])
                bad = set(fields) - {"data_width", "banks", "depth", "offchip"}
                if bad:
                    raise SpecError(self.name, [
                        f"memory override {mname}: unknown field(s) "
                        f"{sorted(bad)}"])
                by_name[mname] = dataclasses.replace(by_name[mname], **fields)
                for f, val in sorted(fields.items()):
                    tokens[f"{mname}.{f}"] = str(val)
            new_mem = tuple(by_name[m.name] for m in new_mem)
        if edges:
            known = {(e.src, e.dst) for e in new_edges}
            for key, fields in edges.items():
                if tuple(key) not in known:
                    raise SpecError(self.name, [
                        f"edge override: no edge {key[0]}->{key[1]}"])
                bad = set(fields) - {"bandwidth", "latency"}
                if bad:
                    raise SpecError(self.name, [
                        f"edge override {key[0]}->{key[1]}: unknown "
                        f"field(s) {sorted(bad)}"])
                for f, val in sorted(fields.items()):
                    tokens[f"edge.{key[0]}.{key[1]}.{f}"] = str(val)
            new_edges = tuple(
                dataclasses.replace(e, **dict(edges.get((e.src, e.dst), {})))
                for e in new_edges)
        if issue_slots is not None:
            tokens["issue_slots"] = str(issue_slots)
        if loop_overhead is not None:
            tokens["loop_overhead"] = str(loop_overhead)

        if name is None:
            suffix = ",".join(f"{k}={v}" for k, v in sorted(tokens.items()))
            name = f"{base}@{suffix}" if suffix else base
        out = dataclasses.replace(
            self, name=name, memories=new_mem, computes=new_cu,
            edges=new_edges,
            issue_slots=(issue_slots if issue_slots is not None
                         else self.issue_slots),
            loop_overhead=(loop_overhead if loop_overhead is not None
                           else self.loop_overhead))
        validate_spec(out)
        return out

    def __repr__(self) -> str:
        return (f"ACGSpec({self.name!r}, {len(self.memories)} mem, "
                f"{len(self.computes)} cu, {len(self.edges)} edges, "
                f"{len(self.mnemonics)} mnemonics)")


def _name_tokens(name: str) -> dict[str, str]:
    """The ``k=v`` override tokens already present in a derived name, so
    deriving a derived spec merges instead of nesting ``@`` suffixes."""
    _, sep, suffix = name.partition("@")
    if not sep:
        return {}
    out = {}
    for tok in suffix.split(","):
        k, _, v = tok.partition("=")
        if k and v:
            out[k] = v
    return out


def _parse_pe(pe) -> tuple[int, int]:
    if isinstance(pe, str):
        parts = pe.lower().split("x")
        try:
            if len(parts) != 2:
                raise ValueError
            return int(parts[0]), int(parts[1])
        except ValueError:
            raise SpecError("pe", [f"pe override must look like '32x32', "
                                   f"got {pe!r}"]) from None
    rows, cols = pe
    return int(rows), int(cols)


def _pe_grid(computes: Sequence[ComputeSpec]) -> tuple[str, int] | None:
    """(unit name, base PE-array dimension) of the PE grid: the compute
    unit owning the capability with the largest geometry *product* (MACs
    per invocation — the array size), whose max dim is the array
    dimension.  Distinguishes the systolic array from e.g. a SIMD unit
    whose lane count happens to equal the array width."""
    best: tuple[str, int] | None = None
    best_size = 1
    for c in computes:
        for k in c.capabilities:
            if k.geometry is not None:
                size = k.geometry[0] * k.geometry[1] * k.geometry[2]
                if size > best_size and max(k.geometry) > 1:
                    best = (c.name, max(k.geometry))
                    best_size = size
    return best


def _scale_compute(c: ComputeSpec, old: int, new: int) -> ComputeSpec:
    """Rescale the PE-grid unit: only capabilities whose *geometry* carries
    the base array dimension are touched — and ``derive`` only calls this
    for the unit ``_pe_grid`` identified, so sibling vector/SIMD units
    (even ones whose lane count equals the array width) keep their shapes
    and a ``pe=`` sweep varies exactly one design axis."""
    def dim(d: int) -> int:
        return new if d == old else d

    def operand(o: Operand) -> Operand:
        return (o[0],) + tuple(dim(d) for d in o[1:])

    def scale(k: CapabilitySpec) -> CapabilitySpec:
        if k.geometry is None or old not in k.geometry:
            return k
        return dataclasses.replace(
            k,
            outputs=tuple(operand(o) for o in k.outputs),
            inputs=tuple(operand(i) for i in k.inputs),
            geometry=tuple(dim(d) for d in k.geometry))

    return dataclasses.replace(
        c, capabilities=tuple(scale(k) for k in c.capabilities))


def parse_overrides(text: str) -> dict:
    """Parse a variant suffix (``"pe=32x32,VMEM1.depth=4096"``) into
    ``derive()`` keyword arguments.  Grammar, one ``key=value`` per comma:

    * ``pe=RxC``                      — PE-array rescale
    * ``issue_slots=N`` / ``loop_overhead=N``
    * ``<MEM>.<field>=N``             — memory node override
    * ``edge.<SRC>.<DST>.<field>=N``  — edge override
    """
    def as_int(key: str, val: str) -> int:
        try:
            return int(val)
        except ValueError:
            raise SpecError(text, [
                f"override {key}={val!r}: value must be an integer"]) \
                from None

    kwargs: dict = {}
    for tok in filter(None, (t.strip() for t in text.split(","))):
        key, sep, val = tok.partition("=")
        if not sep or not val:
            raise SpecError(text, [f"override token {tok!r} is not "
                                   f"'key=value'"])
        if key == "pe":
            kwargs["pe"] = val
        elif key in ("issue_slots", "loop_overhead"):
            kwargs[key] = as_int(key, val)
        elif key.startswith("edge."):
            parts = key.split(".")
            if len(parts) != 4:
                raise SpecError(text, [
                    f"edge override {key!r} must be "
                    f"'edge.<SRC>.<DST>.<field>'"])
            _, src, dst, field = parts
            kwargs.setdefault("edges", {}).setdefault((src, dst), {})[
                field] = as_int(key, val)
        elif "." in key:
            mname, _, field = key.partition(".")
            if field == "offchip":
                low = val.lower()
                if low not in ("true", "false", "1", "0"):
                    raise SpecError(text, [
                        f"override {key}={val!r}: value must be a boolean "
                        f"(true/false/1/0)"])
                value: object = low in ("true", "1")
            else:
                value = as_int(key, val)
            kwargs.setdefault("memories", {}).setdefault(mname, {})[
                field] = value
        else:
            raise SpecError(text, [
                f"unknown override key {key!r}; expected pe, issue_slots, "
                f"loop_overhead, <MEM>.<field> or edge.<SRC>.<DST>.<field>"])
    return kwargs


# ---------------------------------------------------------------------------
# terse spec builders (mirror acg.cap / acg.ospec)
# ---------------------------------------------------------------------------


def smem(name: str, data_width: int, banks: int, depth: int,
         offchip: bool = False) -> MemorySpec:
    return MemorySpec(name, data_width, banks, depth, offchip)


def sop(dtype: str, *shape: int) -> Operand:
    """One capability operand: ``sop("i8", 64, 64)``."""
    return (dtype,) + (shape if shape else (1,))


def scap(name: str, outputs, inputs, cycles: int = 1,
         geometry: tuple[int, int, int] | None = None) -> CapabilitySpec:
    # a bare operand tuple is promoted to a one-operand list on both sides
    if outputs and isinstance(outputs[0], str):
        outputs = (outputs,)
    if inputs and isinstance(inputs[0], str):
        inputs = (inputs,)
    return CapabilitySpec(name, tuple(tuple(o) for o in outputs),
                          tuple(tuple(i) for i in inputs), cycles,
                          tuple(geometry) if geometry else None)


def scu(name: str, capabilities: Iterable[CapabilitySpec],
        slot: str | None = None) -> ComputeSpec:
    return ComputeSpec(name, tuple(capabilities), slot)


def sedge(src: str, dst: str, bandwidth: int, latency: int = 1,
          bidir: bool = False) -> list[EdgeSpec]:
    out = [EdgeSpec(src, dst, bandwidth, latency)]
    if bidir:
        out.append(EdgeSpec(dst, src, bandwidth, latency))
    return out


# Elementwise capability names shared across targets (Table 1).
UNARY = ("RELU", "SIGMOID", "TANH")
BINARY = ("ADD", "SUB", "MUL", "DIV", "MAX", "MIN")


def common_mnemonics(mem_names: Sequence[str], unit_names: Sequence[str],
                     addr_bits: int = 24) -> tuple[MnemonicSpec, ...]:
    """The target-independent mnemonic vocabulary (§2.1.4): XFER / ALLOC /
    LOOPI plus one mnemonic per Table-1 capability family.  Per-target
    variation is only field widths and node enums — the paper's
    'semantics-free' reuse claim as a spec generator."""
    mems = tuple(mem_names)
    units = tuple(unit_names)
    out = [
        MnemonicSpec("XFER", 0x01, (
            FieldSpec("SRC_NODE", 4, mems, "r"),
            FieldSpec("DST_NODE", 4, mems, "w"),
            FieldSpec("SRC_ADDR", addr_bits, None, "r"),
            FieldSpec("DST_ADDR", addr_bits, None, "w"),
            FieldSpec("ROWS", 16),
            FieldSpec("ROW_BYTES", 24),
            FieldSpec("SRC_STRIDE", 24),
            FieldSpec("DST_STRIDE", 24),
        )),
        MnemonicSpec("ALLOC", 0x02, (
            FieldSpec("NODE", 4, mems, "w"),
            FieldSpec("ADDR", addr_bits, None, "w"),
            FieldSpec("SIZE", 24),
        )),
        MnemonicSpec("LOOPI", 0x03, (
            FieldSpec("LEVEL", 8), FieldSpec("TRIP", 24),
        )),
    ]
    for i, name in enumerate(UNARY):
        out.append(MnemonicSpec(name, 0x10 + i, (
            FieldSpec("SRC_ADDR", addr_bits, None, "r"),
            FieldSpec("DST_ADDR", addr_bits, None, "w"),
            FieldSpec("N", 16),
            FieldSpec("TGT", 3, units),
        )))
    for i, name in enumerate(BINARY):
        out.append(MnemonicSpec(name, 0x20 + i, (
            FieldSpec("SRC1_ADDR", addr_bits, None, "r"),
            FieldSpec("SRC2_ADDR", addr_bits, None, "r"),
            FieldSpec("DST_ADDR", addr_bits, None, "w"),
            FieldSpec("N", 16),
            FieldSpec("TGT", 3, units),
        )))
    for i, name in enumerate(("MAC", "GEMM", "MMUL", "MVMUL")):
        out.append(MnemonicSpec(name, 0x30 + i, (
            FieldSpec("SRC1_ADDR", addr_bits, None, "r"),
            FieldSpec("SRC2_ADDR", addr_bits, None, "r"),
            FieldSpec("ACC_ADDR", addr_bits, None, "r"),
            FieldSpec("DST_ADDR", addr_bits, None, "w"),
            FieldSpec("M", 16), FieldSpec("N", 16), FieldSpec("K", 16),
            FieldSpec("LD1", 16), FieldSpec("LD2", 16), FieldSpec("LDD", 16),
            FieldSpec("TGT", 3, units),
        )))
    return tuple(out)


def acg_spec(name: str, memories, computes, edges, *,
             mnemonics: Sequence[MnemonicSpec] | None = None,
             addr_bits: int = 24, issue_slots: int = 1,
             loop_overhead: int = 1, operand_ports=()) -> ACGSpec:
    """Assemble a normalized ``ACGSpec``.  ``edges`` may nest (the
    ``sedge(..., bidir=True)`` idiom); ``mnemonics=None`` derives the
    common vocabulary at ``addr_bits`` — always materialized explicitly so
    the canonical form (and fingerprint) never depends on shorthand."""
    memories = tuple(memories)
    computes = tuple(computes)
    flat_edges: list[EdgeSpec] = []
    for e in edges:
        flat_edges.extend(e if isinstance(e, (list, tuple)) else [e])
    if mnemonics is None:
        mnemonics = common_mnemonics([m.name for m in memories],
                                     [c.name for c in computes], addr_bits)
    ports = tuple(sorted(
        ((tuple(k), tuple(v)) for k, v in
         (operand_ports.items() if isinstance(operand_ports, dict)
          else operand_ports))))
    return ACGSpec(name=name, memories=memories, computes=computes,
                   edges=tuple(flat_edges), mnemonics=tuple(mnemonics),
                   issue_slots=issue_slots, loop_overhead=loop_overhead,
                   operand_ports=ports)


# ---------------------------------------------------------------------------
# ACG <-> spec conversion
# ---------------------------------------------------------------------------


def build_acg(spec: ACGSpec):
    """Materialize the graph described by ``spec`` (``ACG.from_spec``)."""
    from .acg import ACG, Capability, Field, OperandSpec

    validate_spec(spec)
    g = ACG(spec.name, issue_slots=spec.issue_slots,
            loop_overhead=spec.loop_overhead)
    for m in spec.memories:
        g.add_memory(m.name, m.data_width, m.banks, m.depth, m.offchip)

    def operand(o: Operand) -> OperandSpec:
        return OperandSpec(dt(o[0]), tuple(int(d) for d in o[1:]))

    for c in spec.computes:
        g.add_compute(c.name, [
            Capability(k.name, tuple(operand(i) for i in k.inputs),
                       tuple(operand(o) for o in k.outputs), k.cycles,
                       k.geometry)
            for k in c.capabilities], slot=c.slot)
    for e in spec.edges:
        g.connect(e.src, e.dst, e.bandwidth, e.latency)
    for (node, capname), ports in spec.operand_ports:
        g.operand_ports[(node, capname)] = tuple(ports)
    for m in spec.mnemonics:
        g.define_mnemonic(m.name, m.opcode,
                          [Field(f.name, f.bits, f.enum, f.rw)
                           for f in m.fields], **dict(m.attrs))
    return g


def spec_of(acg) -> ACGSpec:
    """Snapshot a live ACG back into its canonical spec (``acg.to_spec``)."""
    from .acg import MemoryNode

    def operand(o) -> Operand:
        return (o.dtype.name,) + tuple(o.shape)

    memories = tuple(
        MemorySpec(m.name, m.data_width, m.banks, m.depth, m.offchip)
        for m in acg.nodes.values() if isinstance(m, MemoryNode))
    computes = tuple(
        ComputeSpec(c.name, tuple(
            CapabilitySpec(k.name, tuple(operand(o) for o in k.outputs),
                           tuple(operand(i) for i in k.inputs), k.cycles,
                           k.geometry)
            for k in c.capabilities), c.slot)
        for c in acg.nodes.values() if not isinstance(c, MemoryNode))
    edges = tuple(EdgeSpec(e.src, e.dst, e.bandwidth, e.latency)
                  for e in acg.edges)
    mnemonics = tuple(
        MnemonicSpec(m.name, m.opcode,
                     tuple(FieldSpec(f.name, f.bits, f.enum, f.rw)
                           for f in m.fields),
                     tuple(sorted(m.attrs.items())))
        for m in acg.mnemonics.values())
    ports = tuple(sorted((tuple(k), tuple(v))
                         for k, v in acg.operand_ports.items()))
    return ACGSpec(name=acg.name, memories=memories, computes=computes,
                   edges=edges, mnemonics=mnemonics,
                   issue_slots=acg.issue_slots,
                   loop_overhead=acg.loop_overhead, operand_ports=ports)


# ---------------------------------------------------------------------------
# structural validation
# ---------------------------------------------------------------------------


class SpecError(ValueError):
    """A covenant spec is structurally unsound; ``problems`` names each
    issue (the diagnostics contract: no bare KeyErrors)."""

    def __init__(self, spec_name: str, problems: list[str]):
        self.spec_name = spec_name
        self.problems = list(problems)
        bullet = "\n  - ".join(self.problems)
        super().__init__(
            f"invalid covenant spec {spec_name!r}:\n  - {bullet}")


def validate_spec(spec: ACGSpec, *, raise_on_error: bool = True) -> list[str]:
    """Structural checks over a covenant spec.  Returns the problem list
    (empty when sound); raises ``SpecError`` on problems unless
    ``raise_on_error=False``."""
    p: list[str] = []
    if not spec.name:
        p.append("spec has no name")
    names: list[str] = [m.name for m in spec.memories] + \
        [c.name for c in spec.computes]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        p.append(f"duplicate node name(s): {sorted(dupes)}")
    if not spec.memories:
        p.append("no memory nodes (operands need a home)")
    if not spec.computes:
        p.append("no compute nodes (nothing can execute a capability)")
    if spec.issue_slots < 1:
        p.append(f"issue_slots must be >= 1, got {spec.issue_slots}")
    if spec.loop_overhead < 0:
        p.append(f"loop_overhead must be >= 0, got {spec.loop_overhead}")
    for m in spec.memories:
        for field in ("data_width", "banks", "depth"):
            if getattr(m, field) <= 0:
                p.append(f"memory {m.name}: {field} must be positive, "
                         f"got {getattr(m, field)}")
    for c in spec.computes:
        if not c.capabilities:
            p.append(f"compute {c.name}: declares no capabilities")
        for k in c.capabilities:
            if not k.outputs:
                p.append(f"compute {c.name}: capability {k.name} has no "
                         f"outputs")
            for o in list(k.outputs) + list(k.inputs):
                try:
                    dt(o[0])
                except KeyError:
                    p.append(f"compute {c.name}: capability {k.name} uses "
                             f"unknown dtype {o[0]!r}")
                if any(not isinstance(d, int) or d <= 0 for d in o[1:]):
                    p.append(f"compute {c.name}: capability {k.name} operand "
                             f"{o} has a non-positive or non-integer "
                             f"dimension")
            if k.geometry is not None and (
                    len(k.geometry) != 3 or
                    any(not isinstance(g, int) or g <= 0
                        for g in k.geometry)):
                p.append(f"compute {c.name}: capability {k.name} geometry "
                         f"{k.geometry} must be 3 positive integer dims "
                         f"(m, n, k)")
            if k.cycles < 0:
                p.append(f"compute {c.name}: capability {k.name} cycles "
                         f"must be >= 0")
    known = set(names)
    for e in spec.edges:
        for end in (e.src, e.dst):
            if end not in known:
                p.append(f"edge {e.src}->{e.dst}: unknown node {end!r}")
        if e.bandwidth <= 0:
            p.append(f"edge {e.src}->{e.dst}: bandwidth must be positive, "
                     f"got {e.bandwidth}")
        if e.latency < 0:
            p.append(f"edge {e.src}->{e.dst}: latency must be >= 0")
    touched = {e.src for e in spec.edges} | {e.dst for e in spec.edges}
    for c in spec.computes:
        if c.name not in touched:
            p.append(f"compute {c.name}: connected to no edge — no memory "
                     f"can feed it")
    opcodes: dict[int, str] = {}
    mnames: set[str] = set()
    for m in spec.mnemonics:
        if m.name in mnames:
            p.append(f"duplicate mnemonic {m.name!r}")
        mnames.add(m.name)
        if m.opcode in opcodes:
            p.append(f"mnemonic {m.name}: opcode {m.opcode:#x} collides "
                     f"with {opcodes[m.opcode]!r}")
        else:
            opcodes[m.opcode] = m.name
        for f in m.fields:
            if f.bits <= 0:
                p.append(f"mnemonic {m.name}: field {f.name} has "
                         f"non-positive width")
            if f.enum is not None and len(f.enum) > (1 << f.bits):
                p.append(f"mnemonic {m.name}: field {f.name} enumerates "
                         f"{len(f.enum)} values in {f.bits} bits")
            if f.rw not in (None, "r", "w"):
                p.append(f"mnemonic {m.name}: field {f.name} rw must be "
                         f"'r', 'w' or None")
    cap_names = {(c.name, k.name) for c in spec.computes
                 for k in c.capabilities}
    mem_names = {m.name for m in spec.memories}
    for (node, capname), ports in spec.operand_ports:
        if (node, capname) not in cap_names:
            p.append(f"operand_ports ({node}, {capname}): no such "
                     f"capability on that compute node")
        for port in ports:
            if port not in mem_names:
                p.append(f"operand_ports ({node}, {capname}): staging port "
                         f"{port!r} is not a memory node")
    if p and raise_on_error:
        raise SpecError(spec.name or "<unnamed>", p)
    return p


__all__ = [
    "ACGSpec", "BINARY", "CapabilitySpec", "ComputeSpec", "EdgeSpec",
    "FieldSpec", "MemorySpec", "MnemonicSpec", "SpecError", "UNARY",
    "acg_spec", "build_acg", "common_mnemonics", "parse_overrides", "scap",
    "scu", "sedge", "smem", "sop", "spec_of", "validate_spec",
]
