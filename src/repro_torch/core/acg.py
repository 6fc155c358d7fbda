"""Architecture Covenant Graph (ACG) — the paper's §2 abstraction.

An ACG is a directed graph whose vertices are *programmable* architecture
components and whose edges are programmable interconnect:

* ``MemoryNode``  — software-managed storage with ``data_width`` (bits served
  by one bank access), ``banks`` (parallel banks; ``data_width*banks`` is the
  addressable element) and ``depth`` (number of addressable elements).
* ``ComputeNode`` — functional unit described *only* through granularity-typed
  ``Capability`` signatures, e.g. ``(i32,64)=GEMM((i8,64),(i8,64,64),(i32,64))``.
* ``Edge``        — interconnect with a ``bandwidth`` attribute: bits moved by
  one transfer operation over that edge.

Non-programmable components (controllers, schedule memories) are deliberately
not represented — the ACG only carries what code generation needs.

Mnemonics (§2.1.4) are semantics-free binary code definitions: an opcode and
an ordered list of fixed-width fields (``ifield`` constants / ``efield``
enumerations).  They are attributes of the ACG, *not* of any execution model,
which is what lets the same code-generation machinery retarget accelerators
with systolic, dataflow or VLIW semantics.

The port's copy of ``repro.core.acg``, with the same logic.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Iterable, Mapping, Sequence

import networkx as nx

from .dtypes import Dtype, dt

# ---------------------------------------------------------------------------
# Capabilities
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OperandSpec:
    """One operand of a capability: dtype + element geometry.

    ``shape`` is the element count per invocation; multi-dim shapes express
    things like DNNWeaver's systolic GEMM ``(i8,64,64)`` weight operand.
    """

    dtype: Dtype
    shape: tuple[int, ...]

    @property
    def elems(self) -> int:
        return math.prod(self.shape)

    @property
    def bits(self) -> int:
        return self.elems * self.dtype.bits

    def __str__(self) -> str:
        dims = ",".join(str(d) for d in self.shape)
        return f"({self.dtype},{dims})"


def ospec(dtype: str | Dtype, *shape: int) -> OperandSpec:
    d = dt(dtype) if isinstance(dtype, str) else dtype
    return OperandSpec(d, tuple(shape) if shape else (1,))


@dataclasses.dataclass(frozen=True)
class Capability:
    """A coarse-grained operation a compute node can perform (§2.1.3)."""

    name: str  # RELU/ADD/MUL/GEMM/... (Table 1)
    inputs: tuple[OperandSpec, ...]
    outputs: tuple[OperandSpec, ...]
    # optional cycle cost per invocation; defaults to 1 (systolic/SIMD issue).
    cycles: int = 1
    # matmul-family invocation geometry (m, n, k): output tile m*n, reduction
    # depth k consumed per invocation.  None for elementwise capabilities,
    # whose granularity is just ``out_elems`` lanes.
    geometry: tuple[int, int, int] | None = None

    @property
    def out_elems(self) -> int:
        """Granularity: output elements produced per invocation.

        This is what the compute-mapping pass maximises when several nodes
        support the same capability (§3.2: "selecting the ACG node capable of
        performing the most operations at a time").
        """
        return self.outputs[0].elems

    def matches(self, name: str, dtype: Dtype | None) -> bool:
        if self.name != name:
            return False
        if dtype is None:
            return True
        return any(o.dtype == dtype for o in self.outputs) or any(
            i.dtype == dtype for i in self.inputs
        )

    def __str__(self) -> str:
        outs = ",".join(str(o) for o in self.outputs)
        ins = ",".join(str(i) for i in self.inputs)
        return f"{outs}={self.name}({ins})"


def cap(name: str, outputs, inputs, cycles: int = 1,
        geometry: tuple[int, int, int] | None = None) -> Capability:
    """Terse capability builder: ``cap("ADD", ospec("i32",64), [ospec(...), ...])``."""
    if isinstance(outputs, OperandSpec):
        outputs = (outputs,)
    return Capability(name, tuple(inputs), tuple(outputs), cycles, geometry)


# ---------------------------------------------------------------------------
# Nodes and edges
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MemoryNode:
    """Software-managed storage (§2.1.1)."""

    name: str
    data_width: int  # bits per bank access — alignment unit for Algorithm 1
    banks: int
    depth: int
    # True for off-chip / host-visible memory (the default operand home).
    offchip: bool = False

    @property
    def elem_bits(self) -> int:
        """Bits of one addressable element (all banks in parallel)."""
        return self.data_width * self.banks

    @property
    def capacity_bits(self) -> int:
        return self.elem_bits * self.depth

    @property
    def capacity_bytes(self) -> int:
        return self.capacity_bits // 8

    kind = "memory"


@dataclasses.dataclass(frozen=True)
class ComputeNode:
    """Programmable functional unit (§2.1.3)."""

    name: str
    capabilities: tuple[Capability, ...]
    # VLIW issue resource this node occupies (mnemonic packing, §4); nodes with
    # the same slot class contend for packet slots.
    slot: str | None = None

    def find(self, name: str, dtype: Dtype | None = None) -> list[Capability]:
        return [c for c in self.capabilities if c.matches(name, dtype)]

    kind = "compute"


@dataclasses.dataclass(frozen=True)
class Edge:
    """Directed programmable interconnect (§2.1.2)."""

    src: str
    dst: str
    bandwidth: int  # bits per transfer operation
    latency: int = 1  # cycles per transfer operation (cost model)

    def transfer_ops(self, bits: int) -> int:
        """Number of transfer operations needed to move ``bits`` over this edge."""
        return max(1, math.ceil(bits / self.bandwidth))


# ---------------------------------------------------------------------------
# Mnemonics (§2.1.4)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Field:
    """One fixed-width field of a mnemonic.

    ``rw`` annotates read/write semantics of address-carrying fields; the
    mnemonic-packing pass (§4) uses it for dependency analysis.  ``None``
    means the field does not reference storage.
    """

    name: str
    bits: int
    enum: tuple[str, ...] | None = None  # efield when set, ifield otherwise
    rw: str | None = None  # "r" | "w" | None

    def encode(self, value) -> int:
        if self.enum is not None:
            idx = self.enum.index(value)
            return idx
        iv = int(value)
        if iv < 0 or iv >= (1 << self.bits):
            raise ValueError(f"field {self.name}: value {iv} does not fit in {self.bits} bits")
        return iv


def ifield(name: str, bits: int, rw: str | None = None) -> Field:
    return Field(name, bits, None, rw)


def efield(name: str, bits: int, values: Sequence[str], rw: str | None = None) -> Field:
    return Field(name, bits, tuple(values), rw)


@dataclasses.dataclass(frozen=True)
class MnemonicDef:
    """``mnemonic NAME(opcode) { field*, attr* }`` — Figure 6."""

    name: str
    opcode: int
    fields: tuple[Field, ...]
    # free-form attributes (e.g. which ACG node executes it) for analyses
    attrs: Mapping[str, object] = dataclasses.field(default_factory=dict)

    @property
    def bits(self) -> int:
        return 8 + sum(f.bits for f in self.fields)  # 8-bit opcode prefix

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(f"mnemonic {self.name} has no field {name!r}")


@dataclasses.dataclass
class Mnemonic:
    """A mnemonic *instance*: a MnemonicDef with concrete field values."""

    mdef: MnemonicDef
    values: dict[str, object]
    # node occupied while executing (for packing + cycle model)
    node: str | None = None
    cycles: int = 1

    def encode(self) -> int:
        word = self.mdef.opcode & 0xFF
        for f in self.mdef.fields:
            word = (word << f.bits) | f.encode(self.values[f.name])
        return word

    def reads(self) -> set[tuple[str, object]]:
        return {
            (f.name, self.values[f.name]) for f in self.mdef.fields if f.rw == "r"
        }

    def writes(self) -> set[tuple[str, object]]:
        return {
            (f.name, self.values[f.name]) for f in self.mdef.fields if f.rw == "w"
        }

    def __str__(self) -> str:
        args = ", ".join(f"{f.name}={self.values[f.name]}" for f in self.mdef.fields)
        return f"{self.mdef.name} {args}"


# ---------------------------------------------------------------------------
# The graph itself
# ---------------------------------------------------------------------------


class ACG:
    """Architecture Covenant Graph: nodes + directed edges + mnemonic defs."""

    def __init__(self, name: str, issue_slots: int = 1, loop_overhead: int = 1):
        self.name = name
        # VLIW packet width; 1 means no packing is possible on this target.
        self.issue_slots = issue_slots
        # cycles of branch/bookkeeping per loop iteration (0 = hardware loops)
        self.loop_overhead = loop_overhead
        self.nodes: dict[str, MemoryNode | ComputeNode] = {}
        self.edges: list[Edge] = []
        self.mnemonics: dict[str, MnemonicDef] = {}
        # (compute_node, capability_name) -> ordered memory nodes each operand
        # must be staged in (inputs..., output).  Optional realism hint for
        # targets with dedicated per-operand buffers (DNNWeaver IBUF/WBUF/...).
        self.operand_ports: dict[tuple[str, str], tuple[str, ...]] = {}
        # BYOC-style pass hooks consumed by pipeline.Pipeline.with_acg_hooks:
        # ``pass_overrides`` replaces a named stage's body for this target;
        # ``extra_passes`` splices ("after:STAGE"|"before:STAGE", name, fn)
        # stages into the stock pipeline.  Empty on the stock targets.
        self.pass_overrides: dict[str, object] = {}
        self.extra_passes: list[tuple[str, str, object]] = []
        self._g = nx.DiGraph()

    # -- declarative covenant specs (core/spec.py) ---------------------------
    @classmethod
    def from_spec(cls, spec) -> "ACG":
        """Build an ACG from a declarative ``spec.ACGSpec`` (validated)."""
        from .spec import build_acg
        return build_acg(spec)

    def to_spec(self):
        """Snapshot this graph into its canonical ``spec.ACGSpec`` — the
        round-trip partner of ``from_spec`` and the basis of the ACG
        content fingerprint used by the compile cache and artifact store."""
        from .spec import spec_of
        return spec_of(self)

    # -- construction -------------------------------------------------------
    def add_memory(self, name: str, data_width: int, banks: int, depth: int,
                   offchip: bool = False) -> MemoryNode:
        node = MemoryNode(name, data_width, banks, depth, offchip)
        self._add_node(node)
        return node

    def add_compute(self, name: str, capabilities: Iterable[Capability],
                    slot: str | None = None) -> ComputeNode:
        node = ComputeNode(name, tuple(capabilities), slot)
        self._add_node(node)
        return node

    def _add_node(self, node) -> None:
        if node.name in self.nodes:
            raise ValueError(f"duplicate ACG node {node.name!r}")
        self.nodes[node.name] = node
        self._g.add_node(node.name)

    def connect(self, src: str, dst: str, bandwidth: int, latency: int = 1,
                bidir: bool = False) -> None:
        for s, d in ((src, dst), (dst, src)) if bidir else ((src, dst),):
            if s not in self.nodes or d not in self.nodes:
                raise KeyError(f"edge {s}->{d} references unknown node")
            e = Edge(s, d, bandwidth, latency)
            self.edges.append(e)
            self._g.add_edge(s, d, edge=e)

    def define_mnemonic(self, name: str, opcode: int, fields: Sequence[Field],
                        **attrs) -> MnemonicDef:
        mdef = MnemonicDef(name, opcode, tuple(fields), attrs)
        self.mnemonics[name] = mdef
        return mdef

    # -- queries used by the Covenant compiler ------------------------------
    def memory_nodes(self) -> list[MemoryNode]:
        return [n for n in self.nodes.values() if isinstance(n, MemoryNode)]

    def compute_nodes(self) -> list[ComputeNode]:
        return [n for n in self.nodes.values() if isinstance(n, ComputeNode)]

    def node(self, name: str):
        return self.nodes[name]

    def memory(self, name: str) -> MemoryNode:
        n = self.nodes[name]
        assert isinstance(n, MemoryNode), f"{name} is not a memory node"
        return n

    def compute(self, name: str) -> ComputeNode:
        n = self.nodes[name]
        assert isinstance(n, ComputeNode), f"{name} is not a compute node"
        return n

    def edge(self, src: str, dst: str) -> Edge:
        data = self._g.get_edge_data(src, dst)
        if data is None:
            raise KeyError(f"no ACG edge {src} -> {dst}")
        return data["edge"]

    def shortest_path(self, src: str, dst: str) -> list[str]:
        """Node path (inclusive) used by transfer insertion (§3.2)."""
        return nx.shortest_path(self._g, src, dst)

    def supporting_nodes(self, capability: str, dtype: Dtype | None = None
                         ) -> list[tuple[ComputeNode, Capability]]:
        """All (node, capability) pairs that can execute ``capability``,
        sorted by descending granularity — the compute-mapping order."""
        out = []
        for node in self.compute_nodes():
            for c in node.find(capability, dtype):
                out.append((node, c))
        out.sort(key=lambda nc: -nc[1].out_elems)
        return out

    def highest_memory(self) -> MemoryNode:
        """The operand home: the memory node with the longest shortest-path to
        the compute nodes (§3.1) — off-chip memory when present."""
        offchip = [m for m in self.memory_nodes() if m.offchip]
        if offchip:
            return offchip[0]
        best, best_d = None, -1
        for m in self.memory_nodes():
            dists = []
            for c in self.compute_nodes():
                try:
                    dists.append(len(self.shortest_path(m.name, c.name)) - 1)
                except nx.NetworkXNoPath:
                    continue
            if not dists:
                continue
            d = min(dists)
            if d > best_d:
                best, best_d = m, d
        if best is None:
            raise ValueError("ACG has no memory node reaching any compute node")
        return best

    def mem_neighbors(self, compute: str) -> list[MemoryNode]:
        """Memory nodes directly feeding a compute node."""
        return [
            self.nodes[p] for p in self._g.predecessors(compute)
            if isinstance(self.nodes[p], MemoryNode)
        ]

    # -- pretty -------------------------------------------------------------
    def describe(self) -> str:
        lines = [f"ACG {self.name} (issue_slots={self.issue_slots})"]
        for n in self.nodes.values():
            if isinstance(n, MemoryNode):
                lines.append(
                    f"  mem {n.name}: data_width={n.data_width} banks={n.banks} "
                    f"depth={n.depth} capacity={n.capacity_bytes}B"
                )
            else:
                lines.append(f"  cu  {n.name} (slot={n.slot}):")
                for c in n.capabilities:
                    lines.append(f"      {c}")
        for e in self.edges:
            lines.append(f"  edge {e.src} -> {e.dst} bw={e.bandwidth}b")
        return "\n".join(lines)


__all__ = [
    "ACG", "Capability", "ComputeNode", "Edge", "Field", "MemoryNode",
    "Mnemonic", "MnemonicDef", "OperandSpec", "cap", "dt", "efield",
    "ifield", "ospec",
]
