"""Macro-mnemonics — code generation from scheduled Codelets (§3.3).

The Covenant compiler "ensures valid code generation by combining operation
types, operand types, and their ACG node attributes to select pre-defined
functions for generating sequences of mnemonics called macro-mnemonics".

This module implements exactly that: a registry keyed by
``(operation_type, acg_node_selector)`` whose entries are functions
``(op, ctx) -> list[Mnemonic]``.  The default macros cover every paper
target; a new accelerator only needs new ACG attributes (and, rarely, a
specialised macro) — the *generator* itself is retargetable because
mnemonics are semantics-free (§2.1.4).

Generated streams are fully unrolled (loop iterations enumerated), with
per-iteration ``LOOPI`` bookkeeping mnemonics on targets without hardware
loop sequencers, so the stream simulator charges the same control overhead
the analytic model does.  Full unrolling is only tractable for small layers;
``generate`` raises past ``max_mnemonics`` and the analytic model
(``cost.py`` — mnemonic-faithful by construction) covers the big ones.

Every mnemonic instance carries:
* encoded fields (tested to round-trip through ``Mnemonic.encode``),
* ``rd``/``wr`` byte-interval descriptors for §4 packing dependency analysis,
* a ``sem`` descriptor the stream machine executes (decoded field view).

The port's copy of ``repro.core.codegen``, with the same logic.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

from .acg import ACG, Mnemonic
from .codelet import Aff, Codelet, Compute, Loop, Ref, Surrogate, Transfer

# ---------------------------------------------------------------------------
# memory map: bump allocation per ACG memory node
# ---------------------------------------------------------------------------


class StreamTooLarge(RuntimeError):
    pass


@dataclasses.dataclass
class Placement:
    node: str
    addr: int          # byte address within the node
    shape: tuple[int, ...]
    itemsize: int      # simulator byte width (dtype.np.itemsize)

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.itemsize

    def strides(self) -> tuple[int, ...]:
        """Row-major element strides."""
        out, acc = [], 1
        for d in reversed(self.shape):
            out.append(acc)
            acc *= d
        return tuple(reversed(out))


class MemoryMap:
    """Assigns every surrogate a base byte address in its ACG location.

    Addresses are aligned to the node's ``data_width`` (Algorithm 1's
    addressability unit).  Off-chip/home nodes may exceed their declared
    capacity (the home holds whole operands; capacity constrains *staging*).
    """

    def __init__(self, acg: ACG):
        self.acg = acg
        self.cursor: dict[str, int] = {m.name: 0 for m in acg.memory_nodes()}
        self.places: dict[str, Placement] = {}

    def place(self, s: Surrogate) -> Placement:
        if s.name in self.places:
            return self.places[s.name]
        assert s.loc is not None and s.shape is not None and s.dtype is not None
        mem = self.acg.memory(s.loc)
        align = max(1, mem.data_width // 8)
        addr = math.ceil(self.cursor[s.loc] / align) * align
        p = Placement(s.loc, addr, s.shape, s.dtype.np.itemsize)
        self.cursor[s.loc] = addr + p.nbytes
        if not mem.offchip and self.cursor[s.loc] > mem.capacity_bytes:
            raise StreamTooLarge(
                f"{s.name}: staging overflows {s.loc} "
                f"({self.cursor[s.loc]} > {mem.capacity_bytes} bytes)")
        self.places[s.name] = p
        return p


# ---------------------------------------------------------------------------
# generation context
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Program:
    """A generated mnemonic stream plus everything needed to execute it."""

    cdlt: Codelet
    acg: ACG
    memmap: MemoryMap
    mnemonics: list[Mnemonic]

    def __len__(self) -> int:
        return len(self.mnemonics)

    @property
    def bytes(self) -> int:
        return sum((m.mdef.bits + 7) // 8 for m in self.mnemonics)

    def listing(self, limit: int = 50) -> str:
        lines = [str(m) for m in self.mnemonics[:limit]]
        if len(self.mnemonics) > limit:
            lines.append(f"... (+{len(self.mnemonics) - limit} more)")
        return "\n".join(lines)


@dataclasses.dataclass
class Ctx:
    cdlt: Codelet
    acg: ACG
    memmap: MemoryMap
    env: dict[str, int]
    bounds: dict[str, int]  # loop var -> stop (for clamping)

    def placement(self, name: str) -> Placement:
        return self.memmap.place(self.cdlt.surrogates[name])

    def eval(self, ix: Aff) -> int:
        return ix.const + sum(c * self.env.get(var, 0) for var, c in ix.terms)


# ---------------------------------------------------------------------------
# transfer chunking — shared with the analytic cost model (cost.py imports it)
# ---------------------------------------------------------------------------


def xfer_chunks(rows: int, row_bits: int, coalesce: int, bandwidth: int
                ) -> tuple[int, int, int]:
    """2-D DMA burst plan: returns (n_chunks, rows_per_chunk, xfers_per_row).

    Without unrolling each XFER carries one contiguous row (Fig 8b: "Using
    only 25% of bandwidth!"); rows wider than the edge split; unrolling
    coalesces up to ``coalesce`` rows per burst, bounded by edge bandwidth
    (§4 Loop Unrolling).
    """
    row_bits = max(1, row_bits)
    if row_bits > bandwidth:
        per_row = math.ceil(row_bits / bandwidth)
        return rows * per_row, 1, per_row
    g = max(1, min(coalesce, bandwidth // row_bits))
    return math.ceil(rows / g), g, 1


# ---------------------------------------------------------------------------
# default macro-mnemonics
# ---------------------------------------------------------------------------


def _flat_rows(shape: tuple[int, ...]) -> tuple[int, int]:
    """(n_rows, row_elems) viewing an nd tile as rows of its last dim."""
    if not shape:
        return 1, 1
    return math.prod(shape[:-1]), shape[-1]


def _byte_off(place: Placement, idx: tuple[int, ...]) -> int:
    strides = place.strides()
    return place.addr + sum(i * st for i, st in zip(idx, strides)) * place.itemsize


def xfer_macro(t: Transfer, ctx: Ctx) -> list[Mnemonic]:
    """Expand one transfer op into ALLOC / XFER mnemonic sequences."""
    cdlt, acg = ctx.cdlt, ctx.acg
    out: list[Mnemonic] = []
    if t.dst_loc is not None and not t.src.var:
        # const-fill allocation (accumulator tile): one ALLOC, zero cycles —
        # systolic/SIMD units reset psums in-unit.
        s = cdlt.surrogates[t.alloc]
        p = ctx.placement(t.alloc)
        mdef = acg.mnemonics["ALLOC"]
        m = Mnemonic(mdef, {"NODE": p.node, "ADDR": p.addr, "SIZE": p.nbytes},
                     node=p.node, cycles=0)
        m.wr = [(p.node, p.addr, p.addr + p.nbytes)]
        m.rd = []
        m.sem = ("alloc", p, float(t.fill or 0), s.dtype.np)
        return [m]

    if t.dst_loc is not None:
        src_s = cdlt.surrogates[t.src.var]
        src_p = ctx.placement(t.src.var)
        dst_p = ctx.placement(t.alloc)
        src_start = [ctx.eval(ix) for ix in t.src.idx] or [0] * len(t.sizes)
        direction = (src_p.node, dst_p.node)
        dst_start = [0] * len(t.sizes)
    else:
        src_p = ctx.placement(t.src.var)
        dst_p = ctx.placement(t.dst.var)
        src_start = [0] * len(t.sizes)
        dst_start = [ctx.eval(ix) for ix in t.dst.idx] or [0] * len(t.sizes)
        direction = (src_p.node, dst_p.node)

    edge = acg.edge(*direction)
    itemsize = src_p.itemsize
    # clamp spans to both surrogate extents (trailing partial tiles)
    spans = [min(sz,
                 src_p.shape[d] - src_start[d],
                 dst_p.shape[d] - dst_start[d])
             for d, sz in enumerate(t.sizes)]
    if t.dst_loc is not None and any(sp < sz for sp, sz in zip(spans, t.sizes)):
        # partial tile: zero the staging buffer first so clamped compute
        # invocations reading past the span see zeros (interp semantics)
        s_loc = cdlt.surrogates[t.alloc]
        mz = Mnemonic(acg.mnemonics["ALLOC"],
                      {"NODE": dst_p.node, "ADDR": dst_p.addr,
                       "SIZE": dst_p.nbytes}, node=dst_p.node, cycles=0)
        mz.wr = [(dst_p.node, dst_p.addr, dst_p.addr + dst_p.nbytes)]
        mz.rd = []
        mz.sem = ("alloc", dst_p, 0.0, s_loc.dtype.np)
        out.append(mz)
    rows, row_elems = _flat_rows(tuple(spans))
    row_bytes = row_elems * itemsize
    coalesce = getattr(t, "coalesce", 1)
    n_chunks, g, per_row = xfer_chunks(rows, row_bytes * 8, coalesce,
                                       edge.bandwidth)
    mdef = acg.mnemonics["XFER"]

    # enumerate row start indices in the (possibly) nd span
    outer = spans[:-1] or [1]
    src_strides = src_p.strides()
    dst_strides = dst_p.strides()

    def row_addr(place, start, row_i, strides):
        idx = list(start)
        rem = row_i
        for d in range(len(outer) - 1, -1, -1):
            if len(spans) > 1:
                idx[d] = start[d] + rem % outer[d]
                rem //= outer[d]
        return _byte_off(place, tuple(idx))

    # rows are burstable in groups of g when consecutive rows are equidistant
    # in both source and destination (strided 2-D DMA)
    src_rstride = (src_strides[-2] * itemsize) if len(spans) > 1 else row_bytes
    dst_rstride = (dst_strides[-2] * itemsize) if len(spans) > 1 else row_bytes

    r = 0
    while r < rows:
        burst = min(g, rows - r)
        # only rows contiguous within the same innermost block may burst
        if len(spans) > 2 and burst > 1:
            per = outer[-1]
            burst = min(burst, per - ((r % per)))
        sa = row_addr(src_p, src_start, r, src_strides)
        da = row_addr(dst_p, dst_start, r, dst_strides)
        for piece in range(per_row):
            pb = min(row_bytes - piece * (edge.bandwidth // 8),
                     max(1, edge.bandwidth // 8))
            m = Mnemonic(mdef, {
                "SRC_NODE": src_p.node, "DST_NODE": dst_p.node,
                "SRC_ADDR": sa + piece * (edge.bandwidth // 8),
                "DST_ADDR": da + piece * (edge.bandwidth // 8),
                "ROWS": burst if per_row == 1 else 1,
                "ROW_BYTES": row_bytes if per_row == 1 else pb,
                "SRC_STRIDE": src_rstride, "DST_STRIDE": dst_rstride,
            }, node=dst_p.node, cycles=edge.latency)
            span_b = (burst - 1) * src_rstride + row_bytes if per_row == 1 else pb
            dspan_b = (burst - 1) * dst_rstride + row_bytes if per_row == 1 else pb
            m.rd = [(src_p.node, m.values["SRC_ADDR"], m.values["SRC_ADDR"] + span_b)]
            m.wr = [(dst_p.node, m.values["DST_ADDR"], m.values["DST_ADDR"] + dspan_b)]
            m.sem = ("xfer", src_p, dst_p, m.values, itemsize)
            out.append(m)
        r += burst
    return out


def _role_of(op: Compute) -> dict[str, str]:
    vec = getattr(op, "vec", {}) or {}
    role_of = {}
    for role, vars_ in op.roles.items():
        for var in vars_:
            if var in vec:
                role_of[var] = role
    return role_of


def _operand_view(r: Ref, ctx: Ctx, vec: dict[str, int], role_of) -> dict:
    """Decoded operand descriptor: base byte addr + labeled dims."""
    p = ctx.placement(r.var)
    strides = p.strides()
    base_idx, labels, shape, elem_strides = [], [], [], []
    for d, ix in enumerate(r.idx):
        base_idx.append(ctx.eval(ix))
        vt = [(var, c) for var, c in ix.terms if var in vec]
        if vt:
            var, c = vt[0]
            stop = ctx.bounds.get(var, 1 << 62)
            extent = max(1, min(vec[var], stop - ctx.env.get(var, 0)))
            # clamp by the surrogate extent along this dim (numpy-slice
            # semantics; covers unroll-shifted trailing invocations)
            step = max(1, abs(c))
            avail = max(1, -(-(p.shape[d] - base_idx[d]) // step))
            extent = min(extent, avail)
            labels.append(role_of.get(var, "n"))
            shape.append(extent)
            elem_strides.append(strides[d] * step)
    if not r.idx:
        base_idx = [0] * len(p.shape)
        labels = ["n"]
        shape = [math.prod(p.shape)]
        elem_strides = [1]
    return dict(place=p, base=_byte_off(p, tuple(base_idx)),
                labels="".join(labels), shape=tuple(shape),
                strides=tuple(elem_strides))


def compute_macro(op: Compute, ctx: Ctx) -> list[Mnemonic]:
    """One mnemonic per compute invocation, fields resolved from the ACG
    node the op was mapped to (the §3.3 contextual inputs)."""
    acg = ctx.acg
    cap = op.cap_obj
    vec = getattr(op, "vec", {}) or {}
    role_of = _role_of(op)
    node = acg.compute(op.loc)
    name = cap.name if cap.name in acg.mnemonics else op.capability
    mdef = acg.mnemonics[name]
    ins = [_operand_view(r, ctx, vec, role_of) for r in op.ins]
    outv = _operand_view(op.out, ctx, vec, role_of)

    def nbytes(view):
        if not view["shape"]:
            return view["place"].itemsize
        span = sum((s - 1) * st for s, st in zip(view["shape"], view["strides"]))
        return (span + 1) * view["place"].itemsize

    values: dict[str, object] = {}
    if cap.geometry is not None:  # matmul family
        dims = {"m": 1, "n": 1, "k": 1}
        for view in ins + [outv]:
            for lbl, extent in zip(view["labels"], view["shape"]):
                if lbl in dims:
                    dims[lbl] = max(dims[lbl], extent)
        a, b = ins[0], ins[1]
        accv = ins[2] if len(ins) > 2 else outv
        values = {
            "SRC1_ADDR": a["base"], "SRC2_ADDR": b["base"],
            "ACC_ADDR": accv["base"], "DST_ADDR": outv["base"],
            "M": dims["m"], "N": dims["n"], "K": dims["k"],
            "LD1": a["strides"][0] if a["strides"] else 1,
            "LD2": b["strides"][0] if b["strides"] else 1,
            "LDD": outv["strides"][0] if outv["strides"] else 1,
            "TGT": node.name,
        }
    else:
        n = outv["shape"][0] if outv["shape"] else 1
        values = {"DST_ADDR": outv["base"], "N": n, "TGT": node.name}
        values["SRC_ADDR" if len(ins) == 1 else "SRC1_ADDR"] = ins[0]["base"]
        if len(ins) > 1:
            values["SRC2_ADDR"] = ins[1]["base"]
    m = Mnemonic(mdef, values, node=node.name, cycles=cap.cycles)
    m.rd = [(v["place"].node, v["base"], v["base"] + nbytes(v)) for v in ins]
    m.wr = [(outv["place"].node, outv["base"], outv["base"] + nbytes(outv))]
    m.sem = ("compute", op.capability, ins, outv,
             op.dtype.np if op.dtype else np.int32)
    return [m]


def loopi_macro(level: int, trip: int, ctx: Ctx) -> list[Mnemonic]:
    if ctx.acg.loop_overhead <= 0:
        return []
    mdef = ctx.acg.mnemonics["LOOPI"]
    m = Mnemonic(mdef, {"LEVEL": level, "TRIP": trip}, node=None,
                 cycles=ctx.acg.loop_overhead)
    m.rd, m.wr = [], []
    m.sem = ("loopi",)
    return [m]


# registry — (operation type, node selector) -> macro.  "*" matches any node;
# targets can override entries for architecture-specific expansion.
MacroFn = Callable[..., list]
DEFAULT_MACROS: dict[tuple[str, str], MacroFn] = {
    ("transfer", "*"): xfer_macro,
    ("compute", "*"): compute_macro,
}


def select_macro(registry, op_type: str, node: str | None) -> MacroFn:
    if node is not None and (op_type, node) in registry:
        return registry[(op_type, node)]
    return registry[(op_type, "*")]


# ---------------------------------------------------------------------------
# generator entry point
# ---------------------------------------------------------------------------


def generate(cdlt: Codelet, acg: ACG, max_mnemonics: int = 300_000,
             macros: dict | None = None) -> Program:
    """Expand a scheduled codelet into a flat, executable mnemonic stream."""
    registry = dict(DEFAULT_MACROS)
    if macros:
        registry.update(macros)
    memmap = MemoryMap(acg)
    # place operands first (home), then locals (staging) in declaration order
    for s in cdlt.surrogates.values():
        if s.kind in ("inp", "out"):
            memmap.place(s)
    for s in cdlt.surrogates.values():
        if s.kind == "local":
            memmap.place(s)

    stream: list[Mnemonic] = []
    ctx = Ctx(cdlt, acg, memmap, {}, {})

    def emit(ms: list[Mnemonic]) -> None:
        stream.extend(ms)
        if len(stream) > max_mnemonics:
            raise StreamTooLarge(
                f"{cdlt.name}: stream exceeds {max_mnemonics} mnemonics; "
                "use the analytic cost model for this layer")

    def walk(body: list, depth: int) -> None:
        for item in body:
            if isinstance(item, Loop):
                ctx.bounds[item.var] = item.stop
                x, trip = item.start, 0
                while x < item.stop:
                    ctx.env[item.var] = x
                    emit(loopi_macro(depth, trip, ctx))
                    walk(item.body, depth + 1)
                    x += item.stride
                    trip += 1
                ctx.env.pop(item.var, None)
            elif isinstance(item, Transfer):
                node = item.dst_loc
                emit(select_macro(registry, "transfer", node)(item, ctx))
            elif isinstance(item, Compute):
                emit(select_macro(registry, "compute", item.loc)(item, ctx))

    walk(cdlt.body, 0)
    return Program(cdlt, acg, memmap, stream)


__all__ = ["DEFAULT_MACROS", "MemoryMap", "Placement", "Program",
           "StreamTooLarge", "compute_macro", "generate", "select_macro",
           "xfer_chunks", "xfer_macro"]
