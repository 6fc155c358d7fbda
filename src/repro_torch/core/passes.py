"""Codelet optimization passes (§4): functions (Codelet, ACG) -> Codelet.

* ``granularize``  — align intra-loop strides / ref extents with the mapped
  capability's geometry (always applied; scalar baseline uses granularity-1
  capabilities so this is a no-op there).
* ``vectorize``    — re-map compute ops to the widest capability and split
  loops accordingly; for elementwise ops, the paper's Fig-9 heterogeneous
  split (SIMD main + scalar epilogue) avoids padding.
* ``unroll``       — replicate innermost compute bodies and coarsen transfer
  issue, amortizing loop/issue overhead (§4 Loop Unrolling).
* ``pack_body``    — the VLIW packing model (§4 Mnemonic Packing): given one
  loop body's mnemonic-level ops, return packed cycles assuming modulo
  scheduling bounded by per-slot-class resources.  Used by both the analytic
  cost model and the stream simulator's packet former.

The port's copy of ``repro.core.passes``, with the same logic.
"""
from __future__ import annotations

import copy
import math

from .acg import ACG
from .codelet import Aff, Codelet, Compute, Loop, Ref, Transfer
from .scheduler import capability_candidates

# ---------------------------------------------------------------------------
# granularity alignment
# ---------------------------------------------------------------------------

ROLE_ORDER = ("m", "n", "k")


def _choose_role_vars(cdlt: Codelet, op: Compute) -> dict[str, str]:
    """Pick, per role, the loop var that the capability geometry maps onto:
    the var with the largest *extent* (ties -> innermost).  Extent, not trip
    count, so the choice is stable when granularize re-runs after strides
    were already set (idempotence)."""
    intra = {l.var: (l.stop - l.start) for l in cdlt.loops() if l.role == "intra"}
    chosen = {}
    for role, vars_ in op.roles.items():
        avail = [v0 for v0 in vars_ if v0 in intra]
        if not avail:
            continue
        chosen[role] = max(avail, key=lambda v0: (intra[v0], vars_.index(v0)))
    return chosen


def _role_granularity(op: Compute) -> dict[str, int]:
    c = op.cap_obj
    if c.geometry is not None:
        return dict(zip(ROLE_ORDER, c.geometry))
    return {"n": c.out_elems}


def granularize(cdlt: Codelet, acg: ACG) -> None:
    """Set intra-loop strides + compute-ref extents to match capability
    geometry.  Partial trailing invocations are clamped (ceil semantics).
    Idempotent: strides owned by this pass are reset before re-choosing."""
    role_vars = {v0 for _, op in cdlt.computes() for vars_ in op.roles.values()
                 for v0 in vars_}
    for l in cdlt.loops():
        if l.role == "intra" and l.var in role_vars:
            l.stride = 1
    for _, op in cdlt.computes():
        if op.cap_obj is None:
            continue
        gran = _role_granularity(op)
        chosen = _choose_role_vars(cdlt, op)
        vec: dict[str, int] = {}  # loop var -> granularity
        for role, g in gran.items():
            if g > 1 and role in chosen:
                vec[chosen[role]] = g
        for l in cdlt.loops():
            if l.role == "intra" and l.var in vec and any(
                    o is op for o in _ops_under(l)):
                l.stride = vec[l.var]
        op.vec = vec  # type: ignore[attr-defined]  # consumed by cost/interp
        _set_ref_extents(op, vec)


def _ops_under(loop: Loop):
    for item in loop.body:
        if isinstance(item, Loop):
            yield from _ops_under(item)
        else:
            yield item


def _set_ref_extents(op: Compute, vec: dict[str, int]) -> None:
    """Per-dim extent each invocation touches: sum(coeff*(g(var)-1)) + 1."""

    def extents(r: Ref) -> Ref:
        sizes = []
        for ix in r.idx:
            e = 1
            for var, coeff in ix.terms:
                if var in vec:
                    e += abs(coeff) * (vec[var] - 1)
            sizes.append(e)
        return Ref(r.var, r.idx, tuple(sizes) if sizes else None)

    op.out = extents(op.out)
    op.ins = tuple(extents(i) for i in op.ins)


# ---------------------------------------------------------------------------
# vectorization (§4 Parallelization, Fig 9)
# ---------------------------------------------------------------------------


def vectorize(cdlt: Codelet, acg: ACG) -> None:
    """Re-map every compute op to the widest supporting capability, then
    re-granularize.  Elementwise ops with a lane remainder get the Fig-9
    heterogeneous split: vector main loop + scalar epilogue on a second
    compute node, covering the tensor without padding."""
    for loops, op in list(cdlt.computes()):
        cands = capability_candidates(acg, op)
        node, c = cands[0]
        op.loc, op.cap_obj = node.name, c
    granularize(cdlt, acg)
    _hetero_epilogue(cdlt, acg)
    cdlt.note("vectorize: re-mapped to widest capabilities")


def _hetero_epilogue(cdlt: Codelet, acg: ACG) -> None:
    for loops, op in list(cdlt.computes()):
        if op.cap_obj is None or op.cap_obj.geometry is not None:
            continue  # matmul family uses clamped invocations instead
        lanes = op.cap_obj.out_elems
        if lanes <= 1 or not loops:
            continue
        inner = loops[-1]
        if inner.stride != lanes:
            continue
        rem = (inner.stop - inner.start) % lanes
        if rem == 0:
            continue
        # scalar fallback node (Fig 9's "PE")
        scalars = [nc for nc in capability_candidates(acg, op)
                   if nc[1].out_elems < lanes]
        if not scalars:
            continue  # no narrower unit: keep clamped final invocation
        snode, scap = scalars[-1]
        cov = inner.stop - rem
        inner.stop = cov
        epi_op = copy.deepcopy(op)
        epi_op.loc, epi_op.cap_obj = snode.name, scap
        epi_op.vec = {}  # type: ignore[attr-defined]
        _set_ref_extents(epi_op, {})
        epi = Loop(inner.var, cov, cov + rem, scap.out_elems, [epi_op], role="intra")
        parent_body = _parent_body(cdlt, inner)
        parent_body.insert(parent_body.index(inner) + 1, epi)
        cdlt.note(
            f"vectorize: Fig-9 split on {inner.var}: [{inner.start},{cov}) on "
            f"{op.loc} x{lanes}, [{cov},{cov+rem}) on {snode.name}")


def _parent_body(cdlt: Codelet, target: Loop) -> list:
    def rec(body):
        if any(item is target for item in body):
            return body
        for item in body:
            if isinstance(item, Loop):
                found = rec(item.body)
                if found is not None:
                    return found
        return None

    found = rec(cdlt.body)
    assert found is not None
    return found


# ---------------------------------------------------------------------------
# loop unrolling (§4)
# ---------------------------------------------------------------------------


def unroll(cdlt: Codelet, acg: ACG, factor: int = 4) -> None:
    """§4 Loop Unrolling.

    Two effects, both modeled mnemonic-faithfully:

    * innermost compute loops are replicated ``u`` times (fewer loop-overhead
      ctrl ops, more independent mnemonics for the packer);
    * every staging transfer gets ``coalesce=u``: a single XFER mnemonic may
      now carry up to ``u`` contiguous rows (bounded by edge bandwidth) —
      the paper's "if the transfer size is less than the edge bandwidth,
      more data can be transferred in a single operation".
    """
    for l in _innermost_compute_loops(cdlt):
        u = _largest_divisor_leq(l.trips, factor)
        if u <= 1:
            continue
        new_body = []
        for j in range(u):
            for item in l.body:
                clone = copy.deepcopy(item)
                if j > 0:
                    _shift_refs(clone, l.var, j * l.stride)
                new_body.append(clone)
        l.body = new_body
        l.stride *= u
        l.role = "unrolled"
        cdlt.note(f"unroll: {l.var} x{u}")
    for _, t in cdlt.transfers():
        t.coalesce = factor  # type: ignore[attr-defined]


def _innermost_compute_loops(cdlt: Codelet) -> list[Loop]:
    out = []
    for l in cdlt.loops():
        if any(isinstance(x, Compute) for x in l.body) and not any(
                isinstance(x, Loop) for x in l.body):
            out.append(l)
    return out


def _largest_divisor_leq(n: int, k: int) -> int:
    for d in range(min(n, k), 0, -1):
        if n % d == 0:
            return d
    return 1


def _shift_refs(item, var: str, delta: int) -> None:
    if isinstance(item, Compute):
        item.out = _shift_ref(item.out, var, delta)
        item.ins = tuple(_shift_ref(r, var, delta) for r in item.ins)
    elif isinstance(item, Transfer):
        item.src = _shift_ref(item.src, var, delta)
        if item.dst is not None:
            item.dst = _shift_ref(item.dst, var, delta)


def _shift_ref(r: Ref, var: str, delta: int) -> Ref:
    new_idx = []
    for ix in r.idx:
        coeff = dict(ix.terms).get(var, 0)
        new_idx.append(Aff(ix.terms, ix.const + coeff * delta))
    return Ref(r.var, tuple(new_idx), r.sizes)


# ---------------------------------------------------------------------------
# mnemonic packing model (§4)
# ---------------------------------------------------------------------------

# per-packet capacity of each slot class (HVX-style VLIW: 1 vector op, 1
# scalar op, 1 load/store pair, control folded into scalar)
DEFAULT_SLOT_CAPACITY = {"mem": 2, "ctrl": 1}


def pack_body(ops: list[tuple[str, float]], acg: ACG) -> float:
    """Packed cycles for one loop-body iteration.

    ``ops`` is [(slot_class, cycles)].  Models software-pipelined modulo
    scheduling: the initiation interval is bounded below by per-class
    resource usage and by total issue width; we return that bound (the
    packing algorithm in codegen realises it on real streams).
    """
    if acg.issue_slots <= 1:
        return sum(c for _, c in ops)
    per_class: dict[str, float] = {}
    for cls, cyc in ops:
        per_class[cls] = per_class.get(cls, 0.0) + cyc
    ii = 0.0
    for cls, cyc in per_class.items():
        capn = DEFAULT_SLOT_CAPACITY.get(cls, 1)
        ii = max(ii, cyc / capn)
    ii = max(ii, sum(c for _, c in ops) / acg.issue_slots, 1.0)
    return ii


__all__ = ["granularize", "pack_body", "unroll", "vectorize"]
