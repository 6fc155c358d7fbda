"""Analytic cycle model over scheduled Codelets.

The model walks the loop tree bottom-up and is *mnemonic-faithful*: its unit
costs are exactly what the stream simulator charges per mnemonic, so on
streams small enough to execute instruction-by-instruction the two agree
(tested).  Per-op costs:

* transfer of ``bits`` over edge ``e`` staged in rows of ``row_bits``:
  ``ceil(bits / min(coalesce*row_bits, e.bandwidth)) * e.latency`` cycles on
  the ``mem`` slot class — without unrolling each XFER mnemonic carries one
  contiguous row (Fig 8b's "Using only 25% of bandwidth!"); unrolling
  coalesces rows up to the edge bandwidth (§4);
* compute invocation: ``capability.cycles`` on the node's slot class;
* loop iteration: ``acg.loop_overhead`` cycles on the ``ctrl`` class
  (0 on targets with hardware loop sequencers, e.g. DNNWeaver).

With packing enabled (VLIW targets), each loop body's per-iteration cost is
the modulo-scheduling initiation-interval bound from ``passes.pack_body``;
without packing, costs sum serially.

The port's copy of ``repro.core.cost``, with the same logic.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

from .acg import ACG
from .codelet import Codelet, Compute, Loop, Ref, Transfer
from .passes import DEFAULT_SLOT_CAPACITY, pack_body


@dataclasses.dataclass
class CostReport:
    cycles: float
    compute_cycles: float
    transfer_cycles: float
    overhead_cycles: float
    compute_invocations: int
    transfer_mnemonics: int
    macs: float = 0.0

    @property
    def breakdown(self) -> str:
        return (f"{self.cycles:.0f} cyc (compute {self.compute_cycles:.0f}, "
                f"mem {self.transfer_cycles:.0f}, ctrl {self.overhead_cycles:.0f})")


def transfer_cost(cdlt: Codelet, t: Transfer, acg: ACG) -> tuple[float, int]:
    """(cycles, n_mnemonics) for one execution of a transfer op.

    Uses the same 2-D DMA burst plan the code generator emits
    (``codegen.xfer_chunks``), so analytic and stream-simulated cycle
    counts agree exactly on unrollable streams.
    """
    from .codegen import xfer_chunks  # local import: codegen imports codelet

    if not t.src.var and t.fill is not None:
        return 0.0, 0  # accumulator alloc: psums reset in-unit
    if t.dst_loc is not None:
        src_loc = cdlt.surrogates[t.src.var].loc
        dst_loc = t.dst_loc
    else:
        src_loc = cdlt.surrogates[t.src.var].loc
        dst_loc = cdlt.surrogates[t.dst.var].loc
    e = acg.edge(src_loc, dst_loc)
    s = cdlt.surrogates[t.src.var] if t.src.var else cdlt.surrogates[t.dst.var]
    rows = math.prod(t.sizes[:-1]) if len(t.sizes) > 1 else 1
    row_bits = t.sizes[-1] * s.dtype.bits
    coalesce = getattr(t, "coalesce", 1)
    n, _, _ = xfer_chunks(rows, row_bits, coalesce, e.bandwidth)
    return float(n * e.latency), n


def _compute_slot(op: Compute, acg: ACG) -> str:
    return acg.compute(op.loc).slot or "exec"


def cost(cdlt: Codelet, acg: ACG, pack: bool = True) -> CostReport:
    """Analytic cycles for one execution of the scheduled codelet."""
    totals = dict(compute=0.0, mem=0.0, ctrl=0.0, invocations=0, xfers=0)

    def body_cost(body: list, trips_ctx: float,
                  loop_ctrl: float = 0.0) -> float:
        """Cost of one iteration of ``body``; ``loop_ctrl`` is the enclosing
        loop's per-iteration bookkeeping, which packs with this body."""
        ops_meta: list[tuple[str, float]] = []
        if loop_ctrl:
            ops_meta.append(("ctrl", loop_ctrl))
            totals["ctrl"] += loop_ctrl * trips_ctx
        serial_children = 0.0
        for item in body:
            if isinstance(item, Loop):
                child = body_cost(item.body, trips_ctx * item.trips,
                                  float(acg.loop_overhead))
                serial_children += child * item.trips
            elif isinstance(item, Transfer):
                cyc, n = transfer_cost(cdlt, item, acg)
                ops_meta.append(("mem", cyc))
                totals["mem"] += cyc * trips_ctx
                totals["xfers"] += int(n * trips_ctx)
            elif isinstance(item, Compute):
                cyc = item.cap_obj.cycles if item.cap_obj else 1
                ops_meta.append((_compute_slot(item, acg), float(cyc)))
                totals["compute"] += cyc * trips_ctx
                totals["invocations"] += int(trips_ctx)
        if pack and acg.issue_slots > 1:
            own = pack_body(ops_meta, acg)
        else:
            own = sum(c for _, c in ops_meta)
        return own + serial_children

    cycles = body_cost(cdlt.body, 1.0)
    return CostReport(
        cycles=cycles,
        compute_cycles=totals["compute"],
        transfer_cycles=totals["mem"],
        overhead_cycles=totals["ctrl"],
        compute_invocations=totals["invocations"],
        transfer_mnemonics=totals["xfers"],
    )


# ---------------------------------------------------------------------------
# Prefix bound — the admissible lower bound beam search prunes with
# ---------------------------------------------------------------------------
#
# ``prefix_bound(probe, acg, plans, committed)`` bounds the full-schedule
# analytic cost of EVERY tiling that extends the partial assignment
# ``committed`` (loop var -> tile factor).  Committed loops cost exactly
# what the model would charge them; uncommitted loops are relaxed to their
# best case (min over their divisor grid, jointly within each group of
# loops that share a footprint dimension).  Admissibility — the bound is
# never greater than ``cost()`` of any completion — is what makes beam
# pruning safe, and is property-tested against the mnemonic-faithful model
# (tests/test_cost_model.py).  Relaxations used (each only ever *lowers*
# the bound):
#
# * transfers are charged at perfect edge coalescing (total bits moved /
#   edge bandwidth — every XFER mnemonic carries at most ``bandwidth``
#   bits, so the real chunk plan can only cost more, whatever the unroll
#   factor coalesces);
# * uncommitted loops outside an operand's reference contribute no reload
#   factor (their best case: untiled);
# * loop-iteration (ctrl) overhead is dropped entirely;
# * compute is charged at the mapped capability's full granularity
#   (``work / prod(geometry) * cycles`` — invocations can only be more).


def _dim_extent(ref: Ref, shape, d: int, extents: dict[str, int]) -> int:
    """Element extent of ``ref``'s dim ``d`` when each var in ``extents``
    ranges over [0, extent) — one dim of ``codelet.ref_footprint``."""
    span = 1
    for var, coeff in ref.idx[d].terms:
        if var in extents:
            span += abs(coeff) * (extents[var] - 1)
    base = ref.sizes[d] if ref.sizes else 1
    return min(shape[d], span - 1 + base)


def _var_components(ref: Ref) -> list[tuple[frozenset, tuple[int, ...]]]:
    """Group ``ref``'s loop vars into connected components of dims that
    share vars (conv windows couple ``oh`` and ``kh``); returns
    [(vars, dim indices)].  Dims with no loop vars are handled separately
    (their extent is constant)."""
    parent: dict[str, str] = {}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    dim_vars = [sorted(ref.idx[d].vars()) for d in range(len(ref.idx))]
    for vs in dim_vars:
        for v0 in vs:
            parent.setdefault(v0, v0)
        for a, b in zip(vs, vs[1:]):
            parent[find(a)] = find(b)
    comps: dict[str, tuple[set, list]] = {}
    for d, vs in enumerate(dim_vars):
        if not vs:
            continue
        root = find(vs[0])
        comp = comps.setdefault(root, (set(), []))
        comp[0].update(vs)
        comp[1].append(d)
    return [(frozenset(vs), tuple(ds)) for vs, ds in comps.values()]


_JOINT_CAP = 4096  # max joint grid combos per component before relaxing


def _operand_traffic_lb(cdlt: Codelet, p, committed: dict[str, int],
                        order: list[str], ranges: dict[str, int],
                        divisors: dict[str, list[int]]
                        ) -> tuple[float, float, float]:
    """Per-hop lower bounds for operand ``p`` under any completion of
    ``committed``: ``(elements moved, tile loads, rows moved)``.

    * *elements* bounds the bandwidth-limited cycles (bits / bandwidth);
    * *loads* bounds the mnemonic count — every tile load is at least one
      XFER, however well it coalesces (Fig 8b's reload tax: the term that
      makes the bound commitment-sensitive);
    * *rows* bounds the chunk count — one XFER carries at most
      ``coalesce`` contiguous rows (§4 Loop Unrolling).
    """
    s = cdlt.surrogates[p.surrogate]
    ref = p.ref
    if not ref.idx:                      # whole-surrogate reference
        elems = float(math.prod(s.shape))
        return elems, 1.0, elems / max(s.shape[-1], 1)
    ref_vars = set()
    for ix in ref.idx:
        ref_vars |= ix.vars()
    ref_vars &= set(ranges)
    last_dim = len(ref.idx) - 1

    def trips(var: str, factor: int) -> int:
        return math.ceil(ranges[var] / factor) if factor < ranges[var] else 1

    # reload factor of committed tiled NON-ref loops that provably sit
    # outside the transfer's insertion level: they precede (in nest order)
    # a committed tiled loop the reference DOES depend on
    tiled = {v for v, f in committed.items()
             if v in ranges and f < ranges[v]}
    ref_tiled_pos = [order.index(v) for v in ref_vars & tiled]
    outer = 1.0
    if ref_tiled_pos:
        level = max(ref_tiled_pos)
        for v0 in tiled - ref_vars:
            if order.index(v0) < level:
                outer *= trips(v0, committed[v0])

    elems = loads = rows = outer
    seen_dims: set[int] = set()
    for comp_vars, comp_dims in _var_components(ref):
        seen_dims.update(comp_dims)
        unc = sorted(v for v in comp_vars if v not in committed
                     and v in ranges)
        fixed = {v: committed[v] for v in comp_vars
                 if v in committed and v in ranges}
        # committed tiled loops of this component reload exactly
        loads *= math.prod(trips(v, f) for v, f in fixed.items()
                           if f < ranges[v])
        grids = [divisors.get(v, [ranges[v]]) for v in unc]
        if math.prod(len(g) for g in grids) > _JOINT_CAP:
            # relaxation: minimal per-dim extents, no reload factor
            ones = {v: 1 for v in comp_vars}
            elems *= math.prod(
                _dim_extent(ref, s.shape, d, ones) for d in comp_dims)
            rows *= math.prod(
                _dim_extent(ref, s.shape, d, ones)
                for d in comp_dims if d != last_dim)
            continue
        best_e, best_r = math.inf, math.inf
        for combo in itertools.product(*grids):
            ext = dict(fixed)
            ext.update(zip(unc, combo))
            n_loads = math.prod(trips(v, f) for v, f in ext.items())
            fp = [(_dim_extent(ref, s.shape, d, ext), d)
                  for d in comp_dims]
            full = math.prod(e for e, _ in fp)
            best_e = min(best_e, n_loads * full)
            best_r = min(best_r, n_loads * math.prod(
                e for e, d in fp if d != last_dim))
        elems *= best_e
        rows *= best_r
    for d in range(len(ref.idx)):        # constant dims
        if d not in seen_dims:
            e = _dim_extent(ref, s.shape, d, {})
            elems *= e
            if d != last_dim:
                rows *= e
    return elems, loads, rows


def _loop_ranges(cdlt: Codelet) -> dict[str, int]:
    return {l.var: l.trips for l in cdlt.loops()}


def _compute_lower_bound(cdlt: Codelet, acg: ACG) -> tuple[float, str]:
    """(cycles, slot class) of the mapped capability at full granularity —
    tiling-independent, since mapping happens before tiling."""
    (loops, op), = cdlt.computes()
    work = float(math.prod(l.trips for l in cdlt.loops()))
    cap = op.cap_obj
    if cap is None:
        return 0.0, "exec"
    per_inv = math.prod(cap.geometry) if cap.geometry else cap.out_elems
    return work / max(per_inv, 1) * cap.cycles, _compute_slot(op, acg)


def _hop_traffic(cdlt: Codelet, acg: ACG, plans, committed: dict[str, int],
                 divisors: dict[str, list[int]],
                 max_coalesce: int = 8) -> list[tuple[float, object]]:
    """[(cycles lower bound, plan)] per operand, summed over its hops.

    Each hop's XFER-mnemonic count is bounded below by the max of three
    floors — bandwidth (bits moved / edge bandwidth), loads (one mnemonic
    per tile load) and rows (at most ``max_coalesce`` contiguous rows per
    mnemonic) — each admissible for any tiling completion and any unroll
    factor up to ``max_coalesce``."""
    order = [l.var for l in cdlt.loops()]
    ranges = _loop_ranges(cdlt)
    out = []
    for p in plans:
        s = cdlt.surrogates[p.surrogate]
        elems, loads, rows = _operand_traffic_lb(cdlt, p, committed, order,
                                                 ranges, divisors)
        bits = elems * s.dtype.bits
        cyc = sum(max(bits / e.bandwidth, loads,
                      rows / max(max_coalesce, 1)) * e.latency
                  for e, _ in p.hops(acg))
        out.append((cyc, p))
    return out


def prefix_bounds(cdlt: Codelet, acg: ACG, plans, committed: dict[str, int],
                  *, divisors: dict[str, list[int]] | None = None,
                  max_coalesce: int = 8) -> tuple[float, float]:
    """``(packed form, serial form)`` of the prefix bound from ONE traffic
    analysis — the two differ only in how the same compute/transfer lower
    bounds combine, and beam ranking needs both per prefix."""
    if divisors is None:
        from .scheduler import _divisors
        divisors = {l.var: _divisors(l.trips) for l in cdlt.loops()}
    compute_lb, slot = _compute_lower_bound(cdlt, acg)
    transfer_lb = sum(c for c, _ in
                      _hop_traffic(cdlt, acg, plans, committed, divisors,
                                   max_coalesce=max_coalesce))
    serial = compute_lb + transfer_lb
    if acg.issue_slots > 1:
        # packed streams overlap classes: bound by the slowest slot class
        # at its per-packet capacity (the modulo-scheduling II argument)
        packed = max(compute_lb / DEFAULT_SLOT_CAPACITY.get(slot, 1),
                     transfer_lb / DEFAULT_SLOT_CAPACITY.get("mem", 1))
    else:
        packed = serial  # single-issue targets execute serially either way
    return packed, serial


def prefix_bound(cdlt: Codelet, acg: ACG, plans, committed: dict[str, int],
                 *, divisors: dict[str, list[int]] | None = None,
                 pack: bool = True, max_coalesce: int = 8) -> float:
    """Admissible lower bound on ``cost(...).cycles`` of every schedule
    extending the partial tiling ``committed`` (see module comment above).

    ``cdlt`` is the pre-tiling probe (``ScheduleSpace.probe``); ``plans``
    its operand plans; ``divisors`` the per-loop factor grids uncommitted
    loops may choose from (defaults to each loop's full divisor grid);
    ``max_coalesce`` must be at least the largest unroll factor a
    completion may use (rows coalesce up to it).  ``pack=False`` gives
    the tighter serial-sum form, valid only against
    ``cost(..., pack=False)``."""
    packed, serial = prefix_bounds(cdlt, acg, plans, committed,
                                   divisors=divisors,
                                   max_coalesce=max_coalesce)
    return packed if pack else serial


def transfer_hot_vars(cdlt: Codelet, acg: ACG, plans,
                      tiling: dict[str, int],
                      divisors: dict[str, list[int]] | None = None
                      ) -> list[str]:
    """Loop vars of the operand whose staging edges dominate transfer
    cycles under ``tiling`` — the loops transfer-aware mutation biases
    toward.  Deterministic (sorted) for seed-stable search."""
    if divisors is None:
        divisors = {}
    ranked = sorted(_hop_traffic(cdlt, acg, plans, tiling, divisors),
                    key=lambda cp: -cp[0])
    for cyc, p in ranked:
        if cyc <= 0:
            break
        vs = set()
        for ix in p.ref.idx:
            vs |= ix.vars()
        hot = sorted(vs & set(tiling))
        if hot:
            return hot
    return []


__all__ = ["CostReport", "cost", "prefix_bound", "prefix_bounds",
           "transfer_cost", "transfer_hot_vars"]
