"""The Covenant scheduling pipeline (§3.2 + Algorithm 1).

Stages, each a gradual Codelet transformation:

1. ``place_operands``  — inp/out surrogates move to the highest memory level
   (longest path to compute; off-chip when present).
2. ``map_compute``     — assign each compute op to an ACG compute node.  The
   paper's rule picks the node "capable of performing the most operations at
   a time"; with ``vectorize=False`` we pick the *least* parallel node, which
   is the unoptimized baseline that Fig-12's Vectorization pass improves on.
3. ``choose_tiling``   — Algorithm 1: enumerate loop-factor permutations,
   keep those whose staged tiles are data_width-aligned and fit every memory
   node on the transfer paths, then pick the cheapest by the cost model.
4. ``split_loops``     — canonical two-level nest: tile loops (outer,
   stride=tile) then intra loops; refs rewritten affinely.
5. ``insert_transfers``— per-operand staging along ACG shortest paths
   (respecting ``operand_ports``), allocation transfers create ``local``
   surrogates, write-backs return results to the operand home (Fig 8c).

All library codelets are perfect nests with a single compute op, which these
stages assume (asserted) — that covers the paper's full benchmark set.

The port's copy of ``repro.core.scheduler``, with the same logic.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

from .acg import ACG, Capability, ComputeNode, MemoryNode
from .codelet import Aff, Codelet, Compute, Loop, Ref, Surrogate, Transfer, ref_footprint

# Capability aliasing: a codelet MAC can be served by any matmul-family
# capability (§2.1.3: capabilities need not map 1:1 onto mnemonics).
MATMUL_FAMILY = ("MAC", "GEMM", "MVMUL", "MMUL")


def capability_candidates(acg: ACG, op: Compute):
    """(node, capability) pairs able to execute ``op``, best granularity first."""
    names = MATMUL_FAMILY if op.capability in MATMUL_FAMILY else (op.capability,)
    cands = []
    for name in names:
        for node, c in acg.supporting_nodes(name, op.dtype):
            cands.append((node, c))
    # prefer higher out_elems, then deeper reduction granularity
    cands.sort(key=lambda nc: (-nc[1].out_elems,
                               -(nc[1].geometry[2] if nc[1].geometry else 1)))
    return cands


# ---------------------------------------------------------------------------
# Stage 1+2: placement and compute mapping
# ---------------------------------------------------------------------------


def place_operands(cdlt: Codelet, acg: ACG) -> None:
    home = acg.highest_memory().name
    for s in cdlt.surrogates.values():
        if s.kind in ("inp", "out") and s.loc is None:
            s.loc = home
    cdlt.note(f"place_operands: home={home}")


def map_compute(cdlt: Codelet, acg: ACG, vectorize: bool = True) -> None:
    for _, op in cdlt.computes():
        cands = capability_candidates(acg, op)
        if not cands:
            raise ValueError(
                f"no ACG node in {acg.name} supports capability {op.capability!r}"
                f" (dtype {op.dtype})")
        node, c = cands[0] if vectorize else cands[-1]
        op.loc, op.cap_obj = node.name, c
        cdlt.note(f"map_compute: {op.capability} -> {node.name} [{c}]"
                  f" ({'max' if vectorize else 'min'} granularity)")


# ---------------------------------------------------------------------------
# Transfer-path resolution
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OperandPlan:
    """How one compute operand is staged: the memory path home -> staging."""

    surrogate: str
    is_output: bool
    path: list[str]          # memory nodes, home first, staging last
    ref: Ref                 # the compute op's reference (original index space)

    @property
    def staging(self) -> str:
        return self.path[-1]

    def hops(self, acg: ACG):
        """(edge, charge_node) per hop.  Inputs move home->staging along the
        listed order; outputs physically move staging->home, so the edge is
        the reverse one.  ``charge_node`` is the staging-side node whose
        capacity the tile occupies (Algorithm 1's ``storage[t.dst]``)."""
        out = []
        for a, b in zip(self.path, self.path[1:]):
            edge = acg.edge(b, a) if self.is_output else acg.edge(a, b)
            out.append((edge, b))
        return out


def plan_operands(cdlt: Codelet, acg: ACG) -> list[OperandPlan]:
    (loops, op), = cdlt.computes()
    ports = acg.operand_ports.get((op.loc, op.cap_obj.name))
    plans: list[OperandPlan] = []
    seen: set[str] = set()
    refs = list(op.ins) + [op.out]
    for i, r in enumerate(refs):
        s = cdlt.surrogates[r.var]
        is_out = s.kind == "out" and (i == len(refs) - 1 or r.var == op.out.var)
        if r.var in seen:
            continue
        seen.add(r.var)
        if ports is not None:
            staging = ports[min(i, len(ports) - 1)]
            if is_out:
                # physical flow staging -> home; list home-first
                path_nodes = acg.shortest_path(staging, s.loc)
                mem_path = [p for p in reversed(path_nodes)
                            if isinstance(acg.nodes[p], MemoryNode)]
            else:
                path_nodes = acg.shortest_path(s.loc, staging)
                mem_path = [p for p in path_nodes
                            if isinstance(acg.nodes[p], MemoryNode)]
        elif is_out:
            # stage where the compute node can write, walking back to home
            full = acg.shortest_path(op.loc, s.loc)
            mem_path = [p for p in full if isinstance(acg.nodes[p], MemoryNode)]
            mem_path = list(reversed(mem_path))  # home first, staging last
        else:
            # walk toward the compute node; staging = last memory before it
            full = acg.shortest_path(s.loc, op.loc)
            mem_path = [p for p in full[:-1] if isinstance(acg.nodes[p], MemoryNode)]
        assert mem_path and mem_path[0] == s.loc, (r.var, mem_path)
        plans.append(OperandPlan(r.var, is_out, mem_path, r))
    return plans


# ---------------------------------------------------------------------------
# Stage 3: Algorithm 1 — tiling validation + selection
# ---------------------------------------------------------------------------


def _divisors(n: int, cap: int = 8) -> list[int]:
    ds = [d for d in range(1, n + 1) if n % d == 0]
    if len(ds) <= cap:
        return ds
    # keep a spread: smallest, largest, and geometrically spaced middles
    keep = {ds[0], ds[-1]}
    want = cap - len(keep)
    for i in range(1, want + 1):
        keep.add(ds[round(i * (len(ds) - 1) / (want + 1))])
    return sorted(keep)


def _tile_footprints(cdlt: Codelet, plans: list[OperandPlan],
                     tiling: dict[str, int]) -> dict[str, tuple[int, ...]]:
    """Per-operand element footprint of one tile under ``tiling``."""
    fp = {}
    for p in plans:
        s = cdlt.surrogates[p.surrogate]
        extents = {var: tiling.get(var, _loop_range(cdlt, var))
                   for var in _ref_vars(p.ref)}
        fp[p.surrogate] = ref_footprint(p.ref, s, extents)
    return fp


def _ref_vars(r: Ref) -> set[str]:
    out = set()
    for ix in r.idx:
        out |= ix.vars()
    return out


def _loop_range(cdlt: Codelet, var: str) -> int:
    return cdlt.loop(var).trips


def validate_tiling(cdlt: Codelet, acg: ACG, plans: list[OperandPlan],
                    tiling: dict[str, int], pad_align: bool = False) -> bool:
    """Algorithm 1 body: alignment + cumulative capacity over storage nodes.

    ``pad_align=True`` is the §4 zero-padding fallback: misaligned transfer
    sizes are rounded up to the source ``data_width`` (consuming the padded
    size in the capacity check) instead of invalidating the tiling.  It is
    only used when strict Algorithm-1 admits no tiling at all.
    """
    storage: dict[str, int] = {m.name: 0 for m in acg.memory_nodes()}
    fps = _tile_footprints(cdlt, plans, tiling)
    for p in plans:
        s = cdlt.surrogates[p.surrogate]
        bits = math.prod(fps[p.surrogate]) * s.dtype.bits
        for edge, charge in p.hops(acg):
            src_m = acg.memory(edge.src)
            dst_m = acg.memory(charge)
            if bits % src_m.data_width != 0:
                if not pad_align:
                    return False
                bits = math.ceil(bits / src_m.data_width) * src_m.data_width
            storage[charge] += bits
            if not dst_m.offchip and storage[charge] > dst_m.capacity_bits:
                return False
    return True


def enumerate_tilings(cdlt: Codelet, acg: ACG, plans: list[OperandPlan],
                      max_candidates: int = 4000, pad_align: bool = False
                      ) -> list[dict[str, int]]:
    """All valid tilings over divisor grids of each loop range (pruned)."""
    loops = [l for l in cdlt.loops()]
    grids = []
    for l in loops:
        ds = _divisors(l.trips)
        grids.append([(l.var, d) for d in ds])
    valid = []
    count = 0
    for combo in itertools.product(*grids):
        count += 1
        if count > max_candidates * 50:
            break
        tiling = dict(combo)
        if validate_tiling(cdlt, acg, plans, tiling, pad_align):
            valid.append(tiling)
            if len(valid) >= max_candidates:
                break
    return valid


def choose_tiling(cdlt: Codelet, acg: ACG, plans: list[OperandPlan],
                  cost_fn) -> dict[str, int]:
    cands = enumerate_tilings(cdlt, acg, plans)
    if not cands:
        # §4 padding fallback: odd-sized tensors on wide-data_width memories
        cands = enumerate_tilings(cdlt, acg, plans, pad_align=True)
        if cands:
            cdlt.note("choose_tiling: strict Algorithm-1 empty; "
                      "using zero-padded transfer alignment (§4)")
    if not cands:
        raise ValueError(
            f"Algorithm 1 found no valid tiling for {cdlt.name} on {acg.name}")
    best, best_cost = None, None
    for t in cands:
        c = cost_fn(cdlt, acg, plans, t)
        if best_cost is None or c < best_cost:
            best, best_cost = t, c
    cdlt.note(f"choose_tiling: {best} est_cost={best_cost:.0f} "
              f"({len(cands)} valid candidates)")
    return best


def estimate_tiling_cost(cdlt: Codelet, acg: ACG, plans: list[OperandPlan],
                         tiling: dict[str, int]) -> float:
    """Transfer + compute cycle estimate used for tile selection.

    Mirrors the analytic cost model's transfer accounting: each operand's tile
    is re-loaded once per iteration of every tile loop *outside or at* its
    insertion level (reuse across inner loops it does not depend on).
    """
    loops = cdlt.loops()
    order = [l.var for l in loops]
    trips = {l.var: math.ceil(l.trips / tiling.get(l.var, l.trips)) for l in loops}
    fps = _tile_footprints(cdlt, plans, tiling)
    total = 0.0
    for p in plans:
        s = cdlt.surrogates[p.surrogate]
        bits = math.prod(fps[p.surrogate]) * s.dtype.bits
        vars_ = _ref_vars(p.ref)
        # innermost tile loop this operand depends on
        level = max((order.index(v0) for v0 in vars_ if v0 in order), default=-1)
        n_loads = math.prod([trips[v0] for v0 in order[: level + 1]]) or 1
        factor = 2 if p.is_output else 1  # alloc/load + writeback
        for e, _charge in p.hops(acg):
            total += factor * n_loads * e.transfer_ops(bits) * e.latency
    # compute cycles at current granularity
    (loops_c, op), = cdlt.computes()
    g = op.cap_obj.geometry
    work = math.prod(l.trips for l in loops)
    per_inv = math.prod(g) if g else op.cap_obj.out_elems
    total += (work / per_inv) * op.cap_obj.cycles
    return total


# ---------------------------------------------------------------------------
# The schedule-point space (search substrate)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ScheduleSpace:
    """The Algorithm-1-valid schedule-point space of one (codelet, target).

    ``tilings`` are the enumerated valid tilings; ``divisors`` maps each loop
    var to its (pruned) divisor grid — the neighbourhood structure mutation
    operators move through; ``valid`` re-checks any mutated tiling against
    Algorithm 1, so strategies may step outside the enumerated list as long
    as they stay inside the valid region.
    """

    tilings: list[dict[str, int]]
    divisors: dict[str, list[int]]
    pad_align: bool
    probe: Codelet                 # placed+mapped (pre-tiling) codelet
    acg: ACG
    plans: list[OperandPlan]

    def valid(self, tiling: dict[str, int]) -> bool:
        return validate_tiling(self.probe, self.acg, self.plans, tiling,
                               pad_align=self.pad_align)

    # -- prefix enumeration (the beam-search substrate) ----------------------
    def loop_order(self) -> list[str]:
        """Loop vars in nest order — the order beam search commits tiling
        decisions (outermost first, matching ``split_loops``' tile-loop
        order)."""
        return [l.var for l in self.probe.loops()]

    def prefixes(self, depth: int,
                 within: "list[tuple] | None" = None) -> list[tuple]:
        """Distinct ``depth``-long factor prefixes (in loop order) of the
        enumerated valid tilings; ``within`` restricts to prefixes that
        extend one of the given ``depth-1``-long prefixes.  Every returned
        prefix has at least one valid completion by construction — beam
        pruning never strands itself on an infeasible partial schedule."""
        order = self.loop_order()[:depth]
        allowed = set(within) if within is not None else None
        out: dict[tuple, None] = {}
        for t in self.tilings:
            vec = tuple(t[v] for v in order)
            if allowed is not None and vec[:-1] not in allowed:
                continue
            out[vec] = None
        return sorted(out)

    def committed(self, prefix: tuple) -> dict[str, int]:
        """A factor prefix (aligned with ``loop_order()``) as a partial
        tiling dict — the ``committed`` argument of ``cost.prefix_bound``."""
        return dict(zip(self.loop_order(), prefix))

    def signature(self) -> str:
        """Shape identity of this schedule space: loop order, ranges and
        divisor grids.  Two layers with equal signatures admit exactly the
        same schedule points, so recorded best points transfer verbatim —
        the warm-start index groups by this."""
        import hashlib
        parts = [f"{l.var}:{l.trips}:{','.join(map(str, self.divisors[l.var]))}"
                 for l in self.probe.loops()]
        parts.append(f"pad={int(self.pad_align)}")
        return hashlib.sha256(";".join(parts).encode()).hexdigest()[:16]


def schedule_space(cdlt: Codelet, acg: ACG, *, options=None, pipeline=None,
                   max_candidates: int = 2000) -> ScheduleSpace:
    """Enumerate the valid schedule-point space by running the pipeline's
    pre-tiling prefix (every stage before ``tile``, including any spliced
    target hooks) on a probe clone and applying Algorithm 1 over the
    divisor grids — the probe sees exactly what candidate materialisation
    will see."""
    from .pipeline import CompileOptions, PassContext, Pipeline

    ctx = PassContext(cdlt.clone(), acg, options or CompileOptions())
    pl = pipeline or Pipeline.default().with_acg_hooks(acg)
    names = pl.names
    if "tile" in names:
        pl.run(ctx, skip=names[names.index("tile"):])
    else:
        pl.run(ctx, until="map_compute")
    plans = plan_operands(ctx.cdlt, acg)
    pad = False
    tilings = enumerate_tilings(ctx.cdlt, acg, plans,
                                max_candidates=max_candidates)
    if not tilings:
        pad = True
        tilings = enumerate_tilings(ctx.cdlt, acg, plans,
                                    max_candidates=max_candidates,
                                    pad_align=True)
    divisors = {l.var: _divisors(l.trips) for l in ctx.cdlt.loops()}
    return ScheduleSpace(tilings, divisors, pad, ctx.cdlt, acg, plans)


# ---------------------------------------------------------------------------
# Stage 4: loop splitting into the canonical tiled nest
# ---------------------------------------------------------------------------

INTRA_SUFFIX = "_i"


def split_loops(cdlt: Codelet, tiling: dict[str, int]) -> None:
    """Rebuild the body as tile-loops(outer) -> intra-loops -> compute.

    An original loop ``x`` with range R and tile t < R becomes
    ``loop x(0,R,t){ ... loop x_i(0,t,1){ ... } }`` with refs rewritten
    ``x -> x + x_i``.  Loops whose tile equals their range stay as single
    intra loops (no outer twin, no rewrite).
    """
    (loops, op), = cdlt.computes()
    orig = list(loops)
    cdlt.tiling = dict(tiling)
    tiled = {l.var: tiling[l.var] for l in orig
             if tiling.get(l.var, l.trips) < l.trips}

    def rewrite(r: Ref) -> Ref:
        new_idx = []
        for ix in r.idx:
            e = Aff(ix.terms, ix.const)
            for var, coeff in ix.terms:
                if var in tiled:
                    e = e + Aff(((var + INTRA_SUFFIX, coeff),), 0)
            new_idx.append(e)
        return Ref(r.var, tuple(new_idx), r.sizes)

    new_op = Compute(op.capability, rewrite(op.out),
                     tuple(rewrite(i) for i in op.ins), op.loc,
                     dict(op.roles), op.cap_obj, op.dtype)
    # intra roles: the split moves tiled role vars to their intra twins
    new_op.roles = {
        role: [(var + INTRA_SUFFIX) if var in tiled else var for var in vars_]
        for role, vars_ in op.roles.items()
    }

    body: list = [new_op]
    for l in reversed(orig):  # intra loops, innermost-first wrap
        if l.var in tiled:
            body = [Loop(l.var + INTRA_SUFFIX, 0, tiled[l.var], 1, body, role="intra")]
        else:
            body = [Loop(l.var, 0, l.trips, 1, body, role="intra")]
    for l in reversed(orig):  # tile loops
        if l.var in tiled:
            body = [Loop(l.var, 0, l.trips, tiled[l.var], body, role="tile")]
    cdlt.body = body
    cdlt.note(f"split_loops: tiling={tiling}")


# ---------------------------------------------------------------------------
# Stage 5: transfer insertion
# ---------------------------------------------------------------------------


def insert_transfers(cdlt: Codelet, acg: ACG, plans: list[OperandPlan]) -> None:
    tile_loops = [l for l in cdlt.loops() if l.role == "tile"]
    order = [l.var for l in tile_loops]
    (_, op), = cdlt.computes()
    # per-tile footprints: tile-loop vars are fixed bases (extent 1), all
    # inner loops (intra twins + untiled full loops) contribute their trips
    intra_trips = {l.var: l.trips for l in cdlt.loops() if l.role == "intra"}
    fps: dict[str, tuple[int, ...]] = {}
    for p in plans:
        s = cdlt.surrogates[p.surrogate]
        extents = {var: intra_trips.get(var, 1) for var in _ref_vars(p.ref)}
        fps[p.surrogate] = ref_footprint(p.ref, s, extents)

    def insertion_body(vars_: set[str]) -> list:
        level = max((order.index(v0) for v0 in vars_ if v0 in order), default=-1)
        return cdlt.body if level < 0 else tile_loops[level].body

    local_of: dict[str, str] = {}
    for p in plans:
        s = cdlt.surrogates[p.surrogate]
        sizes = fps[p.surrogate]
        vars_ = _ref_vars(p.ref) & set(order)
        body = insertion_body(vars_)
        # index of the tile base (outer vars only)
        base_idx = tuple(
            Aff(tuple((vv, c) for vv, c in ix.terms if vv in order), ix.const)
            for ix in p.ref.idx
        )
        prev_name, prev_loc = p.surrogate, p.path[0]
        loads: list[Transfer] = []
        for hop_dst in p.path[1:]:
            lname = cdlt.fresh_name(p.surrogate + "_")
            cdlt.local(lname, sizes, s.dtype, hop_dst)
            src_ref = Ref(prev_name,
                          base_idx if prev_name == p.surrogate else (),
                          sizes)
            if p.is_output:
                # allocation transfer with const fill (accumulator tile)
                loads.append(Transfer(Ref("", (), None), sizes, dst_loc=hop_dst,
                                      alloc=lname, fill=0))
            else:
                loads.append(Transfer(src_ref, sizes, dst_loc=hop_dst, alloc=lname))
            local_of[p.surrogate] = lname
            prev_name, prev_loc = lname, hop_dst
        for t in reversed(loads):
            body.insert(0, t)
        if p.is_output:
            # write-back chain staging -> ... -> home, appended after the nest
            back = list(reversed(p.path))
            prev = local_of[p.surrogate]
            for nxt in back[1:]:
                if nxt == p.path[0]:
                    dst_ref = Ref(p.surrogate, base_idx, sizes)
                else:
                    lname = cdlt.fresh_name(p.surrogate + "_")
                    cdlt.local(lname, sizes, s.dtype, nxt)
                    dst_ref = Ref(lname, (), sizes)
                body.append(Transfer(Ref(prev, (), sizes), sizes, dst=dst_ref))
                prev = dst_ref.var

    # retarget the compute op onto the staged locals (intra index space)
    def localize(r: Ref) -> Ref:
        if r.var not in local_of:
            return r
        new_idx = tuple(
            Aff(tuple((vv, c) for vv, c in ix.terms if vv not in order), 0)
            for ix in r.idx
        )
        return Ref(local_of[r.var], new_idx, r.sizes)

    op.out = localize(op.out)
    op.ins = tuple(localize(i) for i in op.ins)
    cdlt.note(f"insert_transfers: staged {sorted(local_of)} -> "
              f"{[local_of[k] for k in sorted(local_of)]}")


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def schedule(cdlt: Codelet, acg: ACG, config=None) -> Codelet:
    """Thin stable wrapper over the named pass pipeline (``pipeline.py``):
    runs every stage but ``codegen`` on a clone and returns it.  ``config``
    is a ``CompileOptions`` (the old ``ScheduleConfig``, kept as an alias).
    """
    from .pipeline import CompileOptions, PassContext, Pipeline

    config = config or CompileOptions()
    ctx = PassContext(cdlt.clone(), acg, config)
    Pipeline.default().with_acg_hooks(acg).run(ctx, skip=("codegen",))
    ctx.cdlt.note(f"schedule: done (vectorize={config.vectorize}, "
                  f"unroll={config.unroll}, pack={config.pack})")
    return ctx.cdlt


def __getattr__(name: str):
    # ScheduleConfig was unified into pipeline.CompileOptions; keep the old
    # import path (``from repro_torch.core.scheduler import ScheduleConfig``) alive.
    if name == "ScheduleConfig":
        from .pipeline import CompileOptions
        return CompileOptions
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["OperandPlan", "ScheduleConfig", "ScheduleSpace",
           "capability_candidates", "choose_tiling", "enumerate_tilings",
           "estimate_tiling_cost", "insert_transfers", "map_compute",
           "place_operands", "plan_operands", "schedule", "schedule_space",
           "split_loops", "validate_tiling"]
