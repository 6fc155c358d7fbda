"""The Covenant tiler: placement, compute mapping and Algorithm 1.

A trimmed copy of ``repro.core.scheduler`` holding what the kernel tiler
(``repro_torch.kernels.tiling``) calls, with the same logic:

1. ``place_operands``  — inp/out surrogates move to the highest memory level
   (longest path to compute; off-chip when present).
2. ``map_compute``     — assign each compute op to an ACG compute node (the
   node "capable of performing the most operations at a time").
3. Algorithm 1         — ``enumerate_tilings`` keeps loop-factor choices
   whose staged tiles are data_width-aligned and fit every memory node on
   the transfer paths (``validate_tiling``); ``estimate_tiling_cost`` ranks
   them.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

from .acg import ACG, MemoryNode
from .codelet import Codelet, Compute, Ref, ref_footprint

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


__all__ = ["MATMUL_FAMILY", "OperandPlan", "capability_candidates",
           "enumerate_tilings", "estimate_tiling_cost", "map_compute",
           "place_operands", "plan_operands", "validate_tiling"]
