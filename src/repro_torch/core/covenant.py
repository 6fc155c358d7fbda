"""Covenant validation — does this codelet have a lawful mapping onto this
ACG, and is the ACG itself sound?

Before this module, a broken covenant surfaced as a ``KeyError`` deep in
scheduling or code generation (a missing mnemonic three passes after the
decision that needed it, an undersized scratchpad as "Algorithm 1 found no
valid tiling").  ``check_covenant`` runs the same capability / mnemonic /
staging-path / footprint matching *up front*, as the first pipeline stage,
and reports every violation with the name of the thing that is missing or
too small plus a hint about what would fix it.

Two layers:

* ``validate_acg(acg)``     — the target alone: structural spec checks
  (via ``spec.validate_spec`` on a snapshot) plus graph reachability that
  only a built graph can answer (home memory resolvable, every compute
  node round-trip reachable from the operand home).
* ``check_covenant(cdlt, acg)`` — the pairing: every compute op must have
  a supporting capability, a mnemonic to encode it, a staging route for
  each operand, and staging memories big enough for one invocation tile.

The port's copy of ``repro.core.covenant``, with the same logic.
"""
from __future__ import annotations

import dataclasses

import networkx as nx

from .acg import ACG, MemoryNode
from .codelet import Codelet

# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CovenantViolation:
    """One named break in the covenant.

    ``kind`` is the violation class (``capability`` / ``mnemonic`` /
    ``memory`` / ``path`` / ``structure``), ``subject`` the ACG or codelet
    entity at fault, ``message`` the failure, ``hint`` what would repair it.
    """

    kind: str
    subject: str
    message: str
    hint: str = ""

    def __str__(self) -> str:
        s = f"[{self.kind}] {self.subject}: {self.message}"
        if self.hint:
            s += f" ({self.hint})"
        return s


class CovenantError(ValueError):
    """The covenant between a codelet and an ACG is broken; ``violations``
    carries the structured diagnostics."""

    def __init__(self, cdlt_name: str, acg_name: str,
                 violations: list[CovenantViolation]):
        self.cdlt_name = cdlt_name
        self.acg_name = acg_name
        self.violations = list(violations)
        bullet = "\n  - ".join(str(v) for v in self.violations)
        super().__init__(
            f"broken covenant: codelet {cdlt_name!r} cannot map onto "
            f"ACG {acg_name!r}:\n  - {bullet}")


# ---------------------------------------------------------------------------
# target-only validation
# ---------------------------------------------------------------------------


def validate_acg(acg: ACG, *, raise_on_error: bool = True) -> list[str]:
    """Structural + reachability checks over a built ACG.  Returns the
    problem list; raises ``spec.SpecError`` on problems unless told not to."""
    from .spec import SpecError, validate_spec

    problems = validate_spec(acg.to_spec(), raise_on_error=False)
    try:
        home = acg.highest_memory()
    except ValueError as e:
        problems.append(str(e))
        home = None
    if home is not None:
        for cu in acg.compute_nodes():
            try:
                acg.shortest_path(home.name, cu.name)
            except (nx.NetworkXNoPath, nx.NodeNotFound):
                problems.append(
                    f"compute {cu.name}: unreachable from the operand home "
                    f"{home.name} — inputs cannot be staged")
            try:
                acg.shortest_path(cu.name, home.name)
            except (nx.NetworkXNoPath, nx.NodeNotFound):
                problems.append(
                    f"compute {cu.name}: no route back to the operand home "
                    f"{home.name} — outputs cannot be written back")
    if problems and raise_on_error:
        raise SpecError(acg.name, problems)
    return problems


# ---------------------------------------------------------------------------
# codelet-vs-ACG validation
# ---------------------------------------------------------------------------


def _staging_memory(acg: ACG, path: list[str]) -> MemoryNode | None:
    """Last memory node on a home->compute path (the staging buffer)."""
    mems = [acg.nodes[n] for n in path
            if isinstance(acg.nodes[n], MemoryNode)]
    return mems[-1] if mems else None


def check_covenant(cdlt: Codelet, acg: ACG, options=None, *,
                   raise_on_error: bool = True) -> list[CovenantViolation]:
    """Verify every compute op of ``cdlt`` has a lawful mapping onto
    ``acg``: a supporting capability, an encodable mnemonic, a staging
    route per operand, and staging memories that can hold at least one
    invocation tile.  Runs before placement (the ``covenant`` pipeline
    stage), so it reasons from the hypothetical mapping compute-mapping
    would pick — widest capability under ``options.vectorize`` (the
    default), narrowest otherwise.
    """
    from .scheduler import capability_candidates

    violations: list[CovenantViolation] = []
    try:
        home = acg.highest_memory()
    except ValueError as e:
        violations.append(CovenantViolation(
            "structure", acg.name, str(e),
            hint="declare at least one memory node reaching a compute node"))
        home = None
    vectorize = getattr(options, "vectorize", True)

    required = ["XFER", "ALLOC"] + (["LOOPI"] if acg.loop_overhead > 0 else [])
    for name in required:
        if name not in acg.mnemonics:
            violations.append(CovenantViolation(
                "mnemonic", name,
                f"ACG {acg.name!r} defines no {name!r} mnemonic, which "
                f"transfer/loop code generation requires",
                hint="add it to the spec's mnemonics (see "
                     "spec.common_mnemonics)"))

    for _, op in cdlt.computes():
        cands = capability_candidates(acg, op)
        if not cands:
            have = sorted({c.name for n in acg.compute_nodes()
                           for c in n.capabilities})
            violations.append(CovenantViolation(
                "capability", op.capability,
                f"no compute node of ACG {acg.name!r} supports capability "
                f"{op.capability!r} at dtype {op.dtype}",
                hint=f"declared capabilities: {have}"))
            continue
        node, capo = cands[0] if vectorize else cands[-1]
        if capo.name not in acg.mnemonics and \
                op.capability not in acg.mnemonics:
            violations.append(CovenantViolation(
                "mnemonic", capo.name,
                f"capability {capo.name!r} on node {node.name} has no "
                f"mnemonic definition (nor has its codelet alias "
                f"{op.capability!r})",
                hint=f"defined mnemonics: {sorted(acg.mnemonics)}"))
        if home is None:
            continue

        ports = acg.operand_ports.get((node.name, capo.name))
        refs = list(op.ins) + [op.out]
        cap_ops = list(capo.inputs) + list(capo.outputs)
        seen: set[str] = set()
        for i, r in enumerate(refs):
            s = cdlt.surrogates.get(r.var)
            if s is None or s.kind == "param" or r.var in seen:
                continue
            seen.add(r.var)
            src = s.loc or home.name
            is_out = s.kind == "out"
            if ports is not None:
                staging_name = ports[min(i, len(ports) - 1)]
                if staging_name not in acg.nodes:
                    violations.append(CovenantViolation(
                        "path", staging_name,
                        f"operand_ports for ({node.name}, {capo.name}) "
                        f"names unknown node {staging_name!r}"))
                    continue
                route = (staging_name, src) if is_out else (src, staging_name)
            else:
                route = (node.name, src) if is_out else (src, node.name)
            try:
                path = acg.shortest_path(*route)
            except (nx.NetworkXNoPath, nx.NodeNotFound):
                violations.append(CovenantViolation(
                    "path", r.var,
                    f"no ACG route {route[0]} -> {route[1]} to stage "
                    f"operand {r.var!r} for {capo.name} on {node.name}",
                    hint="connect the nodes (spec edges) or set "
                         "operand_ports"))
                continue
            staging = _staging_memory(
                acg, list(reversed(path)) if is_out else path)
            if staging is None or staging.offchip:
                continue
            cap_op = cap_ops[min(i, len(cap_ops) - 1)]
            elems = cap_op.elems
            if s.shape is not None:
                elems = min(elems, s.elems)
            dtype_bits = s.dtype.bits if s.dtype is not None \
                else cap_op.dtype.bits
            need = elems * dtype_bits
            if need > staging.capacity_bits:
                violations.append(CovenantViolation(
                    "memory", staging.name,
                    f"memory node {staging.name} "
                    f"({staging.capacity_bits} bits) cannot hold one "
                    f"{capo.name} invocation tile of operand {r.var!r} "
                    f"({need} bits)",
                    hint=f"grow {staging.name} (depth/banks) or drop to a "
                         f"smaller-granularity capability"))

    if violations and raise_on_error:
        raise CovenantError(cdlt.name, acg.name, violations)
    return violations


__all__ = ["CovenantError", "CovenantViolation", "check_covenant",
           "validate_acg"]
