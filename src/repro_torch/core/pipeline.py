"""Pluggable compilation pipeline: named, registered passes over Codelets.

The paper's central claim is that the ACG makes compilation workflows
*adaptable* — a new accelerator brings attributes (and rarely a pass), not a
new compiler.  This module is the seam that realises the claim as an API:

* every Covenant stage is a **named, registered pass** ``(PassContext) ->
  None`` (``place``, ``map_compute``, ``tile``, ``split``, ``transfers``,
  ``granularize``, ``vectorize``, ``unroll``, ``pack``, ``codegen``), each a
  thin orchestration shim over the existing scheduler/passes/codegen
  machinery;
* a ``Pipeline`` is an ordered list of such passes with functional edit
  operations (``override`` / ``insert_before`` / ``insert_after`` /
  ``without``) — BYOC-style: targets extend the stock flow instead of
  redeveloping it;
* an ACG may carry per-target hooks (``acg.pass_overrides`` replaces a stage
  body, ``acg.extra_passes`` splices new stages at a named position);
  ``Pipeline.with_acg_hooks`` applies them, and ``repro_torch.compile`` does
  so by default;
* ``CompileOptions`` is the single frozen knob set for the whole flow — the
  unification of the old ``ScheduleConfig`` (which remains importable as an
  alias) with the codegen limits that used to travel as loose kwargs.

Stages honour ``CompileOptions`` gating internally (e.g. the ``vectorize``
stage is a no-op when ``options.vectorize`` is false), so one pipeline
serves every configuration and overrides see the full context.

The port's copy of ``repro.core.pipeline``, with the same logic.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from .acg import ACG
from .codelet import Codelet

# ---------------------------------------------------------------------------
# options — the ScheduleConfig/loose-kwargs unification
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CompileOptions:
    """All knobs of one compile, hashable so it can key the compile cache.

    ``vectorize`` / ``unroll`` / ``pack`` / ``unroll_factor`` are the old
    ``ScheduleConfig`` fields (Fig-12 optimization toggles); ``max_mnemonics``
    is the stream-size guard that used to be a ``codegen.generate`` kwarg.

    ``search`` (a ``repro_torch.core.search.SearchOptions``) routes the compile
    through schedule search instead of the one-shot heuristic — the searched
    winner is cached under the same content-addressed key scheme (the search
    options are part of the key).  ``store`` names a disk-backed
    ``ArtifactStore`` (instance or directory path); it is a *location*, not a
    compile input, so it does not contribute to the fingerprint.
    """

    vectorize: bool = True
    unroll: bool = True
    pack: bool = True
    unroll_factor: int = 4
    max_mnemonics: int = 300_000
    check_covenant: bool = True    # run the early covenant-validation stage
    search: object | None = None   # SearchOptions; None = one-shot heuristic
    store: object | None = None    # ArtifactStore | path; not fingerprinted

    def fingerprint(self) -> str:
        base = repr((self.vectorize, self.unroll, self.pack,
                     self.unroll_factor, self.max_mnemonics,
                     self.check_covenant))
        if self.search is not None:
            fp = getattr(self.search, "fingerprint", None)
            base += ";search=" + (fp() if fp else repr(self.search))
        return base


@dataclasses.dataclass
class PassContext:
    """Mutable state threaded through the pipeline.

    ``cdlt`` is transformed in place (it is always a clone of the caller's
    codelet); ``state`` carries inter-stage products (``plans``, ``tiling``,
    ``pack``, ``program``); ``executed`` logs stage names for introspection.

    ``overrides`` injects a *schedule point* as data: ``{"tiling": {var:
    factor}, "unroll_factor": n}`` makes the ``tile`` stage adopt the given
    tiling instead of running Algorithm-1 selection and the ``unroll`` stage
    use the given factor.  This is how schedule search materialises
    candidates and how the artifact store replays a stored schedule.
    """

    cdlt: Codelet
    acg: ACG
    options: CompileOptions
    state: dict = dataclasses.field(default_factory=dict)
    executed: list = dataclasses.field(default_factory=list)
    overrides: dict = dataclasses.field(default_factory=dict)


class PipelineError(ValueError):
    """A pipeline edit or ACG hook referenced a stage that does not exist
    (or used a malformed splice position)."""


StageFn = Callable[[PassContext], None]

# name -> stage function; targets and users can register additional stages.
STAGES: dict[str, StageFn] = {}


def register_stage(name: str) -> Callable[[StageFn], StageFn]:
    def deco(fn: StageFn) -> StageFn:
        STAGES[name] = fn
        return fn
    return deco


# ---------------------------------------------------------------------------
# the stock Covenant stages (§3.2 scheduling, §4 optimizations, §3.3 codegen)
# ---------------------------------------------------------------------------


@register_stage("covenant")
def covenant_stage(ctx: PassContext) -> None:
    """Early covenant validation (§2): every compute op must have a
    supporting capability, an encodable mnemonic and a viable staging
    route *before* scheduling starts, so a broken covenant surfaces as a
    named ``CovenantError`` diagnostic instead of a KeyError deep in
    tiling or codegen.  Disable with ``CompileOptions(check_covenant=
    False)``."""
    if not getattr(ctx.options, "check_covenant", True):
        return
    from .covenant import check_covenant
    check_covenant(ctx.cdlt, ctx.acg, options=ctx.options)


@register_stage("place")
def place_stage(ctx: PassContext) -> None:
    from .scheduler import place_operands
    place_operands(ctx.cdlt, ctx.acg)


@register_stage("map_compute")
def map_compute_stage(ctx: PassContext) -> None:
    from .scheduler import map_compute
    map_compute(ctx.cdlt, ctx.acg, vectorize=ctx.options.vectorize)


@register_stage("tile")
def tile_stage(ctx: PassContext) -> None:
    from .scheduler import choose_tiling, estimate_tiling_cost, plan_operands
    plans = plan_operands(ctx.cdlt, ctx.acg)
    ctx.state["plans"] = plans
    override = ctx.overrides.get("tiling")
    if override is not None:
        # the schedule point is data: adopt the injected tiling verbatim
        # (search candidates come pre-validated by Algorithm 1; store
        # replays record a tiling that was valid when first compiled)
        ctx.state["tiling"] = dict(override)
        ctx.cdlt.note(f"tile: injected tiling={dict(override)}")
    else:
        ctx.state["tiling"] = choose_tiling(ctx.cdlt, ctx.acg, plans,
                                            estimate_tiling_cost)


@register_stage("split")
def split_stage(ctx: PassContext) -> None:
    from .scheduler import split_loops
    split_loops(ctx.cdlt, ctx.state["tiling"])


@register_stage("transfers")
def transfers_stage(ctx: PassContext) -> None:
    from .scheduler import insert_transfers, plan_operands
    # refs were rewritten by the split; re-plan before materialising moves
    plans = plan_operands(ctx.cdlt, ctx.acg)
    ctx.state["plans"] = plans
    insert_transfers(ctx.cdlt, ctx.acg, plans)


@register_stage("granularize")
def granularize_stage(ctx: PassContext) -> None:
    from .passes import granularize
    granularize(ctx.cdlt, ctx.acg)


@register_stage("vectorize")
def vectorize_stage(ctx: PassContext) -> None:
    if not ctx.options.vectorize:
        return
    from .passes import vectorize
    vectorize(ctx.cdlt, ctx.acg)


@register_stage("unroll")
def unroll_stage(ctx: PassContext) -> None:
    if not ctx.options.unroll:
        return
    factor = ctx.overrides.get("unroll_factor", ctx.options.unroll_factor)
    if factor <= 1:
        return
    from .passes import unroll
    unroll(ctx.cdlt, ctx.acg, factor)


@register_stage("pack")
def pack_stage(ctx: PassContext) -> None:
    # packing is applied at analysis/execution time (cost model II bound,
    # stream packet former); this stage records the decision for consumers.
    ctx.state["pack"] = bool(ctx.options.pack) and ctx.acg.issue_slots > 1


@register_stage("codegen")
def codegen_stage(ctx: PassContext) -> None:
    from .codegen import generate
    ctx.state["program"] = generate(
        ctx.cdlt, ctx.acg, max_mnemonics=ctx.options.max_mnemonics,
        macros=ctx.state.get("macros"))


# The stock stage order.  ``SCHEDULE_STAGES`` is the prefix the legacy
# ``scheduler.schedule`` wrapper runs (everything but code generation).
DEFAULT_STAGE_ORDER: tuple[str, ...] = (
    "covenant", "place", "map_compute", "tile", "split", "transfers",
    "granularize", "vectorize", "unroll", "pack", "codegen",
)
SCHEDULE_STAGES: tuple[str, ...] = DEFAULT_STAGE_ORDER[:-1]


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


def _capture_tag(value) -> str:
    """Identity contribution of one captured closure value / defaults
    tuple.  ``repr`` is used when it is faithful; a repr that raises or
    elides content (numpy's ``...`` truncation) falls back to object id —
    process-local, so distinct values never alias (the safe direction)."""
    try:
        r = repr(value)
    except Exception:
        return f"@{id(value):x}"
    if "..." in r:
        return f"@{id(value):x}"
    return r


class Pipeline:
    """An ordered list of named passes; edit operations return new Pipelines
    (the default pipeline is shared, so edits must not mutate in place)."""

    def __init__(self, stages: Sequence[tuple[str, StageFn]]):
        self.stages: list[tuple[str, StageFn]] = list(stages)

    @classmethod
    def default(cls) -> "Pipeline":
        return cls([(n, STAGES[n]) for n in DEFAULT_STAGE_ORDER])

    @property
    def names(self) -> list[str]:
        return [n for n, _ in self.stages]

    def _index(self, name: str) -> int:
        for i, (n, _) in enumerate(self.stages):
            if n == name:
                return i
        raise PipelineError(
            f"no stage {name!r} in pipeline; stages: {self.names}")

    # -- functional edits ----------------------------------------------------
    def override(self, name: str, fn: StageFn) -> "Pipeline":
        """Replace the body of stage ``name`` (BYOC-style target override)."""
        i = self._index(name)
        out = list(self.stages)
        out[i] = (name, fn)
        return Pipeline(out)

    def insert_after(self, anchor: str, name: str, fn: StageFn) -> "Pipeline":
        i = self._index(anchor)
        out = list(self.stages)
        out.insert(i + 1, (name, fn))
        return Pipeline(out)

    def insert_before(self, anchor: str, name: str, fn: StageFn) -> "Pipeline":
        i = self._index(anchor)
        out = list(self.stages)
        out.insert(i, (name, fn))
        return Pipeline(out)

    def without(self, name: str) -> "Pipeline":
        i = self._index(name)
        out = list(self.stages)
        del out[i]
        return Pipeline(out)

    def with_acg_hooks(self, acg: ACG) -> "Pipeline":
        """Apply a target's pass hooks: ``acg.pass_overrides`` (stage name ->
        replacement fn) and ``acg.extra_passes`` (("after:STAGE" |
        "before:STAGE", name, fn) splices)."""
        pl = self
        for name, fn in getattr(acg, "pass_overrides", {}).items():
            pl = pl.override(name, fn)
        for position, name, fn in getattr(acg, "extra_passes", ()):
            where, _, anchor = position.partition(":")
            if where == "after":
                pl = pl.insert_after(anchor, name, fn)
            elif where == "before":
                pl = pl.insert_before(anchor, name, fn)
            else:
                raise PipelineError(
                    f"extra pass {name!r}: position must be "
                    f"'after:STAGE' or 'before:STAGE', got {position!r}")
        return pl

    # -- execution -----------------------------------------------------------
    def run(self, ctx: PassContext, until: str | None = None,
            skip: Sequence[str] = ()) -> PassContext:
        """Run stages in order.  ``until`` stops after the named stage
        (inclusive); ``skip`` omits stages by name (used by the driver to
        defer ``codegen`` until the artifact's program is first needed)."""
        for name, fn in self.stages:
            if name not in skip:
                fn(ctx)
                ctx.executed.append(name)
            if name == until:
                break
        return ctx

    def run_stage(self, name: str, ctx: PassContext) -> PassContext:
        """Run a single stage by name (e.g. deferred ``codegen``)."""
        _, fn = self.stages[self._index(name)]
        fn(ctx)
        ctx.executed.append(name)
        return ctx

    def fingerprint(self) -> str:
        """Cache-key contribution.  Stock stages are identified by name;
        custom functions by qualname + a hash of their source *plus* their
        default args and captured closure values, which is stable across
        processes — required for the disk artifact store to give
        BYOC/custom-target compiles warm hits — while two closures from
        the same factory with different captured parameters still get
        distinct keys.  Captures whose ``repr`` embeds object addresses
        hash process-locally (never a cross-process hit — the safe
        direction); callers mutating closure state after compiling should
        pass ``cache=False`` to ``repro_torch.compile``.  Functions without
        retrievable source (REPL, ``exec``) fall back to ``id``."""
        import hashlib
        import inspect

        parts = []
        for name, fn in self.stages:
            if STAGES.get(name) is fn:
                parts.append(name)
                continue
            try:
                ident = [inspect.getsource(fn)]
            except (OSError, TypeError):
                ident = [f"@{id(fn):x}"]
            if getattr(fn, "__defaults__", None):
                ident.append(_capture_tag(fn.__defaults__))
            for cell in getattr(fn, "__closure__", None) or ():
                try:
                    ident.append(_capture_tag(cell.cell_contents))
                except ValueError:
                    ident.append("<empty-cell>")
            tag = hashlib.sha256(
                "\x00".join(ident).encode()).hexdigest()[:16]
            parts.append(f"{name}:{getattr(fn, '__qualname__', '?')}:{tag}")
        return ";".join(parts)

    def __repr__(self) -> str:
        return f"Pipeline({' -> '.join(self.names)})"


__all__ = ["CompileOptions", "DEFAULT_STAGE_ORDER", "PassContext", "Pipeline",
           "PipelineError", "SCHEDULE_STAGES", "STAGES", "register_stage"]
