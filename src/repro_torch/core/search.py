"""Search-based schedule optimization (§4's "enabling optimization").

The paper positions Covenant as the substrate that lets Ansor/FlexTensor-
style search run against NEW accelerators: Algorithm 1 prunes the
transformation space to *valid* schedules, and the ACG-aware cost model
replaces on-device measurement.  This module is that loop, as a driver
subsystem:

    space      = Algorithm-1-valid tilings x unroll factors
                 (scheduler.schedule_space)
    candidate  = a schedule *point* injected into the stock pass pipeline
                 via PassContext.overrides — materialisation is exactly
                 ``repro_torch.compile``'s flow, never a private pass chain
    score      = mnemonic-faithful analytic cycles (cost.py)
    strategy   = a registered SearchStrategy: ``beam`` (cost-bound-guided
                 prefix enumeration), ``evolutionary`` (divisor-
                 neighbourhood mutation, transfer-aware), ``random``,
                 ``grid``, ``exhaustive``

Cost-model guidance (the paper's §4 claim that an architecture-faithful
model, not blind enumeration, is what makes search affordable):

* ``beam`` commits tiling decisions loop-by-loop as *prefixes*, scoring
  each partial schedule with ``cost.prefix_bound`` — an admissible lower
  bound (committed loops cost exactly, uncommitted loops at their
  best-case tile) — and pruning to the top ``beam_width`` prefixes per
  level; only surviving complete points are materialised and evaluated.
* ``evolutionary`` mutation is transfer-aware: when a parent's
  ``CostReport`` is transfer-dominated, the mutated loop is drawn from
  the loops of the operand whose staging edges dominate
  ``transfer_cycles`` (``cost.transfer_hot_vars``) instead of uniformly.
* ``SearchOptions(warm_start=True)`` seeds the initial population from
  the best recorded points of same-``ScheduleSpace``-shaped layers in the
  artifact store (``store.WarmStartIndex``, built from the sweep
  journals), so a fleet's measurements accelerate every later search.

Drive it through the compile driver — ``repro_torch.compile(layer, target,
CompileOptions(search=SearchOptions(...)))`` — so searched schedules flow
through the same artifact/cache/store path as heuristic ones; the legacy
``search_schedule`` entry point remains as a thin wrapper.

Determinism: candidate generation and mutation draw from *separate* seeded
streams, so the same (codelet, target, options, seed) always yields an
identical trace and winner regardless of how a strategy interleaves the
two (tests/test_search.py asserts this).

The port's copy of ``repro.core.search``, with the same logic.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, Sequence

from . import cost as cost_mod
from .acg import ACG
from .codelet import Codelet
from .pipeline import CompileOptions, PassContext, Pipeline
from .scheduler import ScheduleSpace, schedule_space

# a schedule point: (sorted (var, factor) tiling items, unroll factor)
Point = tuple[tuple, int]


@dataclasses.dataclass(frozen=True)
class SearchOptions:
    """Knobs of one schedule search; hashable + fingerprintable so a
    searched compile is content-addressed like any other.

    ``generations * population`` is every strategy's evaluation budget
    (materialised candidate count) — strategies are budget-comparable by
    construction.  ``beam_width`` is the FLOOR on the ``beam`` strategy's
    per-level prefix survivor count (a larger budget widens the beam so
    every evaluation slot gets a distinct tiling); ``warm_start`` seeds
    the search from the artifact store's best same-shaped recorded points
    (making the result depend on store history as well as the seed);
    ``patience`` stops a strategy after that many consecutive trace
    entries without improvement (``None`` = run the full budget)."""

    strategy: str = "evolutionary"
    generations: int = 6
    population: int = 16
    elite: int = 4
    unroll_choices: tuple = (1, 2, 4, 8)
    seed: int = 0
    max_candidates: int = 2000
    beam_width: int = 8
    warm_start: bool = False
    patience: int | None = None

    def fingerprint(self) -> str:
        return repr(dataclasses.astuple(self))

    @property
    def budget(self) -> int:
        return max(1, self.generations * self.population)


@dataclasses.dataclass
class SearchResult:
    best: Codelet
    best_cycles: float
    heuristic_cycles: float
    evaluated: int
    trace: list                    # (generation, best_cycles_so_far)
    strategy: str = "evolutionary"
    point: dict | None = None      # winning {"tiling", "unroll_factor"};
    #                                None when the heuristic won
    seeded: int = 0                # warm-start seeds injected
    space_sig: str | None = None   # ScheduleSpace shape id (warm-start key)
    best_ctx: PassContext | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def gain(self) -> float:
        """heuristic/best cycle ratio.  Degenerate zero-cycle schedules
        (the seed point already sits at the space optimum) report 0.0
        instead of dividing by zero."""
        if self.best_cycles <= 0.0:
            return 0.0 if self.heuristic_cycles <= 0.0 else float("inf")
        return self.heuristic_cycles / self.best_cycles

    def summary(self) -> dict:
        """JSON-serialisable digest (what the artifact store persists)."""
        return {"strategy": self.strategy, "best_cycles": self.best_cycles,
                "heuristic_cycles": self.heuristic_cycles,
                "evaluated": self.evaluated, "point": self.point,
                "seeded": self.seeded, "space_sig": self.space_sig,
                "trace": [list(t) for t in self.trace]}


# ---------------------------------------------------------------------------
# strategy registry
# ---------------------------------------------------------------------------

# name -> strategy fn(space, opts, evaluate, rng_init, rng_mut,
# seeds=()) -> trace.  ``evaluate(point) -> cycles`` memoises and tracks
# the incumbent (``evaluate.reports`` holds the per-point CostReport for
# transfer-aware operators); ``seeds`` are warm-start points to try first.
# A strategy only decides *which* points to visit and in what order.
StrategyFn = Callable[..., list]
STRATEGIES: dict[str, StrategyFn] = {}


def register_strategy(name: str) -> Callable[[StrategyFn], StrategyFn]:
    def deco(fn: StrategyFn) -> StrategyFn:
        STRATEGIES[name] = fn
        return fn
    return deco


def available_strategies() -> list[str]:
    return sorted(STRATEGIES)


def _tiling_key(tiling: dict) -> tuple:
    return tuple(sorted(tiling.items()))


def _random_point(space: ScheduleSpace, unrolls, rng: random.Random) -> Point:
    tiling = space.tilings[rng.randrange(len(space.tilings))]
    return (_tiling_key(tiling), rng.choice(unrolls))


def _mutate(pt: Point, space: ScheduleSpace, unrolls,
            rng: random.Random, prefer: Sequence[str] = ()) -> Point:
    """Move one loop's tile factor to a neighbouring divisor on its grid
    (staying Algorithm-1-valid), or flip the unroll factor.  ``prefer``
    biases the mutated-loop choice (transfer-aware mutation: the loops of
    the operand dominating ``CostReport.transfer_cycles``); empty means
    uniform."""
    tiling, u = dict(pt[0]), pt[1]
    if rng.random() < 0.5 and tiling:
        pool = [v for v in prefer if v in tiling] or sorted(tiling)
        var = rng.choice(pool)
        grid = space.divisors.get(var, [tiling[var]])
        i = grid.index(tiling[var]) if tiling[var] in grid else 0
        j = min(max(i + rng.choice((-1, 1)), 0), len(grid) - 1)
        cand = dict(tiling, **{var: grid[j]})
        if space.valid(cand):
            tiling = cand
    else:
        u = rng.choice(unrolls)
    return (_tiling_key(tiling), u)


def _hot_vars(space: ScheduleSpace, pt: Point, evaluate,
              cache: dict) -> list[str]:
    """Transfer-aware mutation bias for ``pt``: when its cost report is
    transfer-dominated, the loop vars of the operand whose staging edges
    dominate ``transfer_cycles``; else no bias."""
    if pt in cache:
        return cache[pt]
    hot: list[str] = []
    rep = getattr(evaluate, "reports", {}).get(pt)
    if rep is not None and rep.transfer_cycles > rep.compute_cycles:
        hot = cost_mod.transfer_hot_vars(space.probe, space.acg, space.plans,
                                         dict(pt[0]),
                                         divisors=space.divisors)
    cache[pt] = hot
    return hot


def _stalled(trace: list, patience: int | None) -> bool:
    """True once the last ``patience`` trace entries brought no
    improvement — the convergence early-stop warm-started searches cash
    in (their seeds start at or near the optimum)."""
    if patience is None or len(trace) <= patience:
        return False
    return trace[-1][1] >= trace[-1 - patience][1]


@register_strategy("evolutionary")
def evolutionary(space, opts: SearchOptions, evaluate, rng_init, rng_mut,
                 seeds: Sequence[Point] = ()):
    pop = list(seeds)[:opts.population]
    pop += [_random_point(space, opts.unroll_choices, rng_init)
            for _ in range(opts.population - len(pop))]
    trace, best = [], float("inf")
    hot_cache: dict = {}
    for gen in range(opts.generations):
        scored = sorted(pop, key=evaluate)
        best = min(best, evaluate(scored[0]))
        trace.append((gen, best))
        if _stalled(trace, opts.patience):
            break
        elites = scored[:opts.elite]
        pop = list(elites)
        while len(pop) < opts.population:
            parent = rng_mut.choice(elites)
            pop.append(_mutate(parent, space, opts.unroll_choices, rng_mut,
                               prefer=_hot_vars(space, parent, evaluate,
                                                hot_cache)))
    return trace


def _neighbours(pt: Point, space: ScheduleSpace, unrolls) -> list[Point]:
    """Deterministic divisor-grid neighbourhood of a point: each loop
    stepped one divisor either way (validity-checked), each alternative
    unroll factor."""
    tiling, u = dict(pt[0]), pt[1]
    out: list[Point] = []
    for var in sorted(tiling):
        grid = space.divisors.get(var, [tiling[var]])
        i = grid.index(tiling[var]) if tiling[var] in grid else 0
        for j in (i - 1, i + 1):
            if 0 <= j < len(grid) and grid[j] != tiling[var]:
                cand = dict(tiling, **{var: grid[j]})
                if space.valid(cand):
                    out.append((_tiling_key(cand), u))
    for u2 in sorted(unrolls, reverse=True):
        if u2 != u:
            out.append((pt[0], u2))
    return out


@register_strategy("beam")
def beam(space, opts: SearchOptions, evaluate, rng_init, rng_mut,
         seeds: Sequence[Point] = ()):
    """Cost-bound-guided beam over tiling prefixes.

    Tiling decisions are committed loop-by-loop in nest order; at each
    level every one-factor extension of a surviving prefix is scored with
    ``cost.prefix_bound`` (admissible: committed loops exact, uncommitted
    at their best-case tile) and only the best-bounded prefixes survive
    (at least ``beam_width``).  Only complete schedules that survive every
    level are materialised through the pipeline — ranked best-bound-first
    under the same ``generations * population`` evaluation budget every
    strategy gets; the budget's tail hill-climbs the incumbent's divisor
    neighbourhood (the same moves evolutionary mutation makes, minus the
    dice).  Fully deterministic: no rng draws."""
    order = space.loop_order()
    budget = opts.budget
    unrolls = tuple(opts.unroll_choices) or (1,)
    explore = max(1, budget - budget // 3)   # ranked-candidate phase
    # final survivors: one per explore slot (phase 1 evaluates each
    # surviving tiling once, at the widest unroll); intermediate levels
    # keep twice as many so a mid-rank prefix whose strength only shows
    # once inner loops commit is not cut prematurely
    keep = max(1, opts.beam_width, explore)

    def rank(prefix: tuple) -> tuple:
        # primary: the admissible packed bound the pruning guarantee
        # rests on; secondary: the serial-sum form, which keeps
        # discriminating (via the reload/row floors) when compute
        # dominates the packed max-form and every valid prefix ties
        packed, serial = cost_mod.prefix_bounds(
            space.probe, space.acg, space.plans, space.committed(prefix),
            divisors=space.divisors, max_coalesce=max(unrolls))
        return (packed, serial, prefix)

    prefixes: list[tuple] = [()]
    for depth in range(1, len(order) + 1):
        ext = space.prefixes(depth, within=prefixes)
        width = keep if depth == len(order) else 2 * keep
        prefixes = sorted(ext, key=rank)[:width]
    # complete candidates best-bound-first: every surviving tiling once at
    # the widest unroll (coalescing only ever helps), then the remaining
    # unroll choices; seeds jump the queue
    u_first, *u_rest = sorted(unrolls, reverse=True)
    cands = list(seeds)
    cands += [(_tiling_key(space.committed(p)), u_first) for p in prefixes]
    cands += [(_tiling_key(space.committed(p)), u)
              for p in prefixes for u in u_rest]
    trace: list = []
    chunk = max(1, opts.population)
    state = {"best": float("inf"), "pt": None, "evals": 0}

    def visit(pt: Point) -> None:
        fresh = pt not in getattr(evaluate, "cache", {})
        cyc = evaluate(pt)
        if cyc < state["best"]:
            state["best"], state["pt"] = cyc, pt
        if fresh:
            state["evals"] += 1
            if state["evals"] % chunk == 0:
                trace.append((state["evals"] // chunk - 1, state["best"]))

    def exhausted(limit: int) -> bool:
        return state["evals"] >= limit or _stalled(trace, opts.patience)

    for pt in cands:
        if exhausted(explore):
            break
        visit(pt)
    improved = True
    while improved and state["pt"] is not None and not exhausted(budget):
        improved = False
        for npt in _neighbours(state["pt"], space, unrolls):
            if exhausted(budget):
                break
            before = state["best"]
            visit(npt)
            if state["best"] < before:
                improved = True
    for pt in cands:                     # leftover budget: keep exploring
        if exhausted(budget):
            break
        visit(pt)
    if not trace or trace[-1][1] != state["best"] or state["evals"] % chunk:
        trace.append((max(0, (state["evals"] + chunk - 1) // chunk - 1),
                      state["best"]))
    return trace


@register_strategy("random")
def random_search(space, opts: SearchOptions, evaluate, rng_init, rng_mut,
                  seeds: Sequence[Point] = ()):
    # seeds replace (not add to) first-generation draws, so the
    # generations*population budget contract holds for warm starts too
    trace, best = [], float("inf")
    pending = list(seeds)[:opts.population]
    for gen in range(opts.generations):
        for _ in range(opts.population - len(pending)):
            pending.append(_random_point(space, opts.unroll_choices,
                                         rng_init))
        for pt in pending:
            best = min(best, evaluate(pt))
        pending = []
        trace.append((gen, best))
        if _stalled(trace, opts.patience):
            break
    return trace


@register_strategy("grid")
def grid_search(space, opts: SearchOptions, evaluate, rng_init, rng_mut,
                seeds: Sequence[Point] = ()):
    """Evenly strided sweep of tilings x unrolls within the same
    generations*population evaluation budget as the other strategies."""
    budget = opts.budget
    points = [(_tiling_key(t), u) for t in space.tilings
              for u in opts.unroll_choices]
    stride = max(1, len(points) // budget)
    chosen = points[::stride][:budget]
    trace, best = [], float("inf")
    chunk = max(1, len(chosen) // max(opts.generations, 1))
    for gen in range(0, len(chosen), chunk):
        for pt in chosen[gen:gen + chunk]:
            best = min(best, evaluate(pt))
        trace.append((gen // chunk, best))
    return trace


@register_strategy("exhaustive")
def exhaustive(space, opts: SearchOptions, evaluate, rng_init, rng_mut,
               seeds: Sequence[Point] = ()):
    """Every enumerated tiling x every unroll choice (the space is already
    capped by SearchOptions.max_candidates)."""
    trace, best = [], float("inf")
    for gi, t in enumerate(space.tilings):
        for u in opts.unroll_choices:
            best = min(best, evaluate((_tiling_key(t), u)))
        if gi % 50 == 0 or gi == len(space.tilings) - 1:
            trace.append((gi, best))
    return trace


# ---------------------------------------------------------------------------
# candidate materialisation — through the pipeline, not a private pass chain
# ---------------------------------------------------------------------------


def materialise(cdlt: Codelet, acg: ACG, pipeline: Pipeline,
                options: CompileOptions, point: dict | None) -> PassContext:
    """Run the full compile pipeline (codegen deferred) with the schedule
    point injected as pass-input data; ``point=None`` is the stock
    heuristic flow.  Covenant validation depends only on (codelet, acg,
    options) — never on the injected point — so candidate
    materialisations skip it: the heuristic baseline already validated
    this pairing once."""
    skip = ("codegen",) if point is None else ("codegen", "covenant")
    ctx = PassContext(cdlt.clone(), acg, options,
                      overrides=dict(point) if point else {})
    pipeline.run(ctx, skip=skip)
    return ctx


def _score(ctx: PassContext) -> "cost_mod.CostReport":
    pack = ctx.state.get("pack", ctx.options.pack)
    return cost_mod.cost(ctx.cdlt, ctx.acg, pack=pack)


def _rng_streams(seed: int) -> tuple[random.Random, random.Random]:
    """Separate seeded streams for candidate generation vs mutation: the
    trace must not depend on how a strategy interleaves the two."""
    return random.Random(seed), random.Random(seed ^ 0x9E3779B9)


def _warm_seeds(space: ScheduleSpace, sopts: SearchOptions,
                store) -> list[Point]:
    """Warm-start seed points for this space from the store's recorded
    best points (same-shaped layers first), capped at half the
    population so cold exploration still happens."""
    from . import store as store_mod

    st = store_mod.resolve(store)
    if st is None:
        return []
    index = store_mod.WarmStartIndex.cached_for(st)
    limit = max(1, sopts.population // 2)
    seeds = []
    for tiling, unroll in index.seeds(space, sopts.unroll_choices,
                                      limit=limit):
        seeds.append((_tiling_key(tiling), unroll))
    return seeds


def _call_strategy(fn: StrategyFn, space, sopts, evaluate, rng_init,
                   rng_mut, seeds: Sequence[Point]):
    """Invoke a strategy, passing ``seeds`` only if it takes them (user-
    registered strategies predating warm-start keep working)."""
    import inspect

    try:
        params = inspect.signature(fn).parameters
        takes_seeds = "seeds" in params or any(
            p.kind is inspect.Parameter.VAR_KEYWORD
            for p in params.values())
    except (TypeError, ValueError):
        takes_seeds = False
    if takes_seeds:
        return fn(space, sopts, evaluate, rng_init, rng_mut, seeds=seeds)
    return fn(space, sopts, evaluate, rng_init, rng_mut)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def search_schedule(cdlt: Codelet, acg: ACG, *,
                    options: CompileOptions | None = None,
                    pipeline: Pipeline | None = None,
                    store=None,
                    **overrides) -> SearchResult:
    """Search the valid schedule space of ``cdlt`` on ``acg``.

    ``options`` is a ``CompileOptions`` whose ``search`` field (or
    ``SearchOptions()``) selects the strategy/budget; keyword overrides
    (``generations=4, seed=1, strategy="grid", ...``) tweak it — the legacy
    call style.  ``store`` (an ``ArtifactStore``/path, defaulting to
    ``options.store``) is only consulted when ``warm_start=True``: the
    initial population is seeded from its best recorded same-shaped
    points.  Never returns a schedule worse than the heuristic.
    """
    opts = options if options is not None else CompileOptions()
    if opts.search is not None and not isinstance(opts.search, SearchOptions):
        raise TypeError(f"CompileOptions.search must be a SearchOptions, "
                        f"got {type(opts.search)!r}")
    sopts = opts.search if opts.search is not None else SearchOptions()
    if overrides:
        sopts = dataclasses.replace(sopts, **overrides)
    if sopts.strategy not in STRATEGIES:
        raise KeyError(f"unknown search strategy {sopts.strategy!r}; "
                       f"registered: {available_strategies()}")
    pl = pipeline if pipeline is not None \
        else Pipeline.default().with_acg_hooks(acg)

    space = schedule_space(cdlt, acg, options=opts, pipeline=pl,
                           max_candidates=sopts.max_candidates)
    assert space.tilings, f"no valid tilings for {cdlt.name} on {acg.name}"

    heur_ctx = materialise(cdlt, acg, pl, opts, None)
    heur_cycles = _score(heur_ctx).cycles

    evaluated: dict[Point, float] = {}
    reports: dict[Point, "cost_mod.CostReport"] = {}
    incumbent: list = [None, float("inf")]  # [point, cycles]

    def evaluate(pt: Point) -> float:
        if pt in evaluated:
            return evaluated[pt]
        try:
            ctx = materialise(cdlt, acg, pl, opts,
                              {"tiling": dict(pt[0]), "unroll_factor": pt[1]})
            rep = _score(ctx)
            cyc = rep.cycles
            reports[pt] = rep
        except Exception:
            cyc = float("inf")
        evaluated[pt] = cyc
        if cyc < incumbent[1]:
            incumbent[0], incumbent[1] = pt, cyc
        return cyc

    evaluate.cache = evaluated    # strategies dedup against the memo
    evaluate.reports = reports    # transfer-aware operators read these

    seeds: list[Point] = []
    if sopts.warm_start:
        seeds = _warm_seeds(space, sopts,
                            store if store is not None else opts.store)

    rng_init, rng_mut = _rng_streams(sopts.seed)
    trace = _call_strategy(STRATEGIES[sopts.strategy], space, sopts,
                           evaluate, rng_init, rng_mut, tuple(seeds))

    best_pt, best_cyc = incumbent
    if best_pt is not None and best_cyc < heur_cycles:
        point = {"tiling": dict(best_pt[0]), "unroll_factor": best_pt[1]}
        ctx = materialise(cdlt, acg, pl, opts, point)
        ctx.cdlt.note(f"search[{sopts.strategy}]: tiling={point['tiling']} "
                      f"unroll={point['unroll_factor']} "
                      f"cycles={best_cyc:.0f} (heuristic {heur_cycles:.0f})")
    else:
        ctx, best_cyc, point = heur_ctx, heur_cycles, None
    return SearchResult(best=ctx.cdlt, best_cycles=best_cyc,
                        heuristic_cycles=heur_cycles,
                        evaluated=len(evaluated), trace=trace,
                        strategy=sopts.strategy, point=point,
                        seeded=len(seeds), space_sig=space.signature(),
                        best_ctx=ctx)


__all__ = ["STRATEGIES", "SearchOptions", "SearchResult",
           "available_strategies", "materialise", "register_strategy",
           "search_schedule"]
