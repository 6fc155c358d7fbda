"""``repro_torch.compile`` — the one-call Covenant compile driver.

Everything the examples, benchmarks and tests used to hand-stitch
(``library.* -> scheduler.schedule -> codegen.generate -> stream.run_stream
-> cost.cost``, each with its own loose knobs) behind a single entry point:

    art = repro_torch.compile(library.gemm(16, 32, 24), target="hvx")
    art.run({"A": A, "B": B})     # execute the mnemonic stream
    art.cycles()                  # analytic cycle count
    art.listing(5)                # mnemonic listing
    art.verify({"A": A, "B": B})  # stream outputs == numpy oracle

Design points:

* **Target registry** — ``target`` is a registry name
  (``repro_torch.targets``: bundled covenant specs plus ``register``-ed
  ones, including derived variants like ``"dnnweaver@pe=32x32"``), an
  ``ACGSpec``, or an ACG instance; per-ACG pass hooks
  (``acg.pass_overrides`` / ``acg.extra_passes``) are applied to the stock
  pipeline automatically, so bringing your own codegen is
  attribute-plus-hook work, never a compiler fork.
* **Content-addressed cache** — artifacts are keyed by (codelet fingerprint,
  ACG fingerprint, options fingerprint, pipeline fingerprint); a repeated
  ``compile`` of the same inputs returns the *same artifact object* without
  re-running any pass.  ``compile_many`` batches sweeps over the cache.
* **Lazy analytics** — scheduling runs eagerly (it is what a compile *is*),
  but mnemonic expansion (``codegen``) is deferred until ``.program`` /
  ``.run()`` / ``.listing()`` is first touched: Table-2-scale layers exceed
  the full-unroll stream budget and are served by the analytic model alone.

The port's copy of ``repro.core.driver``, with the same logic.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterable, Sequence

import numpy as np

from . import cost as cost_mod
from . import library as library_mod
from . import spec as spec_mod
from . import store as store_mod
from . import stream as stream_mod
from . import targets as targets_mod
from .acg import ACG
from .codelet import Codelet
from .pipeline import CompileOptions, PassContext, Pipeline
from .search import SearchOptions, SearchResult, search_schedule
from .store import ArtifactStore

# ---------------------------------------------------------------------------
# fingerprints (content addressing)
# ---------------------------------------------------------------------------


def _sha(*parts: str) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode())
        h.update(b"\x00")
    return h.hexdigest()


def codelet_fingerprint(cdlt: Codelet) -> str:
    """Content hash of a codelet: name, body (loops/refs), surrogate
    shapes+dtypes, and param values (which the pretty-printer omits)."""
    params = ",".join(f"{s.name}={s.value}" for s in cdlt.surrogates.values()
                      if s.kind == "param")
    return _sha(cdlt.name, str(cdlt), params)


def acg_fingerprint(acg: ACG) -> str:
    """Content hash of a target: the canonical covenant-spec fingerprint
    (``acg.to_spec().fingerprint()``).  Unlike the old describe()-based
    hash this covers mnemonic *field layouts* too, so two in-memory ACGs
    sharing a name can never alias in the cache or the artifact store, and
    a mutated ACG re-fingerprints to a fresh key instead of collecting a
    stale warm hit."""
    return acg.to_spec().fingerprint()


def compile_key(codelet_or_layer, target, options: CompileOptions | None
                = None, pipeline: Pipeline | None = None) -> str:
    """The content-addressed key ``compile(...)`` would file this compile
    under, *without compiling* — the work-unit identity of the sweep
    coordinator (``core/sweep.py``): coordinators dedup against the
    store and partition work by this key before any worker runs."""
    cdlt = _resolve_codelet(codelet_or_layer)
    acg, acg_fp = _resolve_target(target)
    opts = options if options is not None else CompileOptions()
    pl = pipeline if pipeline is not None \
        else Pipeline.default().with_acg_hooks(acg)
    return _sha(codelet_fingerprint(cdlt), acg_fp,
                opts.fingerprint(), pl.fingerprint())


# ---------------------------------------------------------------------------
# compiled artifact
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class CompiledArtifact:
    """A finished compile: scheduled codelet + lazy program and analytics.

    An artifact restored from a disk ``ArtifactStore`` starts with *no*
    pipeline stage executed: its cost reports and schedule decisions come
    from the stored entry, and the scheduled codelet is rebuilt lazily
    (``_ensure_scheduled``) by replaying the pipeline with the stored
    tiling/unroll injected — only when ``.program`` / ``.run()`` or an
    unstored analytic is actually touched.
    """

    codelet: Codelet            # the scheduled (transformed) codelet
    acg: ACG
    options: CompileOptions
    target: str                 # target name (acg.name for ACG instances)
    key: str                    # content-addressed cache key
    pipeline: Pipeline
    ctx: PassContext            # pass state (plans, tiling, pack, program)
    search: SearchResult | None = None   # attached when compiled via search

    # -- lazy schedule replay (store restores) -------------------------------
    def _ensure_scheduled(self) -> None:
        """Replay the scheduling stages if none ran yet (artifact was
        restored from the disk store; ``ctx.overrides`` carries the stored
        schedule decisions, so no tiling search/enumeration re-runs)."""
        if not self.ctx.executed:
            self.pipeline.run(self.ctx, skip=("codegen",))

    # -- program (lazy mnemonic expansion) -----------------------------------
    @property
    def program(self):
        """The macro-mnemonic stream; generated on first access.  Raises
        ``codegen.StreamTooLarge`` for layers past ``options.max_mnemonics``
        (use the analytic ``.cycles()`` / ``.report()`` for those)."""
        if "program" not in self.ctx.state:
            self._ensure_scheduled()
            self.pipeline.run_stage("codegen", self.ctx)
        return self.ctx.state["program"]

    @property
    def mnemonics(self) -> list:
        return self.program.mnemonics

    def listing(self, limit: int = 50) -> str:
        return self.program.listing(limit)

    # -- execution -----------------------------------------------------------
    def _default_pack(self) -> bool:
        # the pipeline's "pack" stage records the decision (a target override
        # may have changed it); fall back to the raw option if it never ran
        return self.ctx.state.get("pack", self.options.pack)

    def run(self, inputs: dict, pack: bool | None = None):
        """Execute the mnemonic stream on the stream machine; returns a
        ``stream.StreamResult`` (outputs + serial/packed cycle counts)."""
        if pack is None:
            pack = self._default_pack()
        return stream_mod.run_stream(self.program, inputs, pack=pack)

    def verify(self, oracle_inputs: dict, atol: float = 1e-5) -> bool:
        """Stream-machine outputs equal the codelet's numpy oracle?"""
        assert self.codelet.oracle is not None, \
            f"codelet {self.codelet.name} carries no oracle"
        want = self.codelet.oracle(oracle_inputs)
        got = self.run(oracle_inputs).outputs
        for k, w in want.items():
            g = got[k]
            if np.issubdtype(np.asarray(w).dtype, np.floating):
                if not np.allclose(g, w, atol=atol):
                    return False
            elif not np.array_equal(g, w):
                return False
        return True

    # -- analytics (no stream needed) ----------------------------------------
    def report(self, pack: bool | None = None) -> "cost_mod.CostReport":
        if pack is None:
            pack = self._default_pack()
        cached = self.ctx.state.get(("report", pack))
        if cached is None:
            self._ensure_scheduled()
            cached = cost_mod.cost(self.codelet, self.acg, pack=pack)
            self.ctx.state[("report", pack)] = cached
        return cached

    def cycles(self, pack: bool | None = None) -> float:
        return self.report(pack=pack).cycles

    @property
    def schedule_notes(self) -> list[str]:
        # store-restored artifacts report the original compile's notes,
        # stable across the lazy replay (the replayed codelet's own notes
        # stay reachable via ``art.codelet.schedule_notes``)
        stored = self.ctx.state.get("schedule_notes")
        if stored is not None:
            return list(stored)
        return self.codelet.schedule_notes

    def __repr__(self) -> str:
        return (f"CompiledArtifact({self.codelet.name} @ {self.target}, "
                f"stages={self.ctx.executed}, key={self.key[:12]})")


# ---------------------------------------------------------------------------
# target registry
# ---------------------------------------------------------------------------


def register_target(name: str, factory, *, pass_overrides: dict | None = None,
                    extra_passes: Sequence[tuple] | None = None) -> None:
    """Register an ACG factory under ``name`` (usable as ``compile(...,
    target=name)``).  Optional hooks are attached to every instance the
    factory produces — the BYOC extension point."""
    if pass_overrides or extra_passes:
        base = factory

        def factory():
            acg = base()
            acg.pass_overrides.update(pass_overrides or {})
            for entry in extra_passes or ():
                # idempotent even when the user's factory returns a shared
                # ACG instance: never splice the same pass twice
                if entry not in acg.extra_passes:
                    acg.extra_passes.append(entry)
            return acg

    targets_mod.TARGETS[name] = factory
    _TARGETS_RESOLVED.pop(name, None)


def available_targets() -> list[str]:
    return targets_mod.list_targets()


# name -> (factory, acg, pristine_fingerprint): building a full ACG (graph
# + mnemonic vocabulary) costs ~0.5ms — pointless on every cache hit of a
# sweep, so resolved names (incl. derived variants) memoise the built
# graph.  The factory identity is stored so that direct mutation of
# targets.TARGETS (the registry's public idiom) invalidates the entry; the
# fingerprint taken at build time is stored so that mutation of the shared
# instance is *detected* on the next resolve — a registered name always
# compiles the architecture it was registered as, never a drifted copy —
# by re-fingerprinting the live instance every time.
_TARGETS_RESOLVED: dict[str, tuple[object, ACG, str]] = {}
# spec fingerprint -> built ACG.  The spec is frozen so the *build* is
# memoisable (keyed by fingerprint, not the object: attrs may hold
# unhashable values), but the built graph is a live, mutable object — its
# fingerprint is recomputed per resolve, exactly like the name path, so a
# caller mutating the shared instance never rides a stale key.
_SPECS_RESOLVED: dict[str, ACG] = {}


def _resolve_target(target) -> tuple[ACG, str]:
    """-> (acg, acg_fingerprint).  ``target`` may be a registry name
    (including a ``base@key=value`` derived-variant name), an ``ACGSpec``,
    or an ACG instance."""
    if isinstance(target, ACG):
        return target, acg_fingerprint(target)
    if isinstance(target, spec_mod.ACGSpec):
        fp = target.fingerprint()
        acg = _SPECS_RESOLVED.get(fp)
        if acg is None or acg_fingerprint(acg) != fp:
            # miss, or the shared instance was mutated away from its spec:
            # rebuild so a pristine spec always compiles a faithful graph
            acg = _SPECS_RESOLVED[fp] = ACG.from_spec(target)
        return acg, fp
    if isinstance(target, str):
        # memo-invalidation identity shares targets.resolve_factory's
        # one rule (exact registered name wins over the base)
        factory = targets_mod.resolve_factory(target)
        cached = _TARGETS_RESOLVED.get(target)
        if cached is None or cached[0] is not factory \
                or acg_fingerprint(cached[1]) != cached[2]:
            acg = targets_mod.get_target(target)  # KeyError for unknown
            cached = (factory, acg, acg_fingerprint(acg))
            _TARGETS_RESOLVED[target] = cached
        return cached[1], cached[2]
    raise TypeError(
        f"target must be a name, an ACGSpec or an ACG, got {type(target)!r}")


def _resolve_codelet(obj) -> Codelet:
    if isinstance(obj, Codelet):
        return obj
    if isinstance(obj, library_mod.LayerSpec):
        return obj.build()
    if isinstance(obj, str):
        return library_mod.paper_layer(obj)
    build = getattr(obj, "build", None)
    if callable(build):  # LayerSpec-shaped records (e.g. launch LayerGemm)
        built = build()
        if isinstance(built, Codelet):
            return built
    if callable(obj):  # layer builder thunk
        built = obj()
        if isinstance(built, Codelet):
            return built
    raise TypeError(
        f"expected a Codelet, LayerSpec, paper-layer key or builder; "
        f"got {type(obj)!r}")


# ---------------------------------------------------------------------------
# the compile cache
# ---------------------------------------------------------------------------

# Two tiers share the content-addressed keys: the in-process dict below
# (unbounded — the working set is the sweep itself) and, when configured,
# a disk-backed size-bounded ``ArtifactStore`` (``CompileOptions(store=...)``
# or the REPRO_TORCH_CACHE_DIR environment variable) that lets a *fresh
# process* replay sweeps and tuned schedules without re-running scheduling or search.
_CACHE: dict[str, CompiledArtifact] = {}
_STATS = {"hits": 0, "misses": 0, "store_hits": 0, "store_misses": 0}


def clear_cache(disk: bool = False, store=None) -> None:
    """Empty the in-process cache; ``disk=True`` also empties the disk
    store (``store`` argument, else the REPRO_TORCH_CACHE_DIR default)."""
    _CACHE.clear()
    # target-resolution memos grow one built ACG per distinct variant name
    # / spec; a cache clear is the documented reset point between sweeps
    _TARGETS_RESOLVED.clear()
    _SPECS_RESOLVED.clear()
    for k in _STATS:
        _STATS[k] = 0
    if disk:
        st = store_mod.resolve(store)
        if st is not None:
            st.clear()


def cache_stats() -> dict:
    return dict(_STATS, size=len(_CACHE))


def _restore_from_store(entry: dict, cdlt: Codelet, acg: ACG,
                        opts: CompileOptions, pl: Pipeline,
                        key: str) -> CompiledArtifact:
    """Rebuild an artifact from a stored entry with ZERO pass executions:
    analytics come from the stored reports, the schedule decisions become
    ``ctx.overrides`` so any later ``.program`` touch replays them."""
    ctx = PassContext(cdlt.clone(), acg, opts)
    if entry.get("tiling") is not None:
        ctx.overrides["tiling"] = {str(k): int(v)
                                   for k, v in entry["tiling"].items()}
    ctx.overrides["unroll_factor"] = int(
        entry.get("unroll_factor", opts.unroll_factor))
    ctx.state["pack"] = bool(entry["pack"])
    ctx.state["schedule_notes"] = [str(n) for n in entry.get("notes", ())]
    for pack, rep in store_mod.reports_from_entry(entry).items():
        ctx.state[("report", pack)] = rep
    art = CompiledArtifact(codelet=ctx.cdlt, acg=acg, options=opts,
                           target=acg.name, key=key, pipeline=pl, ctx=ctx)
    s = entry.get("search")
    if s:
        art.search = SearchResult(
            best=ctx.cdlt, best_cycles=float(s["best_cycles"]),
            heuristic_cycles=float(s["heuristic_cycles"]),
            evaluated=int(s["evaluated"]),
            trace=[tuple(t) for t in s.get("trace", [])],
            strategy=s.get("strategy", "evolutionary"), point=s.get("point"),
            seeded=int(s.get("seeded", 0)), space_sig=s.get("space_sig"))
    return art


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def compile(codelet_or_layer, target="hvx",
            options: CompileOptions | None = None, *,
            pipeline: Pipeline | None = None,
            cache: bool = True) -> CompiledArtifact:
    """Compile a codelet (or paper-layer key / LayerSpec / builder) for a
    target, returning a cached ``CompiledArtifact``.

    ``target`` is a registry name — including a derived-variant name such
    as ``"dnnweaver@pe=32x32"`` (see ``repro_torch.targets``) — an
    ``ACGSpec``, or an ACG instance.

    ``pipeline`` overrides the stock pass pipeline entirely; otherwise the
    default pipeline plus the target's ACG hooks is used.

    ``options.search`` routes the compile through schedule search (the
    winner — never worse than the heuristic — is the artifact, with the
    ``SearchResult`` trace attached as ``art.search``).  ``options.store``
    or ``REPRO_TORCH_CACHE_DIR`` adds a disk tier: warm hits restore without
    executing any pipeline stage; ``cache=False`` bypasses both tiers.
    """
    cdlt = _resolve_codelet(codelet_or_layer)
    acg, acg_fp = _resolve_target(target)
    opts = options if options is not None else CompileOptions()
    pl = pipeline if pipeline is not None \
        else Pipeline.default().with_acg_hooks(acg)
    key = _sha(codelet_fingerprint(cdlt), acg_fp,
               opts.fingerprint(), pl.fingerprint())
    store = store_mod.resolve(opts.store) if cache else None
    if cache and key in _CACHE:
        _STATS["hits"] += 1
        art = _CACHE[key]
        if store is not None and key not in store:
            # the key was compiled before this store was configured —
            # backfill so a fresh process still replays it warm
            try:
                store.put(key, store_mod.entry_from_artifact(art))
            except Exception:
                pass  # persistence is opportunistic, never fatal
        return art
    _STATS["misses"] += 1
    if store is not None:
        entry = store.load(key)
        if entry is not None:
            try:
                art = _restore_from_store(entry, cdlt, acg, opts, pl, key)
            except Exception:
                # entry parsed but is unusable (schema drift): drop it and
                # recompile cleanly below
                store.invalidate(key)
                art = None
            if art is not None:
                _STATS["store_hits"] += 1
                _CACHE[key] = art
                return art
        _STATS["store_misses"] += 1
    if opts.search is not None:
        # the resolved store doubles as the warm-start measurement
        # database (SearchOptions(warm_start=True))
        res = search_schedule(cdlt, acg, options=opts, pipeline=pl,
                              store=store)
        ctx = res.best_ctx
        art = CompiledArtifact(codelet=ctx.cdlt, acg=acg, options=opts,
                               target=acg.name, key=key, pipeline=pl,
                               ctx=ctx, search=res)
    else:
        ctx = PassContext(cdlt.clone(), acg, opts)
        pl.run(ctx, skip=("codegen",))  # codegen deferred to .program
        art = CompiledArtifact(codelet=ctx.cdlt, acg=acg, options=opts,
                               target=acg.name, key=key, pipeline=pl,
                               ctx=ctx)
    if cache:
        _CACHE[key] = art
    if store is not None:
        try:
            store.put(key, store_mod.entry_from_artifact(art))
        except Exception:
            pass  # a full/read-only/unserialisable store entry must never
            #       fail an otherwise-successful compile
    return art


def _parallel_prefill(items: list, target, options: CompileOptions | None,
                      workers: int) -> None:
    """Back half of ``compile_many(parallel=N)``: compile the batch's
    still-cold, process-portable units in N worker processes *through the
    shared artifact store*, so the in-order sequential pass that follows
    restores every one of them warm (zero pipeline stages) and returns
    real ``CompiledArtifact`` objects from this process's cache tiers."""
    from . import sweep as sweep_mod

    store = store_mod.resolve(options.store if options is not None else None)
    if store is None:
        import warnings
        warnings.warn(
            "compile_many(parallel=...) needs a shared disk store "
            "(CompileOptions(store=...) or REPRO_TORCH_CACHE_DIR) to hand "
            "results back; compiling sequentially instead")
        return
    opts = options if options is not None else CompileOptions()
    base = dataclasses.replace(opts, store=None)
    units: dict[str, "sweep_mod.WorkUnit"] = {}
    for item in items:
        if isinstance(item, tuple) and len(item) == 2:
            it, tgt = item
        else:
            it, tgt = item, target
        if not isinstance(tgt, str):
            continue  # live ACG/spec targets stay in-process
        try:
            workload = sweep_mod.workload_of(it)
        except TypeError:
            continue
        if workload[0] == "local":
            continue  # raw codelets cannot cross a process boundary
        key = compile_key(sweep_mod.build_workload(workload), tgt, base)
        if key in _CACHE or key in store:
            continue
        units.setdefault(key, sweep_mod.WorkUnit(
            layer=sweep_mod._workload_label(workload), target=tgt,
            workload=workload, options=base, key=key))
    if not units:
        return
    todo = sorted(units.values(), key=lambda u: u.key)
    sweep_mod._process_backend(sweep_mod.partition(todo, workers), store,
                               sweep_mod.plan_id(todo))


def compile_many(items: Iterable, target="hvx",
                 options: CompileOptions | None = None, *,
                 parallel: int | None = None,
                 **kwargs) -> list[CompiledArtifact]:
    """Batch compile: one artifact per item, in order, sharing the cache.

    ``items`` may mix Codelets, LayerSpecs, paper-layer keys and builders.
    An item may also be a ``(codelet, target)`` pair, overriding the
    sweep-wide ``target`` for that item — one batched sweep can span
    several architecture variants::

        repro_torch.compile_many([
            ("DLRM-FC1", "dnnweaver"),
            ("DLRM-FC1", "dnnweaver@pe=32x32"),
            "DLRM-FC2",                          # uses ``target``
        ], target="hvx")

    ``parallel=N`` (with a disk store configured) fans the cold units of
    the batch out across N worker processes first — the ``core/sweep.py``
    process backend over the shared ``ArtifactStore`` — then the ordered
    results below are pure warm restores.  Items the coordinator cannot
    ship to a worker (raw Codelets, live ACG targets, custom pipelines)
    simply compile sequentially here, same semantics, one process."""
    items = list(items)
    if parallel is not None and int(parallel) > 1 \
            and kwargs.get("cache", True) \
            and kwargs.get("pipeline") is None:
        _parallel_prefill(items, target, options, int(parallel))
    arts = []
    for item in items:
        if isinstance(item, tuple) and len(item) == 2:
            it, tgt = item
        else:
            it, tgt = item, target
        arts.append(compile(it, tgt, options, **kwargs))
    return arts


__all__ = ["ArtifactStore", "CompileOptions", "CompiledArtifact",
           "SearchOptions", "SearchResult", "acg_fingerprint",
           "available_targets", "cache_stats", "clear_cache",
           "codelet_fingerprint", "compile", "compile_key", "compile_many",
           "register_target"]
