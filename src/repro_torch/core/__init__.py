"""Covenant compiler core — the paper's contribution, as numpy host code.

Pipeline: ``library`` Codelets -> named pass pipeline (``pipeline``:
placement, compute mapping, Algorithm-1 tiling, transfer insertion,
vectorize / unroll / pack, macro-mnemonic ``codegen``) -> ``stream``
execution, with ``interp`` (functional) and ``cost`` (analytic cycles) as
cross-checks.  ``targets`` holds the predefined ACGs, the port's ``h100``
among them; ``driver`` is the user-facing ``repro_torch.compile()`` entry
point with the content-addressed compile cache, schedule ``search`` and
the disk-backed ``store``.  The Hopper kernel tiler (``kernels/tiling.py``)
runs on ``scheduler``'s Algorithm 1.

``repro_torch`` imports nothing of ``repro``, so these modules are copies
of ``repro.core``'s with the same logic (``dtypes`` gives a torch view
where the reference gives a jax one).  The reference's sweep coordinator
(``core/sweep.py``) has no copy here yet.  ``tests/test_torch_tiler.py``
and ``tests/test_torch_compiler.py`` hold them against the originals.
"""
from . import (acg, codegen, codelet, cost, covenant, driver, dtypes, interp,
               library, passes, pipeline, scheduler, search, semantics, spec,
               store, stream, targets)
from .acg import ACG, Capability, ComputeNode, Edge, MemoryNode, cap, ospec
from .codelet import Codelet, Compute, Loop, Ref, Surrogate, Transfer, ref, v
from .covenant import (CovenantError, CovenantViolation, check_covenant,
                       validate_acg)
from .driver import (CompiledArtifact, available_targets, cache_stats,
                     clear_cache, compile, compile_many, register_target)
from .dtypes import Dtype, dt
from .pipeline import CompileOptions, PassContext, Pipeline, PipelineError
from .scheduler import ScheduleConfig, schedule
from .search import SearchOptions, SearchResult
from .spec import ACGSpec, SpecError, acg_spec, validate_spec
from .store import ArtifactStore
from .targets import get_spec, get_target, list_targets, register_spec

__all__ = [
    "ACG", "ACGSpec", "ArtifactStore", "Capability", "Codelet",
    "CompileOptions", "CompiledArtifact", "Compute", "ComputeNode",
    "CovenantError", "CovenantViolation", "Dtype", "Edge", "Loop",
    "MemoryNode", "PassContext", "Pipeline", "PipelineError", "Ref",
    "ScheduleConfig", "SearchOptions", "SearchResult", "SpecError",
    "Surrogate", "Transfer", "acg", "acg_spec", "available_targets",
    "cache_stats", "cap", "check_covenant", "clear_cache", "codegen",
    "codelet", "compile", "compile_many", "cost", "covenant", "driver",
    "dt", "dtypes", "get_spec", "get_target", "interp", "library",
    "list_targets", "ospec", "passes", "pipeline", "ref", "register_spec",
    "register_target", "schedule", "scheduler", "search", "semantics",
    "spec", "store", "stream", "targets", "v", "validate_acg",
    "validate_spec",
]
