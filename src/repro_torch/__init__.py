"""PyTorch + CUDA port of the Covenant reproduction, for an NVIDIA H100.

The JAX package ``repro`` is the reference and stays as it is; this package
imports nothing of it.  Its main path: the Covenant Algorithm-1 tiler, run
against the ``h100`` covenant (``targets``), picks the block geometry of
hand-written Hopper kernels (``kernels``), and the dense transformer
(``models``) serves through them (``launch.serve``) and trains through them
(``launch.train``: ``data``, ``optim``, ``runtime``, ``checkpoint``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
CPU tensors every kernel wrapper runs its plain PyTorch version.

The top level is the Covenant compile driver (``core``, numpy host code),
as ``repro``'s is:

    import repro_torch
    from repro_torch.core import library

    art = repro_torch.compile(library.gemm(16, 32, 24), target="h100")
    art.cycles()           # analytic cycles on one SM's covenant
    art.listing()          # macro-mnemonic program listing

Targets are names (``repro_torch.targets``: ``example``, ``dnnweaver``,
``hvx``, ``tpu_v5e``, ``h100``, ``register``-ed ones and derived variants
like ``"dnnweaver@pe=32x32"``); ``REPRO_TORCH_CACHE_DIR`` names a disk
artifact store, over which ``repro_torch.sweep`` shards (layers x target
variants) compile sweeps across worker processes.
"""
from repro_torch.core.covenant import (CovenantError, check_covenant,
                                       validate_acg)
from repro_torch.core.driver import (ArtifactStore, CompiledArtifact,
                                     SearchOptions, SearchResult,
                                     available_targets, cache_stats,
                                     clear_cache, compile, compile_key,
                                     compile_many, register_target)
from repro_torch.core.pipeline import CompileOptions, Pipeline
from repro_torch.core.spec import (ACGSpec, SpecError, acg_spec,
                                   validate_spec)
from repro_torch.core.store import WarmStartIndex
from repro_torch.core.sweep import SweepReport, sweep


def __getattr__(name: str):
    # ``repro_torch.targets`` (the string-addressable registry facade) is
    # served lazily so ``python -m repro_torch.targets`` does not
    # double-import it.  (``repro_torch.sweep`` needs no such hook: the
    # function imported above is the attribute, and the ``sweep.py``
    # facade module that ``python -m repro_torch.sweep`` or an explicit
    # submodule import rebinds it to is itself callable.)
    if name == "targets":
        import repro_torch.targets as targets
        return targets
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ACGSpec", "ArtifactStore", "CompileOptions", "CompiledArtifact",
    "CovenantError", "Pipeline", "SearchOptions", "SearchResult",
    "SpecError", "SweepReport", "WarmStartIndex", "acg_spec",
    "available_targets", "cache_stats", "check_covenant", "clear_cache",
    "compile", "compile_key", "compile_many", "register_target", "sweep",
    "targets", "validate_acg", "validate_spec",
]
