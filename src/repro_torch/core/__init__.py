"""Trimmed copies of the numpy Covenant core that the kernel tiler needs.

``repro_torch`` imports nothing of ``repro``, so the pieces of
``repro.core`` that ``kernels/tiling.py`` runs live here as copies with the
same logic: dtypes, the ACG, codelets, declarative specs, the GEMM codelet
and the Algorithm-1 tiler.  ``tests/test_torch_tiler.py`` holds them
against the originals.
"""
from . import acg, codelet, dtypes, library, scheduler, spec

__all__ = ["acg", "codelet", "dtypes", "library", "scheduler", "spec"]
