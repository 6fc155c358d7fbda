"""Launch layer: the serving driver (``launch.serve``, run as a module) and
the block-GEMM inventory (``launch.layers``)."""
from . import layers

__all__ = ["layers"]
