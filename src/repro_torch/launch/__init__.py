"""Launch layer: the serving and training drivers (``launch.serve`` and
``launch.train``, run as modules) and the block-GEMM inventory
(``launch.layers``)."""
from . import layers

__all__ = ["layers"]
