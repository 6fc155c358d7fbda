"""The plain reference of the ``moe`` family: ``transformer`` with a
routed mixture of SwiGLU experts in every layer."""
from .transformer import layout, logits_at, loss

__all__ = ["layout", "logits_at", "loss"]
