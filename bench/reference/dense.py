"""The plain reference of the ``dense`` family: ``transformer`` with a
SwiGLU MLP in every layer."""
from .transformer import layout, logits_at, loss

__all__ = ["layout", "logits_at", "loss"]
