"""Training data: the synthetic LM stream (``pipeline.SyntheticLM``)."""
from .pipeline import SyntheticLM

__all__ = ["SyntheticLM"]
