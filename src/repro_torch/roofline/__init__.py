"""Roofline: per-rank FLOPs, HBM bytes and collective bytes of a step
(``collect``), the H100's three-term roofline over them and the analytic
parameter and model FLOP counts (``model``).  The counterpart of
``repro/roofline/``."""
from .collect import collect_step, collective_bytes
from .model import (HBM_BW, ICI_BW, PEAK_FLOPS, Roofline, model_flops,
                    param_count, roofline_terms)

__all__ = ["HBM_BW", "ICI_BW", "PEAK_FLOPS", "Roofline", "collect_step",
           "collective_bytes", "model_flops", "param_count",
           "roofline_terms"]
