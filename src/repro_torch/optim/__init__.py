"""Optimizers: AdamW, schedules, clipping and int8 gradient compression,
the counterparts of ``repro.optim``."""
from .adamw import (Optimizer, adamw, clip_by_global_norm, cosine_schedule,
                    global_norm, linear_schedule)
from .compression import int8_compressed

__all__ = ["Optimizer", "adamw", "clip_by_global_norm", "cosine_schedule",
           "global_norm", "int8_compressed", "linear_schedule"]
