"""Training runtime: the train step with microbatch accumulation
(``trainstep``) and the fault-tolerant loop (``fault_tolerance``).  The
reference's sharding rules and collectives wait for the distribution
slice."""
from . import fault_tolerance, trainstep
from .fault_tolerance import LoopReport, StragglerMonitor, train_loop
from .trainstep import make_loss_with_accum, make_train_step

__all__ = ["LoopReport", "StragglerMonitor", "fault_tolerance",
           "make_loss_with_accum", "make_train_step", "train_loop",
           "trainstep"]
