"""optim_fused_pct.train: the share of the param elements the optimizer
updated that its fused kernel took, in %: the program's counters
``optim.fused_elems`` over ``optim.elems``, counted each ``update`` over
the traced steps.  None where the program counts no updated elements."""
from bench.program_records import records


def read(obs: dict) -> float | None:
    counts = (records() or {}).get("counters", {})
    if not counts.get("optim.elems"):
        return None
    return 100.0 * counts.get("optim.fused_elems", 0) / counts["optim.elems"]
