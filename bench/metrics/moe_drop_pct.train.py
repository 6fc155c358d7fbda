"""moe_drop_pct.train: the share of the MoE layers' routed assignments
that overflowed their expert's capacity and were dropped, in %: the
program's counters ``moe.dropped`` over ``moe.assignments``, each
counted once a forward over the traced steps.  None where the program
counts no assignments."""
from bench.program_records import records


def read(obs: dict) -> float | None:
    counts = (records() or {}).get("counters", {})
    if not counts.get("moe.assignments"):
        return None
    return 100.0 * counts.get("moe.dropped", 0) / counts["moe.assignments"]
