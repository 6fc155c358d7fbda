"""moe_dispatch_ms.train: the device time of the MoE layers' routing,
dispatch and combine a train step, in ms: the device self time (less
the spans inside, such as a layer's recompute) of the program's spans
``moe.route``, ``moe.dispatch`` and ``moe.combine`` (forward and
recompute) and of their backward spans (``.bwd``), over the count of
``train.step`` spans.  None where the program records none of them or
timed none on a card."""
from bench.program_records import records

STAGES = ("moe.route", "moe.dispatch", "moe.combine")


def read(obs: dict) -> float | None:
    spans = (records() or {}).get("spans", {})
    steps = spans.get("train.step", {}).get("calls", 0)
    times = [spans[n]["device_self_s"] for s in STAGES
             for n in (s, s + ".bwd") if n in spans]
    if not steps or not times or None in times:
        return None
    return 1e3 * sum(times) / steps
