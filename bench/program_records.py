"""The program's own span and counter records of a traced window
(``repro_torch.tracing``, on while the window's profiler records), for
the per-layer metrics that read them.  A program without that module, or
whose records hold nothing, gives None: these readers also run against
a program from before that module, beside the benchmark's files."""
from __future__ import annotations


def records() -> dict | None:
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.records()


def mean_host_ms(name: str) -> float | None:
    """The mean host time of span ``name`` over its occurrences, in ms."""
    span = (records() or {}).get("spans", {}).get(name)
    if not span or not span["calls"]:
        return None
    return 1e3 * span["host_s"] / span["calls"]
