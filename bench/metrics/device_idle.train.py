"""The device's idle share of the traced window, in %: 1 - the union of
its kernels' intervals over the window's length, from the profiler's
timeline.  None without a trace."""


def read(obs: dict) -> float | None:
    trace = obs.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
