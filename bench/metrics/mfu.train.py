"""mfu.train: the window's model FLOPs (the frozen ``model_flops`` of a
train step, times the steps) over the window's seconds, as a share of
the H100's bf16 peak, in %."""
from bench import yardstick


def read(obs: dict) -> float | None:
    wl = obs["workload"]
    flops = obs["steps"] * yardstick.model_flops(
        obs["config"], wl["batch"], wl["seq_len"], "train")
    return 100.0 * flops / obs["window_s"] / yardstick.PEAK_BF16_FLOPS
