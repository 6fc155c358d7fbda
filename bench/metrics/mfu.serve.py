"""mfu.serve: the window's model FLOPs (the frozen ``model_flops`` of
each batch's prefill and of each decode step against its cache length)
over the window's seconds, as a share of the H100's bf16 peak, in %."""
from bench import yardstick


def read(obs: dict) -> float | None:
    cfg, wl = obs["config"], obs["workload"]
    b, p = wl["batch"], wl["prompt_len"]
    per_batch = yardstick.model_flops(cfg, b, p, "prefill") + sum(
        yardstick.model_flops(cfg, b, p + j, "decode")
        for j in range(1, wl["max_new"] + 1))
    flops = obs["batches"] * per_batch
    return 100.0 * flops / obs["window_s"] / yardstick.PEAK_BF16_FLOPS
