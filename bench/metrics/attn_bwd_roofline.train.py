"""attn_bwd_roofline.train: the flash backward's bound (the larger of its
FLOPs at the bf16 peak and its bytes at the HBM rate, from the cell's
shapes) times its launches, over the device time of its kernels in the
traced window, in %.  None where the trace holds none of them."""
from bench import yardstick

# the backward's two kernels in csrc/flash_attention_bwd.cu (tensor-core
# and SIMT builds); the first pattern counts one launch a call
PATTERNS = ("fa_bwd_dq", "fa_bwd_dkv")


def read(obs: dict) -> float | None:
    trace = obs.get("trace")
    if trace is None:
        return None
    secs, _, calls = trace.matching(PATTERNS)
    if not calls or secs <= 0:
        return None
    cfg, wl = obs["config"], obs["workload"]
    hd = cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]
    bound = yardstick.bound_seconds(*yardstick.flash_backward(
        wl["batch"], cfg["n_heads"], cfg["n_kv_heads"], wl["seq_len"], hd,
        2))
    return 100.0 * calls * bound / secs
