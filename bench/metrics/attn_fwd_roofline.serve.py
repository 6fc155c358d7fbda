"""attn_fwd_roofline.serve: the prefill flash forward's bound (the larger
of its FLOPs at the bf16 peak and its bytes at the HBM rate, from the
cell's shapes) times its launches, over the device time of its kernels in
the traced batch, in %.  None where the trace holds none of them."""
from bench import yardstick

# the forward's kernels in csrc/flash_attention.cu (tensor-core and SIMT
# builds); each launch is one call
PATTERNS = ("fa_mma_kernel", "fa_fwd_kernel")


def read(obs: dict) -> float | None:
    trace = obs.get("trace")
    if trace is None:
        return None
    secs, calls, _ = trace.matching(PATTERNS)
    if not calls or secs <= 0:
        return None
    cfg, wl = obs["config"], obs["workload"]
    hd = cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]
    bound = yardstick.bound_seconds(*yardstick.flash_forward(
        wl["batch"], cfg["n_heads"], cfg["n_kv_heads"], wl["prompt_len"],
        hd, 2, lse=False))
    return 100.0 * calls * bound / secs
