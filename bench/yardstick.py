"""The benchmark's frozen arithmetic: the H100's published peaks, a
model's parameter and FLOP counts, and the operations and bytes of the
flash attention forward and backward, worked out from shapes.

``param_count`` and ``model_flops`` are copies of the port's
``roofline.model`` as it stood when the benchmark was written (one
formula for every family), over a configuration file's keys;
``bench/tests/test_bench_yardstick.py`` holds them equal to it.  They stay
here, unchanged, whatever the program later does to its own copy, so
that MFU means the same work in every later check.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: bf16 on the tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# ArchConfig's defaults, for keys a configuration file leaves out
_DEFAULTS = {"head_dim": 0, "tie_embeddings": False, "mlp": "swiglu",
             "n_experts": 0, "n_shared_experts": 0, "top_k": 0,
             "moe_d_ff": 0, "first_dense": 0, "ssm_state": 0,
             "ssm_headdim": 64, "ssm_expand": 2, "ssm_ngroups": 1,
             "ssm_conv": 4, "shared_attn_every": 0, "lora_rank": 0,
             "enc_layers": 0, "enc_frames": 0, "vis_dim": 0,
             "local_global": (0, 0), "window": 0}


def _get(cfg: dict):
    c = {**_DEFAULTS, **cfg}
    return lambda k: c[k]


def param_count(cfg: dict) -> tuple[float, float]:
    """(total, active-per-token) parameter counts."""
    g = _get(cfg)
    d, L = g("d_model"), g("n_layers")
    hd = g("head_dim") or d // max(g("n_heads"), 1)
    emb = g("vocab") * d * (1 if g("tie_embeddings") else 2)
    total = active = emb
    fam = g("family")
    if fam in ("dense", "vlm"):
        attn = d * (g("n_heads") + 2 * g("n_kv_heads")) * hd + \
            g("n_heads") * hd * d
        glu = 3 if g("mlp") in ("swiglu", "geglu") else 2
        total += L * (attn + glu * d * g("d_ff"))
        active = total
        if fam == "vlm":
            total += g("vis_dim") * d
            active = total
    elif fam == "moe":
        attn = d * (g("n_heads") + 2 * g("n_kv_heads")) * hd + \
            g("n_heads") * hd * d
        ff = g("moe_d_ff") or g("d_ff")
        expert = 3 * d * ff
        shared = 3 * d * ff * g("n_shared_experts")
        router = d * g("n_experts")
        n_moe = L - g("first_dense")
        total += L * attn + g("first_dense") * 3 * d * g("d_ff") + \
            n_moe * (g("n_experts") * expert + shared + router)
        active = emb + L * attn + g("first_dense") * 3 * d * g("d_ff") + \
            n_moe * (g("top_k") * expert + shared + router)
    elif fam in ("ssm", "hybrid"):
        di = g("ssm_expand") * d
        gn = g("ssm_ngroups") * g("ssm_state")
        nheads = di // g("ssm_headdim")
        mamba = d * (2 * di + 2 * gn + nheads) + di * d + \
            g("ssm_conv") * (di + 2 * gn)
        total += L * mamba
        active = total
        if fam == "hybrid":
            da = 2 * d
            hd2 = da // g("n_heads")
            shared_blk = da * (g("n_heads") + 2 * g("n_kv_heads")) * hd2 + \
                g("n_heads") * hd2 * d + 2 * da * g("d_ff") + g("d_ff") * d
            n_groups = L // g("shared_attn_every")
            lora = n_groups * g("lora_rank") * (
                2 * da + g("n_heads") * hd2 + g("d_ff"))
            total += shared_blk + lora
            active = total
    elif fam == "audio":
        attn = 4 * d * d
        mlp = 2 * d * g("d_ff")
        total += g("enc_layers") * (attn + mlp) + L * (2 * attn + mlp) + \
            g("enc_frames") * d
        active = total
    return float(total), float(active)


def model_flops(cfg: dict, batch: int, seq_len: int, kind: str) -> float:
    """Useful FLOPs of one step: 6 N_active D for a train step, 2 N_active
    D for a forward (``prefill``) or one token a row (``decode``, against
    ``seq_len`` positions), plus the attention products (x3 to train)."""
    g = _get(cfg)
    _, active = param_count(cfg)
    hd = g("head_dim") or g("d_model") // max(g("n_heads"), 1)
    tokens = batch * (seq_len if kind != "decode" else 1)
    flops = (6.0 if kind == "train" else 2.0) * active * tokens
    if g("family") in ("dense", "moe", "vlm", "audio"):
        s = seq_len
        att = 2 * 2 * batch * g("n_heads") * hd * (
            s * s / 2 if kind != "decode" else s)
        local, glob = g("local_global")
        if local + glob > 0 and g("window"):
            frac_local = local / (local + glob)
            att = att * (1 - frac_local) + frac_local * 2 * 2 * batch * \
                g("n_heads") * hd * (s * min(g("window"), s)
                                     if kind != "decode"
                                     else min(g("window"), s))
        flops += g("n_layers") * att * (3 if kind == "train" else 1)
    return float(flops)


def causal_pairs(b: int, hq: int, sq: int, sk: int) -> int:
    """(q, k) pairs a causal attention computes, the queries being the
    last ``sq`` of ``sk`` positions."""
    off = sk - sq
    # row i sees min(sk, off + i + 1) keys
    return b * hq * sum(min(sk, off + i + 1) for i in range(sq))


def flash_forward(b: int, hq: int, hkv: int, s: int, d: int,
                  elem_bytes: int, lse: bool) -> tuple[float, float]:
    """(FLOPs, HBM bytes) of a causal flash forward over ``s`` positions:
    Q K^T and P V on every visible pair; q, k, v read once and the output
    (and the f32 log-sum-exp of each row, ``lse``) written once."""
    flops = 4.0 * causal_pairs(b, hq, s, s) * d
    nbytes = (2 * b * hq * s * d + 2 * b * hkv * s * d) * elem_bytes
    if lse:
        nbytes += b * hq * s * 4
    return flops, float(nbytes)


def flash_backward(b: int, hq: int, hkv: int, s: int, d: int,
                   elem_bytes: int) -> tuple[float, float]:
    """(FLOPs, HBM bytes) of a causal flash backward: five products (S,
    dP, dQ, dK, dV) on every visible pair; q, k, v, out, dout and the
    log-sum-exp read once, dq, dk, dv written once."""
    flops = 10.0 * causal_pairs(b, hq, s, s) * d
    nbytes = (4 * b * hq * s * d + 4 * b * hkv * s * d) * elem_bytes \
        + b * hq * s * 4
    return flops, float(nbytes)


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the bf16 peak or
    bytes at the HBM rate, whichever is longer."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
