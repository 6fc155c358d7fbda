"""Three-term roofline model for one NVIDIA H100 SXM card.

    compute    = FLOPs / 989e12 FLOP/s (bf16, dense, tensor cores)
    memory     = HBM bytes / 3.35e12 B/s
    collective = collective bytes / 450e9 B/s (NVLink 4, one direction)

The FLOPs, bytes and collective bytes are one rank's, as ``collect``
counts them over the step's ops on that rank's local tensors, so every
term is per card and the formulas divide by one card's peak.  The
constants are ``core.h100``'s, the port's one source of the card's
numbers.  MODEL_FLOPS = 6·N·D for training (forward and backward) and
2·N_active·D for a forward pass alone; attention FLOPs added explicitly.
"""
from __future__ import annotations

import dataclasses

from ..core.h100 import H100

PEAK_FLOPS = H100["peak_bf16_flops"]    # FLOP/s, bf16 dense, per card
HBM_BW = H100["hbm_bw"]                 # B/s per card
# B/s per card, one direction: NVLink 4 on an H100 SXM, 18 links x 25 GB/s
# (the name is the reference's, so ``roofline_terms`` reads records alike)
ICI_BW = 18 * 25e9


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def compute_fraction(self) -> float:
        """Fraction of the roofline-ideal step spent at peak compute — the
        score we hillclimb (1.0 = perfectly compute-bound at peak)."""
        return self.compute_s / max(self.step_s, 1e-30)


def roofline_terms(record: dict) -> Roofline:
    # all inputs are per rank (one rank's local ops)
    return Roofline(
        compute_s=record["flops"] / PEAK_FLOPS,
        memory_s=record["bytes_accessed"] / HBM_BW,
        collective_s=record["collective_bytes"] / ICI_BW,
    )


# ---------------------------------------------------------------------------
# model FLOPs (analytic, for the useful-compute ratio)
# ---------------------------------------------------------------------------


def param_count(cfg) -> tuple[float, float]:
    """(total, active-per-token) parameter counts."""
    d, L = cfg.d_model, cfg.n_layers
    hd = cfg.hd
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    total = active = emb
    if cfg.family in ("dense", "vlm"):
        attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + \
            cfg.n_heads * hd * d
        glu = 3 if cfg.mlp in ("swiglu", "geglu") else 2
        mlp = glu * d * cfg.d_ff
        total += L * (attn + mlp)
        active = total
        if cfg.family == "vlm":
            total += cfg.vis_dim * d
            active = total
    elif cfg.family == "moe":
        attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + \
            cfg.n_heads * hd * d
        ff = cfg.moe_d_ff or cfg.d_ff
        expert = 3 * d * ff
        shared = 3 * d * ff * cfg.n_shared_experts
        router = d * cfg.n_experts
        n_moe = L - cfg.first_dense
        total += L * attn + cfg.first_dense * 3 * d * cfg.d_ff + \
            n_moe * (cfg.n_experts * expert + shared + router)
        active = emb + L * attn + cfg.first_dense * 3 * d * cfg.d_ff + \
            n_moe * (cfg.top_k * expert + shared + router)
    elif cfg.family in ("ssm", "hybrid"):
        di = cfg.ssm_d_inner
        gn = cfg.ssm_ngroups * cfg.ssm_state
        mamba = d * (2 * di + 2 * gn + cfg.ssm_nheads) + di * d + \
            cfg.ssm_conv * (di + 2 * gn)
        n_mamba = L
        total += n_mamba * mamba
        active = total
        if cfg.family == "hybrid":
            da = 2 * d
            hd2 = da // cfg.n_heads
            shared_blk = da * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd2 + \
                cfg.n_heads * hd2 * d + 2 * da * cfg.d_ff + cfg.d_ff * d
            n_groups = L // cfg.shared_attn_every
            lora = n_groups * cfg.lora_rank * (
                2 * da + cfg.n_heads * hd2 + cfg.d_ff)
            total += shared_blk + lora
            active = total
    elif cfg.family == "audio":
        attn = 4 * d * d
        mlp = 2 * d * cfg.d_ff
        total += cfg.enc_layers * (attn + mlp) + L * (2 * attn + mlp) + \
            cfg.enc_frames * d
        active = total
    return float(total), float(active)


def model_flops(cfg, shape, kind: str) -> float:
    """Analytic useful FLOPs for one step of this cell."""
    total, active = param_count(cfg)
    tokens = shape.global_batch * (shape.seq_len if kind != "decode" else 1)
    mult = 6.0 if kind == "train" else 2.0
    flops = mult * active * tokens
    # attention (quadratic part), forward only; x3 for train
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        s = shape.seq_len
        att = 2 * 2 * shape.global_batch * cfg.n_heads * cfg.hd * (
            s * s / 2 if kind != "decode" else s)
        local, glob = cfg.local_global
        if local + glob > 0 and cfg.window:
            frac_local = local / (local + glob)
            att = att * (1 - frac_local) + frac_local * 2 * 2 * \
                shape.global_batch * cfg.n_heads * cfg.hd * \
                (s * min(cfg.window, s) if kind != "decode"
                 else min(cfg.window, s))
        flops += cfg.n_layers * att * (3 if kind == "train" else 1)
    return float(flops)


__all__ = ["HBM_BW", "ICI_BW", "PEAK_FLOPS", "Roofline", "model_flops",
           "param_count", "roofline_terms"]
