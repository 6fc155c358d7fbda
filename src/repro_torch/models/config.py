"""Architecture configuration shared by every model family.

A copy of ``repro.models.config.ArchConfig``, field for field.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | vlm | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # normalization / attention details
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    qk_norm: bool = False          # qwen3 per-head RMS on q/k
    rope_frac: float = 1.0         # stablelm: partial rotary (0.25)
    rope_theta: float = 10_000.0
    window: int = 0                # sliding-window size (0 = full)
    local_global: tuple[int, int] = (0, 0)  # gemma3: (5 local, 1 global)
    logit_softcap: float = 0.0
    mlp: str = "swiglu"            # swiglu | geglu | gelu
    parallel_block: bool = False   # command-r style parallel attn+mlp
    tie_embeddings: bool = False
    embed_scale: bool = False      # gemma: scale embeds by sqrt(d_model)

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0              # routed-expert hidden dim
    first_dense: int = 0           # deepseek: leading dense layers
    capacity_factor: float = 1.25
    # dispatch token-block size: the sort-based dispatch processes tokens in
    # blocks of this many (global) tokens, bounding the (E, C, d) buffers —
    # without it a 1M-token prefill materialises ~100 GiB of dispatch state.
    moe_block_tokens: int = 32_768

    # SSM (mamba2 / zamba2 mamba blocks)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2): one shared transformer block every N mamba blocks
    shared_attn_every: int = 0
    lora_rank: int = 0

    # enc-dec (whisper)
    enc_layers: int = 0
    enc_frames: int = 0            # stub conv-frontend output length
    # vlm (paligemma)
    vis_tokens: int = 0
    vis_dim: int = 0

    # numerics / execution
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    attn_impl: str = "auto"        # dense | blocked | auto (seq-dependent)
    attn_block_q: int = 512
    attn_block_kv: int = 1024

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim

    def layer_groups(self) -> tuple[int, int]:
        """(n_groups, layers_per_group) for the grouped layer scan."""
        local, glob = self.local_global
        per = (local + glob) if (local + glob) > 0 else 1
        if self.family == "hybrid" and self.shared_attn_every:
            per = self.shared_attn_every
        n = self.n_layers - self.first_dense
        assert n % per == 0, (self.name, n, per)
        return n // per, per

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


__all__ = ["ArchConfig"]
