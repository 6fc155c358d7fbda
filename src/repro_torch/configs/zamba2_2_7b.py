"""zamba2-2.7b [hybrid]: 54 Mamba2 layers d_model=2560 + ONE shared
attention+MLP block (32H kv=32, d_ff=10240, concat(hidden, embed) input,
per-use LoRA r=128) applied every 6 mamba blocks; ssm_state=64.
[arXiv:2411.15242]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32_000, norm="rmsnorm", mlp="swiglu",
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_ngroups=1,
    ssm_chunk=512,
    shared_attn_every=6, lora_rank=128,
)

SMOKE = CONFIG.replace(
    n_layers=6, d_model=32, n_heads=4, n_kv_heads=4, d_ff=64, vocab=256,
    ssm_state=8, ssm_headdim=8, ssm_chunk=8, shared_attn_every=3,
    lora_rank=4, param_dtype="float32", compute_dtype="float32")
