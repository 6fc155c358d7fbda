"""mamba2-2.7b [ssm]: 64L d_model=2560 attn-free, ssm_state=128,
SSD (state-space duality) chunked scan, vocab=50280.  [arXiv:2405.21060]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50_280, norm="rmsnorm",
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_ngroups=1,
    ssm_chunk=512,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, vocab=256, ssm_state=16, ssm_headdim=16,
    ssm_chunk=8, param_dtype="float32", compute_dtype="float32")
