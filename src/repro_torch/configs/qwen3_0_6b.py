"""qwen3-0.6b [dense]: 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936 — qk_norm, head_dim=128, tied embeddings.  [hf:Qwen/Qwen3-0.6B]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=3072,
    vocab=151_936, head_dim=128, norm="rmsnorm", qk_norm=True,
    tie_embeddings=True, mlp="swiglu", rope_theta=1_000_000.0,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=16, param_dtype="float32", compute_dtype="float32")
