"""stablelm-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352 — LayerNorm, partial rotary (25%).
[hf:stabilityai/stablelm-2-12b]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=13824,
    vocab=100_352, norm="layernorm", rope_frac=0.25, mlp="swiglu",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    param_dtype="float32", compute_dtype="float32")
