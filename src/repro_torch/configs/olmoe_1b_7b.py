"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (kv=16) expert d_ff=1024
vocab=50304, 64 experts top-8, no shared experts.  [arXiv:2409.02060]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
    vocab=50_304, norm="rmsnorm", mlp="swiglu", qk_norm=True,
    n_experts=64, n_shared_experts=0, top_k=8, moe_d_ff=1024,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32, vocab=512,
    n_experts=8, top_k=2, moe_d_ff=32,
    param_dtype="float32", compute_dtype="float32")
