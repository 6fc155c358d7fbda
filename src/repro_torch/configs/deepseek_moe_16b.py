"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=102400, 64 routed experts top-6 + 2 shared, fine-grained; first
layer dense (d_ff=10944).  [arXiv:2401.06066]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
    vocab=102_400, norm="rmsnorm", mlp="swiglu",
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
    first_dense=1,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    n_experts=8, top_k=2, moe_d_ff=32, first_dense=1,
    param_dtype="float32", compute_dtype="float32")
