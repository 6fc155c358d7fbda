"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global sliding window (1024), qk-norm, GeGLU,
embed scaling, 128k context.  [hf:google/gemma-3-12b-pt]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, d_ff=15360,
    vocab=262_144, head_dim=256, norm="rmsnorm", qk_norm=True,
    local_global=(5, 1), window=1024, mlp="geglu", embed_scale=True,
    tie_embeddings=True, rope_theta=1_000_000.0,
)

SMOKE = CONFIG.replace(
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=16, window=8, param_dtype="float32", compute_dtype="float32")
