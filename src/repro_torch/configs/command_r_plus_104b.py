"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — GQA, no-bias, parallel attn+mlp block,
LayerNorm, tied embeddings.  [hf:CohereForAI/c4ai-command-r-plus]

The numbers are Command R+'s, as in the reference's config (whose
docstring names c4ai-command-r-v01, the 35B model)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=33792,
    vocab=256_000, head_dim=128, norm="layernorm", parallel_block=True,
    tie_embeddings=True, mlp="swiglu", rope_theta=75_000_000.0,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=16, param_dtype="float32", compute_dtype="float32")
