"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216 — SigLIP frontend STUB (precomputed (B,256,1152) patch
embeddings) + linear projector + gemma decoder.  [arXiv:2407.07726]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab=257_216, head_dim=256, norm="rmsnorm", mlp="gelu",
    embed_scale=True, tie_embeddings=True,
    vis_tokens=256, vis_dim=1152,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128, vocab=512,
    head_dim=16, vis_tokens=8, vis_dim=24,
    param_dtype="float32", compute_dtype="float32")
