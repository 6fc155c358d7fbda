"""whisper-base [audio]: 6L enc + 6L dec, d_model=512 8H (kv=8) d_ff=2048
vocab=51865 — enc-dec; conv frontend STUB (precomputed (B,1500,512) frame
embeddings).  [arXiv:2212.04356]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab=51_865, norm="layernorm", mlp="gelu", tie_embeddings=True,
    enc_layers=6, enc_frames=1500,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    enc_layers=2, enc_frames=10,
    param_dtype="float32", compute_dtype="float32")
