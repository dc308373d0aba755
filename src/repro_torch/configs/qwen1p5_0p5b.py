"""qwen1.5-0.5b [dense] — hf:Qwen/Qwen1.5-0.5B (verified: hf).

24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936; QKV bias.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv=16, d_ff=2816,
    vocab=151936, head_dim=64,
    qkv_bias=True, rope_theta=1_000_000.0,
    tie_embeddings=True,
    notes="QKV bias; tied embeddings (0.5B tier ties in HF config)",
)
