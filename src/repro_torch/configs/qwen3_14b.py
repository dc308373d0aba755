"""qwen3-14b [dense] — hf:Qwen/Qwen3 lineage (verified: hf).

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936; per-head q/k RMS
norm (qk_norm), no QKV bias (Qwen3 dropped it).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv=8, d_ff=17408,
    vocab=151936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0,
)
