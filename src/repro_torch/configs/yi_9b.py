"""yi-9b [dense] — arXiv:2403.04652 (verified: hf).

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000; llama-arch GQA.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv=4, d_ff=11008,
    vocab=64000, head_dim=128,
    rope_theta=10_000.0,
)
