"""internvl2-1b [vlm] — arXiv:2404.16821 (verified: hf).

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655 (Qwen2-0.5B LM
backbone).  InternViT frontend is a STUB: input_specs provides 256
precomputed patch embeddings prepended to the token sequence.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv=2, d_ff=4864,
    vocab=151655, head_dim=64,
    qkv_bias=True, rope_theta=1_000_000.0,
    n_patches=256, tie_embeddings=True,
    notes="InternViT stubbed to precomputed patch embeddings",
)
