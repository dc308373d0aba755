"""mamba2-780m [ssm] — arXiv:2405.21060 (unverified).

48L d_model=1536, attention-free, vocab=50280, SSD state 128,
expand 2 (d_inner=3072, 48 heads of head_dim 64), conv width 4.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv=0, d_ff=0,
    vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=256,
    tie_embeddings=True,
    notes="SSD (state-space duality) chunked scan; sub-quadratic decode",
)
