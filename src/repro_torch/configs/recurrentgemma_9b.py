"""recurrentgemma-9b [hybrid] — arXiv:2402.19427 (unverified).

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000; RG-LRU recurrent
blocks with local (window 2048) attention every third layer (1:2 ratio),
lru_width = d_model.  Sub-quadratic: runs the long_500k shape.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv=1, d_ff=12288,
    vocab=256000, head_dim=256,
    window=2048, hybrid_period=3, lru_width=4096, ssm_conv=4,
    rope_theta=10_000.0,
    notes="(rglru, rglru, local-attn) period-3 pattern; 38 = 12*3 + 2 tail",
)
