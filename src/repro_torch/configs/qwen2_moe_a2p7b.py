"""qwen2-moe-a2.7b [moe] — hf:Qwen/Qwen1.5-MoE-A2.7B (verified: hf).

24L d_model=2048 16H (GQA kv=16) routed d_ff=1408, vocab=151936,
60 routed experts top-4 + 4 shared experts (Qwen1.5-MoE's shared expert is
4x the routed intermediate size == 4 routed-size shared experts).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv=16, d_ff=1408,
    vocab=151936, head_dim=128,
    n_experts=60, top_k=4, n_shared=4,
    qkv_bias=True, rope_theta=1_000_000.0,
    notes="4 shared + 60 routed top-4; QKV bias per Qwen1.5 lineage",
)
