"""llama4-scout-17b-a16e [moe] — hf:meta-llama/Llama-4-Scout-17B-16E (unverified).

48L d_model=5120 40H (GQA kv=8) d_ff=8192, vocab=202048, MoE 16 experts
top-1.  'Early fusion' refers to the multimodal frontend — out of scope for
the text backbone (assignment gives the LM shapes only); no shared expert
is listed in the assigned config so none is instantiated.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=8192,
    vocab=202048, head_dim=128,
    n_experts=16, top_k=1, n_shared=0,
    rope_theta=500_000.0,
    notes="top-1 routing; early-fusion multimodal frontend not in scope",
)
