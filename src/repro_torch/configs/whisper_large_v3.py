"""whisper-large-v3 [audio] — arXiv:2212.04356 (unverified).

32 encoder + 32 decoder layers, d_model=1280 20H (MHA kv=20) d_ff=5120
vocab=51866.  Conv/log-mel frontend is a STUB: input_specs provides
precomputed frame embeddings (B, S_enc, d).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, n_enc_layers=32, d_model=1280, n_heads=20, n_kv=20,
    d_ff=5120, vocab=51866, head_dim=64,
    qkv_bias=True, rope_enabled=False,
    tie_embeddings=True,
    notes="enc-dec; conv frontend stubbed to frame embeddings; abs positions",
)
