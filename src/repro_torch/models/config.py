"""Unified architecture configuration for the 10 assigned archs.

Copy of ``repro/models/config.py``: one frozen ``ArchConfig`` covers every
family (dense / MoE / SSM / hybrid / enc-dec / VLM); family-specific
fields are ignored elsewhere.  The exact assigned configurations live in
``repro_torch/configs/<id>.py``.  The padding rules in the docstrings
below (vocab to 128, experts to 16) are the reference's, kept so that
parameter trees and checkpoints cross-load between the packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ArchConfig"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0               # 0 for attention-free
    n_kv: int = 0
    d_ff: int = 0
    head_dim: int = 0              # derived if 0: d_model // n_heads
    # attention options
    qkv_bias: bool = False         # Qwen1.5-style QKV bias
    qk_norm: bool = False          # Qwen3-style per-head RMS norm on q/k
    rope_theta: float = 10_000.0
    rope_enabled: bool = True      # False: absolute positions (Whisper)
    window: int = 0                # >0: sliding-window (local) attention
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    capacity_factor: float = 1.25
    moe_block: int = 256           # block-local routing group size (tokens);
                                   # keeps routing/sort local to sequence
                                   # shards (no cross-shard gathers)
    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # hybrid (RecurrentGemma): layer pattern period (attn every `period`)
    hybrid_period: int = 3         # (rglru, rglru, local-attn) groups
    lru_width: int = 0             # 0 -> d_model
    # enc-dec (Whisper): encoder layer count (decoder uses n_layers)
    n_enc_layers: int = 0
    # VLM stub frontend
    n_patches: int = 0             # prepended precomputed patch embeddings
    # misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    notes: str = ""

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(1, self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding-table vocab padded to a multiple of 128 (MXU lane
        alignment + always divisible by the 16-way model axis).  Logits in
        the padded tail are masked to -inf; labels never reference it."""
        return -(-self.vocab // 128) * 128

    @property
    def padded_experts(self) -> int:
        """Expert count padded to a multiple of 16 so expert parallelism
        always applies (qwen2-moe's 60 -> 64).  The router never selects a
        padded expert, so its capacity slots stay empty — the exact MoE
        analogue of the paper's 'extra iterations' for output channels
        with no non-zero weights.  Costs e_pad/e - 1 idle expert FLOPs."""
        if not self.n_experts or self.n_experts < 16:
            return self.n_experts
        return -(-self.n_experts // 16) * 16

    @property
    def is_subquadratic(self) -> bool:
        """Supports long_500k (constant-size or windowed decode state)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        """Every assigned arch has a decoder (whisper is enc-dec)."""
        return True

    # ----- parameter counting (for MODEL_FLOPS = 6*N*D roofline term) -----

    def param_count(self, active_only: bool = False) -> int:
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            d_in = self.ssm_expand * d
            heads = d_in // self.ssm_head_dim
            per = (
                d * (2 * d_in + 2 * self.ssm_state + heads)  # in_proj [z,x,B,C,dt]
                + self.ssm_conv * (d_in + 2 * self.ssm_state)  # depthwise conv
                + heads * 2                                   # A_log, D
                + d_in                                        # gate norm
                + d_in * d                                    # out_proj
                + d                                           # pre-norm
            )
            return emb + self.n_layers * per

        hd, nh, nkv = self.hd, self.n_heads, self.n_kv
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        if self.qkv_bias:
            attn += (nh + 2 * nkv) * hd
        dense_mlp = 3 * d * self.d_ff
        norms = 2 * d

        if self.family == "moe":
            router = d * self.n_experts
            experts = self.n_experts * 3 * d * self.d_ff
            shared = self.n_shared * 3 * d * self.d_ff
            per = attn + router + experts + shared + norms
            if active_only:
                act = attn + router + (self.top_k + self.n_shared) * 3 * d * self.d_ff + norms
                return emb + self.n_layers * act
            return emb + self.n_layers * per

        if self.family == "hybrid":
            w = self.lru_width or d
            rglru_block = (
                d * w * 2        # in/gate proj
                + w * d          # out proj
                + self.ssm_conv * w
                + 3 * w          # lru gates (r, i params) + lambda
                + w * w * 0      # (gates are elementwise + small projs below)
                + 2 * w * (w // 16)  # r,i block-diagonal projections (16 blocks)
            )
            per_group = 2 * (rglru_block + dense_mlp + norms) + (attn + dense_mlp + norms)
            n_groups = self.n_layers // self.hybrid_period
            tail = self.n_layers - n_groups * self.hybrid_period
            return emb + n_groups * per_group + tail * (rglru_block + dense_mlp + norms)

        if self.family == "encdec":
            enc_per = attn + dense_mlp + norms
            dec_per = attn + (d * nkv * hd * 2 + d * nh * hd + nh * hd * d) + dense_mlp + 3 * d
            return emb + self.n_enc_layers * enc_per + self.n_layers * dec_per

        # dense / vlm
        per = attn + dense_mlp + norms
        return emb + self.n_layers * per
