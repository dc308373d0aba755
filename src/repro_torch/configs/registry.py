"""Architecture + input-shape registry: the 40-cell (arch x shape) grid.

Shapes (assignment):
    train_4k     seq_len=4096   global_batch=256   (training step)
    prefill_32k  seq_len=32768  global_batch=32    (inference prefill)
    decode_32k   seq_len=32768  global_batch=128   (one-token decode, KV=32k)
    long_500k    seq_len=524288 global_batch=1     (long-context decode)

``long_500k`` requires sub-quadratic attention: it runs for the SSM/hybrid
archs (mamba2-780m, recurrentgemma-9b) and is **skipped** for the pure
full-attention archs — see DESIGN.md §5.  Every arch here has a decoder, so
no decode-shape skips.

``reduced_config`` provides the smoke-test scale-down of each family
(small widths/layers/experts/vocab).  Copy of ``repro/configs/registry.py``
that imports the port's config modules; on the card the port also runs
full configs that fit one card (qwen1.5-0.5b, mamba2-780m).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

from repro_torch.models.config import ArchConfig

__all__ = [
    "ARCH_IDS", "SHAPES", "get_config", "reduced_config", "all_cells",
    "cell_applicable",
]

_MODULES = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "qwen1.5-0.5b": "qwen1p5_0p5b",
    "yi-9b": "yi_9b",
    "qwen3-14b": "qwen3_14b",
    "llama3-8b": "llama3_8b",
    "mamba2-780m": "mamba2_780m",
    "internvl2-1b": "internvl2_1b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-large-v3": "whisper_large_v3",
}
ARCH_IDS = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def get_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def cell_applicable(arch_id: str, shape_name: str) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch x shape) cell."""
    cfg = get_config(arch_id)
    if shape_name == "long_500k" and not cfg.is_subquadratic:
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{arch_id} is full-attention (DESIGN.md §5)"
        )
    return True, ""


def all_cells() -> List[Tuple[str, str, bool, str]]:
    """Every (arch, shape) with applicability: 40 rows."""
    rows = []
    for a in ARCH_IDS:
        for s in SHAPES:
            ok, why = cell_applicable(a, s)
            rows.append((a, s, ok, why))
    return rows


def reduced_config(arch_id: str) -> ArchConfig:
    """Family-faithful miniature for CPU smoke tests."""
    cfg = get_config(arch_id)
    common = dict(
        name=cfg.name + "-smoke",
        family=cfg.family,
        vocab=128,
        rope_theta=cfg.rope_theta,
        rope_enabled=cfg.rope_enabled,
        qkv_bias=cfg.qkv_bias,
        qk_norm=cfg.qk_norm,
        tie_embeddings=cfg.tie_embeddings,
    )
    if cfg.family == "ssm":
        return ArchConfig(
            **common, n_layers=2, d_model=32, ssm_state=8, ssm_expand=2,
            ssm_head_dim=8, ssm_conv=4, ssm_chunk=8,
        )
    if cfg.family == "hybrid":
        return ArchConfig(
            **common, n_layers=3, d_model=32, n_heads=4, n_kv=1, d_ff=64,
            head_dim=8, window=8, hybrid_period=3, lru_width=32, ssm_conv=4,
        )
    if cfg.family == "moe":
        return ArchConfig(
            **common, n_layers=2, d_model=32, n_heads=4, n_kv=cfg.n_kv and 2,
            d_ff=48, head_dim=8, n_experts=4, top_k=min(2, cfg.top_k),
            n_shared=min(1, cfg.n_shared),
        )
    if cfg.family == "encdec":
        return ArchConfig(
            **common, n_layers=2, n_enc_layers=2, d_model=32, n_heads=4,
            n_kv=4, d_ff=64, head_dim=8,
        )
    if cfg.family == "vlm":
        return ArchConfig(
            **common, n_layers=2, d_model=32, n_heads=4, n_kv=2, d_ff=64,
            head_dim=8, n_patches=4,
        )
    return ArchConfig(
        **common, n_layers=2, d_model=32, n_heads=4, n_kv=2, d_ff=64, head_dim=8,
    )
