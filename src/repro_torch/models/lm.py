"""Decoder LM assembly for dense / MoE / SSM / hybrid / VLM families.

Port of ``repro/models/lm.py``, with the reference's parameter tree:
one stacked tree per run of identical layer kinds (``params["stacks"]``,
every leaf with a leading (L, ...) axis), so :mod:`repro_torch.convert`
carries the reference's params across leaf by leaf and checkpoints
cross-load.  The reference's ``lax.scan`` over a stack is a Python loop
over the stack's slices here (``torch.unbind``, whose backward stacks the
layers' gradients once).  Its ``jax.checkpoint`` on the layer body (and
on each cross-entropy chunk) is ``torch.utils.checkpoint`` with
``use_reentrant=False`` while gradients are being recorded, so training
keeps the reference's O(one layer) activation memory; without autograd
nothing is recomputed.

Decode uses a pre-allocated KV cache (attention), rolling conv+SSM state
(mamba2) or conv+LRU state (RG-LRU), stacked over layers as in the
reference; cache lengths are int32 scalars on the state's device.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.ctx import (constrain_acts, constrain_head,
                                         constrain_logits)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

from .config import ArchConfig
from .layers import (
    attention,
    init_attention,
    init_embedding,
    init_mamba2,
    init_moe,
    init_rglru,
    init_swiglu,
    mamba2_block,
    mask_vocab_pad,
    moe,
    rglru_block,
    rms_norm,
    softmax_cross_entropy,
    swiglu,
)

__all__ = [
    "init_lm",
    "lm_forward",
    "lm_loss",
    "lm_prefill",
    "init_decode_state",
    "lm_decode_step",
]

Params = Dict[str, Any]

_ATTN_KINDS = ("attn_mlp", "attn_moe")


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------

def unstack(tree, count: int) -> List[Any]:
    """A tree of (count, ...) leaves -> ``count`` trees of slices."""
    columns = [torch.unbind(leaf, 0) for leaf in tree_leaves(tree)]
    return [tree_unflatten(tree, [c[i] for c in columns]) for i in range(count)]


def stack(trees: List[Any]):
    """``count`` trees of the same structure -> one tree of stacked leaves."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def remat(fn, *args):
    """``fn(*args)``, recomputed in the backward pass while autograd
    records (``jax.checkpoint``).  The layers draw no random numbers, so
    the generators' state is not saved for the recomputation: reading it
    is forbidden inside a CUDA-graph capture, and meta tensors have none."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(gen, cfg: ArchConfig, kind: str, dtype, lead) -> Params:
    """A stack of ``lead`` layers' params.
    kind: attn_mlp | attn_moe | ssm | rglru_mlp | hybrid_group."""
    if kind == "hybrid_group":
        # one stacked unit = (rglru, rglru, local-attn)
        subs = ["rglru_mlp"] * (cfg.hybrid_period - 1) + ["attn_mlp"]
        return {f"b{i}": _init_block(gen, cfg, sk, dtype, lead)
                for i, sk in enumerate(subs)}
    d = cfg.d_model
    ones = torch.ones(tuple(lead) + (d,), dtype=dtype, device=gen.device)
    p: Params = {"norm1": ones, "norm2": ones.clone()}
    if kind == "attn_mlp":
        p["attn"] = init_attention(gen, cfg, dtype=dtype, lead=lead)
        p["mlp"] = init_swiglu(gen, d, cfg.d_ff, dtype=dtype, lead=lead)
    elif kind == "attn_moe":
        p["attn"] = init_attention(gen, cfg, dtype=dtype, lead=lead)
        p["moe"] = init_moe(gen, cfg, dtype=dtype, lead=lead)
    elif kind == "ssm":
        p.pop("norm2")
        p["ssm"] = init_mamba2(gen, cfg, dtype=dtype, lead=lead)
    elif kind == "rglru_mlp":
        p["rglru"] = init_rglru(gen, cfg, dtype=dtype, lead=lead)
        p["mlp"] = init_swiglu(gen, d, cfg.d_ff, dtype=dtype, lead=lead)
    else:
        raise ValueError(kind)
    return p


def _layer_kinds(cfg: ArchConfig) -> Tuple[str, ...]:
    if cfg.family == "moe":
        return ("attn_moe",) * cfg.n_layers
    if cfg.family == "ssm":
        return ("ssm",) * cfg.n_layers
    if cfg.family == "hybrid":
        n_groups = cfg.n_layers // cfg.hybrid_period
        tail = cfg.n_layers - n_groups * cfg.hybrid_period
        return ("hybrid_group",) * n_groups + ("rglru_mlp",) * tail
    return ("attn_mlp",) * cfg.n_layers  # dense / vlm


def _stack_layout(cfg: ArchConfig):
    segs = []
    for kind in _layer_kinds(cfg):
        if segs and segs[-1][0] == kind:
            segs[-1][1] += 1
        else:
            segs.append([kind, 1])
    return [(k, c) for k, c in segs]


def init_lm(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
            device=None) -> Params:
    """Random params from ``gen`` (drawn on its device, then moved to
    ``device`` if given), with the reference's tree, distributions and
    scales."""
    params: Params = {
        "emb": init_embedding(gen, cfg, dtype=dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=gen.device),
        "stacks": [_init_block(gen, cfg, kind, dtype, (count,))
                   for kind, count in _stack_layout(cfg)],
    }
    if device is not None:
        params = tree_map(lambda t: t.to(device), params)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _block_apply(cfg: ArchConfig, kind: str, p: Params, x, state,
                 build_state: bool = False, cache_headroom: int = 0):
    """One layer forward; state is None (train) or the layer's decode state.
    ``build_state`` (prefill) makes the stateless path also emit a
    decode-ready state."""
    if kind == "hybrid_group":
        subs = ["rglru_mlp"] * (cfg.hybrid_period - 1) + ["attn_mlp"]
        new_states = {}
        for i, sk in enumerate(subs):
            sub_state = None if state is None else state[f"s{i}"]
            x, ns = _block_apply(cfg, sk, p[f"b{i}"], x, sub_state,
                                 build_state=build_state,
                                 cache_headroom=cache_headroom)
            new_states[f"s{i}"] = ns
        return x, (new_states if (state is not None or build_state) else None)
    if kind in _ATTN_KINDS:
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        positions = None
        if state is not None:
            positions = state["len"] + torch.arange(x.shape[1],
                                                    device=x.device)[None, :]
        a, new_cache = attention(
            p["attn"], h, cfg, cache=state, positions=positions,
            causal=True, window=cfg.window, build_cache=build_state,
            cache_headroom=cache_headroom,
        )
        x = x + a
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        ff = moe(p["moe"], h, cfg) if kind == "attn_moe" else swiglu(p["mlp"], h)
        return x + ff, new_cache
    if kind == "ssm":
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        y, new_state = mamba2_block(p["ssm"], h, cfg, state=state,
                                    build_state=build_state)
        return x + y, new_state
    if kind == "rglru_mlp":
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        y, new_state = rglru_block(p["rglru"], h, cfg, state=state,
                                   build_state=build_state)
        x = x + y
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        return x + swiglu(p["mlp"], h), new_state
    raise ValueError(kind)


def _embed(params: Params, tokens, cfg: ArchConfig, patch_embeds):
    x = params["emb"]["tok"][tokens.long()]
    if cfg.family == "vlm":
        if patch_embeds is None:
            raise ValueError("vlm needs stub patch embeddings")
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    return constrain_acts(x)


def _backbone(params: Params, tokens, cfg: ArchConfig, patch_embeds,
              remat_layers: bool = True) -> torch.Tensor:
    """Embedding -> layer stacks -> final norm; (B, S, d) pre-unembedding."""
    x = _embed(params, tokens, cfg, patch_embeds)
    for stack_params, (kind, count) in zip(params["stacks"], _stack_layout(cfg)):

        def body(h, layer_p, kind=kind):
            return constrain_acts(_block_apply(cfg, kind, layer_p, h, None)[0])

        for layer_p in unstack(stack_params, count):
            x = remat(body, x, layer_p) if remat_layers else body(x, layer_p)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.family == "vlm":
        x = x[:, patch_embeds.shape[1]:]  # logits over text positions
    return constrain_head(x)


def _unemb(params: Params) -> torch.Tensor:
    unemb = params["emb"].get("unemb")
    if unemb is None:
        unemb = params["emb"]["tok"].T
    return unemb


def lm_forward(
    params: Params,
    tokens: torch.Tensor,                       # (B, S) int
    cfg: ArchConfig,
    patch_embeds: Optional[torch.Tensor] = None,  # (B, P, d) VLM stub frontend
    remat: bool = True,
) -> torch.Tensor:
    x = _backbone(params, tokens, cfg, patch_embeds, remat)
    return constrain_logits(mask_vocab_pad(x @ _unemb(params), cfg))


def chunked_ce(x: torch.Tensor, unemb: torch.Tensor, labels: torch.Tensor,
               cfg: ArchConfig, ce_chunk: int) -> torch.Tensor:
    """Mean cross entropy of ``x @ unemb`` against ``labels``, evaluated per
    ``ce_chunk`` positions (each chunk recomputed in the backward pass), so
    only one (B, chunk, V) f32 logits block is live at a time."""
    b, s, d = x.shape
    chunk = ce_chunk if (ce_chunk and s % ce_chunk == 0) else s

    def body(xc, lc):
        logits = mask_vocab_pad(xc @ unemb, cfg)
        return softmax_cross_entropy(logits, lc).sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(s // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + remat(body, x[:, sl], labels[:, sl])
    return total / (b * s)


def lm_loss(
    params: Params,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    cfg: ArchConfig,
    patch_embeds: Optional[torch.Tensor] = None,
    ce_chunk: int = 256,
) -> torch.Tensor:
    """Chunked cross entropy (see :func:`chunked_ce`).  The reference's
    ``remat_policy`` (a jax checkpoint policy) has no counterpart here."""
    x = _backbone(params, tokens, cfg, patch_embeds)
    return chunked_ce(x, _unemb(params), labels, cfg, ce_chunk)


def lm_prefill(
    params: Params,
    tokens: torch.Tensor,                       # (B, S) int
    cfg: ArchConfig,
    patch_embeds: Optional[torch.Tensor] = None,
    cache_headroom: int = 0,
):
    """Prefill: full causal forward that also materializes decode state.

    Returns ``(last_logits (B, 1, V), states)`` where ``states`` matches
    :func:`init_decode_state` layout (KV caches hold exactly the prefill
    context plus ``cache_headroom``; windowed caches are ring-rotated;
    SSM/LRU states are the post-sequence recurrent states).
    """
    x = _embed(params, tokens, cfg, patch_embeds)
    states = []
    for stack_params, (kind, count) in zip(params["stacks"], _stack_layout(cfg)):
        layer_states = []
        for layer_p in unstack(stack_params, count):
            x, st = _block_apply(cfg, kind, layer_p, x, None, build_state=True,
                                 cache_headroom=cache_headroom)
            x = constrain_acts(x)
            layer_states.append(st)
        st = stack(layer_states)
        if kind in _ATTN_KINDS:
            st = {"k": st["k"], "v": st["v"], "len": st["len"][0]}
        states.append(st)

    x = constrain_head(rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps))
    return mask_vocab_pad(x @ _unemb(params), cfg), states


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ArchConfig, batch: int, ctx: int,
                      dtype=torch.bfloat16, kv_int8: bool = False, device=None):
    """Pre-allocated decode state per stack (stacked over layers), on
    ``device`` (default: the CPU).

    ``kv_int8``: store K/V symmetric-quantized per (token, kv-head) with
    fp32 scales — halves the cache footprint and traffic of decode."""
    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    states = []
    for kind, count in _stack_layout(cfg):
        if kind in _ATTN_KINDS:
            eff_ctx = min(ctx, cfg.window) if cfg.window else ctx
            shape = (count, batch, eff_ctx, cfg.n_kv, cfg.hd)
            kv_dtype = torch.int8 if kv_int8 else dtype
            kv = {"k": zeros(shape, kv_dtype), "v": zeros(shape, kv_dtype),
                  "len": zeros((), torch.int32)}
            if kv_int8:
                kv["k_scale"] = zeros(shape[:-1], torch.float32)
                kv["v_scale"] = zeros(shape[:-1], torch.float32)
            states.append(kv)
        elif kind == "ssm":
            d_in = cfg.ssm_expand * cfg.d_model
            heads = d_in // cfg.ssm_head_dim
            conv_dim = d_in + 2 * cfg.ssm_state
            states.append({
                "conv": zeros((count, batch, cfg.ssm_conv, conv_dim)),
                "ssm": zeros((count, batch, heads, cfg.ssm_state,
                              cfg.ssm_head_dim)),
            })
        elif kind == "rglru_mlp":
            w = cfg.lru_width or cfg.d_model
            states.append({"conv": zeros((count, batch, cfg.ssm_conv, w)),
                           "lru": zeros((count, batch, w))})
        elif kind == "hybrid_group":
            w = cfg.lru_width or cfg.d_model
            eff_ctx = min(ctx, cfg.window) if cfg.window else ctx
            group = {}
            for i in range(cfg.hybrid_period - 1):
                group[f"s{i}"] = {
                    "conv": zeros((count, batch, cfg.ssm_conv, w)),
                    "lru": zeros((count, batch, w)),
                }
            group[f"s{cfg.hybrid_period - 1}"] = {
                "k": zeros((count, batch, eff_ctx, cfg.n_kv, cfg.hd)),
                "v": zeros((count, batch, eff_ctx, cfg.n_kv, cfg.hd)),
                # per-layer lens
                "len": zeros((count,), torch.int32),
            }
            states.append(group)
    return states


def lm_decode_step(
    params: Params,
    states,
    token: torch.Tensor,       # (B, 1) int
    cfg: ArchConfig,
):
    """One decode step: returns (logits (B, 1, V), new_states)."""
    x = constrain_acts(params["emb"]["tok"][token.long()])
    new_states = []
    for stack_params, state, (kind, count) in zip(
        params["stacks"], states, _stack_layout(cfg)
    ):
        layers = unstack(stack_params, count)
        if kind in _ATTN_KINDS:
            # every layer of the stack shares one length
            shared_len = state["len"]
            per_layer = unstack({k2: v2 for k2, v2 in state.items()
                                 if k2 != "len"}, count)
            outs = []
            for layer_p, st in zip(layers, per_layer):
                x, nc = _block_apply(cfg, kind, layer_p, x,
                                     {**st, "len": shared_len})
                outs.append({k2: nc[k2] for k2 in st})
            new_states.append({**stack(outs),
                               "len": shared_len + token.shape[1]})
        else:
            outs = []
            for layer_p, st in zip(layers, unstack(state, count)):
                x, ns = _block_apply(cfg, kind, layer_p, x, st)
                outs.append(ns)
            new_states.append(stack(outs))

    x = constrain_head(rms_norm(x, params["final_norm"], cfg.norm_eps))
    return constrain_logits(mask_vocab_pad(x @ _unemb(params), cfg)), new_states
