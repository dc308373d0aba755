"""Shared neural layers for the architecture zoo, in plain PyTorch ops.

Port of ``repro/models/layers.py``.  Everything is a pure function over
nested-dict params with the reference's keys and shapes, and each one
follows the reference's algorithm and float order:

* **Attention** runs its full-sequence path as an online softmax over
  KV chunks (``m_safe`` guards the ``-inf - -inf`` of fully-masked rows),
  its sliding-window path query-chunked with a band of K/V, and its
  decode path against a pre-allocated KV cache: a ring buffer written at
  ``len % ctx``, optionally int8 with f32 scales per (token, kv-head).
  Supports GQA, QKV bias, per-head q/k RMS norm (Qwen3) and
  cross-attention.  ``scaled_dot_product_attention`` is not used.
* **MoE** routes block-locally top-k with a static (E, C) slot table
  (FIFO capacity by cumsum, overflow dropped), dispatches and combines
  through dense one-hot matrices; padded experts are no-op slots.  Top-k
  is a stable descending sort, so ties go to the lower expert index as
  ``jax.lax.top_k`` gives them.
* **Mamba-2 (SSD)** is the chunked state-space-duality algorithm; the
  segment sum masks before the ``exp`` (``exp(-inf) = 0``).
* **RG-LRU** scans its gated diagonal recurrence within chunks (a
  log-depth scan with the reference's combine) and carries the state
  across chunks; its float order differs from ``associative_scan``'s tree
  only by rounding.

Where the reference writes ``x.at[i].set(v)`` into a bf16 or int8 cache
the port casts explicitly, and einsums promote mixed operand dtypes as
``jnp`` does (an f32 query against a bf16 cache; torch would raise).  The GSPMD cut points of the
reference call :mod:`repro_torch.distributed.ctx`, whose constraints are
the identity here.

Initialisers draw from an explicit ``torch.Generator`` with the
reference's distributions and scales (they do not reproduce jax's random
streams); ``lead`` prepends the dims of a stack of layers, whose every
slice has the reference's per-layer shape and scale.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.ctx import (
    constrain_expert,
    constrain_hidden,
    constrain_seq_gathered,
)

from .config import ArchConfig

__all__ = [
    "rms_norm", "rope", "attention", "swiglu", "moe", "mamba2_block",
    "rglru_block", "init_attention", "init_swiglu", "init_moe",
    "init_mamba2", "init_rglru", "init_embedding",
]

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# dtype promotion
# ---------------------------------------------------------------------------

def _ein(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` of two operands: mixed dtypes (an f32 query against a
    bf16 cache) promote, where ``torch.einsum`` would raise."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def _dense_init(gen: torch.Generator, shape, scale=None, dtype=torch.float32,
                lead: Tuple[int, ...] = ()) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(tuple(lead) + tuple(shape), generator=gen,
                    device=gen.device, dtype=torch.float32)
    return (w * scale).to(dtype)


def _const(value, shape, dtype, gen: torch.Generator, lead=()) -> torch.Tensor:
    return torch.full(tuple(lead) + tuple(shape), value, dtype=dtype,
                      device=gen.device)


def init_embedding(gen, cfg: ArchConfig, dtype=torch.float32, lead=()) -> Params:
    vp = cfg.padded_vocab
    p = {"tok": _dense_init(gen, (vp, cfg.d_model), scale=0.02, dtype=dtype,
                            lead=lead)}
    if not cfg.tie_embeddings:
        p["unemb"] = _dense_init(gen, (cfg.d_model, vp), dtype=dtype, lead=lead)
    return p


def mask_vocab_pad(logits: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """-1e30 in the padded-vocab tail so softmax/argmax never see it."""
    vp = logits.shape[-1]
    if vp == cfg.vocab:
        return logits
    valid = torch.arange(vp, device=logits.device) < cfg.vocab
    return torch.where(valid, logits,
                       torch.full((), -1e30, dtype=logits.dtype,
                                  device=logits.device))


def init_attention(gen, cfg: ArchConfig, cross: bool = False,
                   dtype=torch.float32, lead=()) -> Params:
    hd, nh, nkv = cfg.hd, cfg.n_heads, cfg.n_kv
    p = {
        "wq": _dense_init(gen, (cfg.d_model, nh * hd), dtype=dtype, lead=lead),
        "wk": _dense_init(gen, (cfg.d_model, nkv * hd), dtype=dtype, lead=lead),
        "wv": _dense_init(gen, (cfg.d_model, nkv * hd), dtype=dtype, lead=lead),
        "wo": _dense_init(gen, (nh * hd, cfg.d_model), dtype=dtype, lead=lead),
    }
    if cfg.qkv_bias:
        p["bq"] = _const(0.0, (nh * hd,), dtype, gen, lead)
        p["bk"] = _const(0.0, (nkv * hd,), dtype, gen, lead)
        p["bv"] = _const(0.0, (nkv * hd,), dtype, gen, lead)
    if cfg.qk_norm:
        p["q_norm"] = _const(1.0, (hd,), dtype, gen, lead)
        p["k_norm"] = _const(1.0, (hd,), dtype, gen, lead)
    return p


def init_swiglu(gen, d_model: int, d_ff: int, dtype=torch.float32,
                lead=()) -> Params:
    return {
        "wg": _dense_init(gen, (d_model, d_ff), dtype=dtype, lead=lead),
        "wu": _dense_init(gen, (d_model, d_ff), dtype=dtype, lead=lead),
        "wd": _dense_init(gen, (d_ff, d_model), dtype=dtype, lead=lead),
    }


def init_moe(gen, cfg: ArchConfig, dtype=torch.float32, lead=()) -> Params:
    e, d, f = cfg.padded_experts, cfg.d_model, cfg.d_ff
    p = {
        # router stays (d, n_experts): padded experts are unreachable
        "router": _dense_init(gen, (d, cfg.n_experts), scale=0.02, dtype=dtype,
                              lead=lead),
        "wg": _dense_init(gen, (e, d, f), dtype=dtype, lead=lead),
        "wu": _dense_init(gen, (e, d, f), dtype=dtype, lead=lead),
        "wd": _dense_init(gen, (e, f, d), scale=1.0 / math.sqrt(f), dtype=dtype,
                          lead=lead),
    }
    if cfg.n_shared:
        p["shared"] = init_swiglu(gen, d, cfg.n_shared * cfg.d_ff, dtype=dtype,
                                  lead=lead)
    return p


def init_mamba2(gen, cfg: ArchConfig, dtype=torch.float32, lead=()) -> Params:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    heads = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * cfg.ssm_state
    a_log = torch.log(torch.linspace(1.0, 16.0, heads, device=gen.device))
    return {
        # fused in-proj -> [z (d_in), x (d_in), B (state), C (state), dt (heads)]
        "w_in": _dense_init(gen, (d, 2 * d_in + 2 * cfg.ssm_state + heads),
                            dtype=dtype, lead=lead),
        "conv": _dense_init(gen, (cfg.ssm_conv, conv_dim), scale=0.5,
                            dtype=dtype, lead=lead),
        "a_log": a_log.to(dtype).expand(tuple(lead) + (heads,)).clone(),
        "d_skip": _const(1.0, (heads,), dtype, gen, lead),
        "dt_bias": _const(0.0, (heads,), dtype, gen, lead),
        "gate_norm": _const(1.0, (d_in,), dtype, gen, lead),
        "w_out": _dense_init(gen, (d_in, d), dtype=dtype, lead=lead),
    }


_RGLRU_BLOCKS = 16  # RG-LRU gate projections are block-diagonal (as in
                    # RecurrentGemma)


def init_rglru(gen, cfg: ArchConfig, dtype=torch.float32, lead=()) -> Params:
    d = cfg.d_model
    w = cfg.lru_width or d
    nb = _RGLRU_BLOCKS if w % _RGLRU_BLOCKS == 0 else 1
    wb = w // nb
    return {
        "w_x": _dense_init(gen, (d, w), dtype=dtype, lead=lead),
        "w_gate": _dense_init(gen, (d, w), dtype=dtype, lead=lead),
        "conv": _dense_init(gen, (cfg.ssm_conv, w), scale=0.5, dtype=dtype,
                            lead=lead),
        # block-diagonal input & recurrence gate projections
        "w_r": _dense_init(gen, (nb, wb, wb), scale=0.02, dtype=dtype, lead=lead),
        "w_i": _dense_init(gen, (nb, wb, wb), scale=0.02, dtype=dtype, lead=lead),
        "lam": _const(2.0, (w,), dtype, gen, lead),  # softplus(2): broad decay
        "w_out": _dense_init(gen, (w, d), dtype=dtype, lead=lead),
    }


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    """Cross entropy: (..., V) logits, (...) int labels.

    The max is taken out of the gradient as the reference's
    ``stop_gradient`` does.  The label logit is gathered: the reference
    sums ``logits * one_hot`` over V (for its vocab-sharded layout), which
    adds exact zeros to the one term, so the value and its gradient are
    the same without a (..., V) one-hot buffer.
    """
    logits = logits.to(torch.float32)
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    label_logit = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - label_logit


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, n, hd); positions: (..., S)."""
    hd = x.shape[-1]
    exps = -torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd
    freqs = theta ** exps      # no host-to-device copy of theta (a sync)
    ang = positions[..., None].to(torch.float32) * freqs    # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _write(buf: torch.Tensor, val: torch.Tensor, start: torch.Tensor
           ) -> torch.Tensor:
    """``dynamic_update_slice(buf, val, (0, start, 0, ...))``: a new buffer
    with ``val`` cast to the buffer's dtype at ``start`` along dim 1.  A
    cast to an integer buffer saturates, as XLA's convert does (torch's
    wraps: a bf16 quotient that rounds to 128 would land as -128)."""
    if not buf.dtype.is_floating_point:
        info = torch.iinfo(buf.dtype)
        val = torch.clamp(val, info.min, info.max)
    rows = start.to(torch.int64) + torch.arange(val.shape[1], device=buf.device)
    return buf.index_copy(1, rows, val.to(buf.dtype))


def attention(
    params: Params,
    x: torch.Tensor,                      # (B, S, d)
    cfg: ArchConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,  # decode: {"k","v","len"}
    kv_x: Optional[torch.Tensor] = None,  # cross-attention source (B, Skv, d)
    causal: bool = True,
    window: int = 0,
    q_chunk: int = 1024,
    build_cache: bool = False,
    cache_headroom: int = 0,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Query-chunked (G)QA with optional KV cache decode / cross-attn.

    ``build_cache=True`` (prefill): the full-sequence path additionally
    returns a decode-ready KV cache — full context, or the last ``window``
    positions rotated into ring-buffer layout for local attention.
    """
    b, s, _ = x.shape
    hd, nh, nkv = cfg.hd, cfg.n_heads, cfg.n_kv
    rep = nh // max(1, nkv)
    dev = x.device

    q = x @ params["wq"]
    src = kv_x if kv_x is not None else x
    k = src @ params["wk"]
    v = src @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, s, nh, hd)
    k = k.reshape(b, src.shape[1], nkv, hd)
    v = v.reshape(b, src.shape[1], nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)

    use_rope = cfg.rope_enabled and kv_x is None  # no rope on cross-attention
    if positions is None:
        positions = torch.arange(s, device=dev)[None, :]
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)

    if cache is not None:
        # single-token decode against a pre-allocated cache.  Windowed
        # caches are ring buffers (write at len % ctx); full caches are the
        # special case window == ctx where the ring never wraps.  int8
        # caches ("k_scale"/"v_scale" present) store per-(token, kv head)
        # symmetric-quantized entries.
        if use_rope:
            k = rope(k, positions, cfg.rope_theta)
        quant = "k_scale" in cache
        ctx = cache["k"].shape[1]
        idx = cache["len"]
        # dynamic_update_slice clamps the start so the update fits
        start = torch.clamp(torch.remainder(idx, ctx), 0, ctx - s)

        if quant:
            ks = torch.clamp_min(torch.amax(torch.abs(k), -1), 1e-8) / 127.0
            vs_ = torch.clamp_min(torch.amax(torch.abs(v), -1), 1e-8) / 127.0
            ck = _write(cache["k"], torch.round(k / ks[..., None]), start)
            cv = _write(cache["v"], torch.round(v / vs_[..., None]), start)
            cks = _write(cache["k_scale"], ks, start)
            cvs = _write(cache["v_scale"], vs_, start)
            new_cache = {"k": ck, "v": cv, "k_scale": cks, "v_scale": cvs,
                         "len": idx + s}
            k_eff = ck.to(x.dtype) * cks.to(x.dtype)[..., None]
            v_eff = cv.to(x.dtype) * cvs.to(x.dtype)[..., None]
        else:
            ck = _write(cache["k"], k, start)
            cv = _write(cache["v"], v, start)
            new_cache = {"k": ck, "v": cv, "len": idx + s}
            k_eff, v_eff = ck, cv
        kpos = torch.arange(ctx, device=dev)
        valid = kpos[None, :] < torch.clamp_max(idx + s, ctx)   # (1, ctx)
        qh = q.reshape(b, s, nkv, rep, hd)
        scores = _ein("bsgrh,bcgh->bgrsc", qh, k_eff) / math.sqrt(hd)
        scores = torch.where(valid[:, None, None, None, :], scores,
                             torch.full((), -1e30, dtype=scores.dtype,
                                        device=dev))
        probs = torch.softmax(scores.to(torch.float32), dim=-1).to(x.dtype)
        out = _ein("bgrsc,bcgh->bsgrh", probs, v_eff).reshape(b, s, nh * hd)
        return out @ params["wo"], new_cache

    # full (training / prefill) path
    if use_rope:
        k = rope(k, positions, cfg.rope_theta)
    skv = k.shape[1]
    if not window:
        # ---- online softmax over KV chunks (flash-style dataflow) ----
        k = constrain_seq_gathered(k)
        v = constrain_seq_gathered(v)
        kv_chunk = min(1024, skv)
        pad_kv = (-skv) % kv_chunk
        if pad_kv:
            k = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
            v = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
        nkc = (skv + pad_kv) // kv_chunk
        qh = q.reshape(b, s, nkv, rep, hd)
        qpos = positions[0] if positions.ndim > 1 else positions  # (S,)
        neg_inf = torch.full((), -math.inf, dtype=torch.float32, device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)

        m = torch.full((b, nkv, rep, s), -math.inf, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, nkv, rep, s), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, s, nkv, rep, hd), dtype=torch.float32, device=dev)
        for c in range(nkc):
            ks = k[:, c * kv_chunk:(c + 1) * kv_chunk]
            vs = v[:, c * kv_chunk:(c + 1) * kv_chunk]
            sc = _ein("bsgrh,bcgh->bgrsc", qh, ks) / math.sqrt(hd)
            sc = sc.to(torch.float32)
            kpos = c * kv_chunk + torch.arange(kv_chunk, device=dev)
            valid = kpos[None, :] < skv
            if causal:
                valid = valid & (kpos[None, :] <= qpos[:, None])
            sc = torch.where(valid[None, None, None], sc, neg_inf)
            m_new = torch.maximum(m, torch.amax(sc, -1))
            # all-masked rows keep m = -inf; shift by a finite max instead
            m_safe = torch.where(torch.isfinite(m_new), m_new, zero)
            p = torch.exp(sc - m_safe[..., None])
            finite = torch.isfinite(m)
            scale = torch.exp(torch.where(finite, m - m_safe, neg_inf))
            scale = torch.where(finite, scale, zero)
            l = l * scale + p.sum(-1)
            pv = _ein("bgrsc,bcgh->bsgrh", p.to(x.dtype), vs)
            acc = acc * torch.movedim(scale, 3, 1)[..., None, None].reshape(
                b, s, nkv, rep, 1) + pv.to(torch.float32)
            m = m_new
        denom = torch.movedim(torch.clamp_min(l, 1e-30), 3, 1).reshape(
            b, s, nkv, rep, 1)
        out = (acc / denom).to(x.dtype).reshape(b, s, nh * hd)
        new_cache = None
        if build_cache:
            kc = F.pad(k[:, :skv], (0, 0, 0, 0, 0, cache_headroom))
            vc = F.pad(v[:, :skv], (0, 0, 0, 0, 0, cache_headroom))
            new_cache = {"k": kc, "v": vc, "len": _len(s, dev)}
        return out @ params["wo"], new_cache

    # windowed layers gain nothing from big query chunks; smaller chunks
    # shrink the (qc x band) scores buffer proportionally
    q_chunk = min(q_chunk, max(256, window // 4))
    n_chunks = max(1, -(-s // q_chunk))
    pad = n_chunks * q_chunk - s
    qp = F.pad(q, (0, 0, 0, 0, 0, pad))
    qh = qp.reshape(b, n_chunks, q_chunk, nkv, rep, hd)
    # banded local attention: a window-w causal query chunk only sees K/V
    # in [chunk_start - w, chunk_end); engaged only where the band is at
    # most half the sequence
    band = q_chunk + window if causal else skv
    band = band if band * 2 <= skv else skv
    band = min(band, skv)
    outs = []
    for c in range(n_chunks):
        qc = qh[:, c]                                   # (B, qc, nkv, rep, hd)
        qpos = c * q_chunk + torch.arange(q_chunk, device=dev)
        if band < skv:
            start = min(max(c * q_chunk - window, 0), skv - band)
            kc, vc = k[:, start:start + band], v[:, start:start + band]
            kpos = start + torch.arange(band, device=dev)
        else:
            kc, vc = k, v
            kpos = torch.arange(skv, device=dev)
        scores = _ein("bsgrh,bcgh->bgrsc", qc, kc) / math.sqrt(hd)
        mask = torch.ones((q_chunk, band), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
        scores = torch.where(mask[None, None, None], scores,
                             torch.full((), -1e30, dtype=scores.dtype,
                                        device=dev))
        probs = torch.softmax(scores.to(torch.float32), dim=-1).to(x.dtype)
        outs.append(_ein("bgrsc,bcgh->bsgrh", probs, vc))
    out = torch.stack(outs, 1).reshape(b, n_chunks * q_chunk, nh * hd)[:, :s]
    new_cache = None
    if build_cache:
        if window < s:
            # ring-buffer layout: position p lives at slot p % window
            kc = torch.roll(k[:, -window:], s % window, dims=1)
            vc = torch.roll(v[:, -window:], s % window, dims=1)
        else:
            # headroom: room for generated tokens before the ring wraps
            kc = F.pad(k, (0, 0, 0, 0, 0, cache_headroom))
            vc = F.pad(v, (0, 0, 0, 0, 0, cache_headroom))
        new_cache = {"k": kc, "v": vc, "len": _len(s, dev)}
    return out @ params["wo"], new_cache


def _len(s: int, device) -> torch.Tensor:
    """A cache length: an int32 scalar on the cache's device (a fill, not a
    copy from the host)."""
    return torch.full((), s, dtype=torch.int32, device=device)


def swiglu(params: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ params["wg"]) * (x @ params["wu"])) @ params["wd"]


# ---------------------------------------------------------------------------
# MoE with static-capacity schedule (paper's precomputed-schedule idea)
# ---------------------------------------------------------------------------

def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last dim, ties to the
    lower index (a stable descending sort; ``torch.topk`` promises no
    order among ties)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def moe_routing(params: Params, x: torch.Tensor, cfg: ArchConfig):
    """The router's half of :func:`moe`: ``(top_p (B, nb, blk, k), slot
    (B, nb, blk, k), cap)``.  ``slot`` is each token copy's place in the
    (E, C) slot table, ``e * cap`` for a copy dropped by FIFO capacity."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    blk = cfg.moe_block if (cfg.moe_block and s % cfg.moe_block == 0) else s
    nb = s // blk
    cap = int(math.ceil(blk * k / e * cfg.capacity_factor))
    cap = max(cap, k)
    nk = blk * k
    xb = x.reshape(b, nb, blk, d)
    logits = xb @ params["router"]                      # (b, nb, blk, E)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    top_p, top_ids = _top_k(probs, k)                       # (b, nb, blk, k)
    top_p = (top_p / (top_p.sum(-1, keepdim=True) + 1e-9)).to(x.dtype)
    ids = top_ids.reshape(b, nb, nk)                        # copy -> expert
    sel = F.one_hot(ids, e)                                 # (b, nb, nk, E)
    # FIFO capacity: copy position within its expert = exclusive prefix sum
    pos = ((torch.cumsum(sel, dim=-2) - 1) * sel).sum(-1)   # (b, nb, nk)
    slot = torch.where(pos < cap, ids * cap + pos,
                       torch.full((), e * cap, dtype=ids.dtype, device=x.device))
    return top_p, slot.reshape(b, nb, blk, k), cap


def moe(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Block-local top-k routing with a static (E, C) slot table and dense
    one-hot dispatch/combine, as the reference computes it.

    A dropped copy's slot is ``e * cap``: with ``padded_experts > e``
    (qwen2-moe's 60 -> 64) that is the first slot of the first padded
    expert, not the discarded column, exactly as in the reference.
    """
    b, s, d = x.shape
    k = cfg.top_k
    e_pad = cfg.padded_experts
    top_p, slot_tok, cap = moe_routing(params, x, cfg)
    nb, blk = slot_tok.shape[1], slot_tok.shape[2]
    xb = x.reshape(b, nb, blk, d)

    n_slots = e_pad * cap
    disp = sum(F.one_hot(slot_tok[..., i], n_slots + 1).to(x.dtype)[..., :-1]
               for i in range(k))
    gathered = _ein("bnts,bntd->bnsd", disp, xb)
    gathered = gathered.reshape(b, nb, e_pad, cap, d)
    gathered = constrain_expert(gathered, 2)

    h = F.silu(_ein("bnecd,edf->bnecf", gathered, params["wg"]))
    h = h * _ein("bnecd,edf->bnecf", gathered, params["wu"])
    y = _ein("bnecf,efd->bnecd", h, params["wd"])
    y = constrain_expert(y, 2).reshape(b, nb, n_slots, d)

    # combine: router-weighted one-hots in one token x slot matrix
    disp_w = sum(top_p[..., i, None]
                 * F.one_hot(slot_tok[..., i], n_slots + 1).to(x.dtype)[..., :-1]
                 for i in range(k))
    out = _ein("bnts,bnsd->bntd", disp_w, y).reshape(b, s, d)
    if cfg.n_shared:
        out = out + swiglu(params["shared"], x)
    return out


# ---------------------------------------------------------------------------
# Mamba-2 (SSD, chunked)
# ---------------------------------------------------------------------------

def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = ``logaddexp(x, 0)`` (torch's softplus switches
    to the identity above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _ssd_chunked(xh, dt, a_log, bmat, cmat, chunk: int):
    """Chunked state-space duality.

    xh: (B, S, H, P) inputs per head; dt: (B, S, H) positive step sizes;
    a_log: (H,) (A = -exp(a_log)); bmat/cmat: (B, S, N) shared across heads.
    Returns (y (B, S, H, P), final state (B, H, N, P)).
    """
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    nc = s // chunk
    assert nc * chunk == s, (s, chunk)
    a = -torch.exp(a_log.to(torch.float32))                  # (H,)
    dta = dt.to(torch.float32) * a                           # (B, S, H) negative
    x_ = xh.reshape(b, nc, chunk, h, p)
    dt_ = dt.reshape(b, nc, chunk, h).to(torch.float32)
    dta_ = dta.reshape(b, nc, chunk, h)
    b_ = bmat.reshape(b, nc, chunk, n)
    c_ = cmat.reshape(b, nc, chunk, n)

    cum = torch.cumsum(dta_, dim=2)                          # (B, nc, Q, H)
    # intra-chunk: y_intra[t] = sum_{u<=t} C_t B_u^T exp(cum_t - cum_u) dt_u x_u
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,Q,Q,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xh.device))
    # mask BEFORE exp: exp of the (positive) upper triangle overflows to
    # inf and a mask after it back-propagates NaN
    gate = torch.exp(torch.where(tri[None, None, :, :, None], decay,
                                 torch.full((), -math.inf, device=xh.device)))
    cb = _ein("bqtn,bqun->bqtu", c_, b_)                     # (B,nc,Q,Q)
    w = cb[..., None] * gate * dt_[:, :, None, :, :]         # (B,nc,Q,Q,H)
    y_intra = _ein("bqtuh,bquhp->bqthp", w.to(xh.dtype), x_)

    # chunk-final states: S_c = sum_u exp(cum_Q - cum_u) dt_u B_u x_u^T
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)        # (B,nc,Q,H)
    sb = b_[..., None, :] * (decay_to_end * dt_)[..., None]  # (B,nc,Q,H,N)
    states = _ein("bquhn,bquhp->bqhnp", sb.to(xh.dtype), x_)

    # inter-chunk recurrence over nc (sequential; nc is small)
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (B,nc,H)
    hstate = torch.zeros((b, h, n, p), dtype=xh.dtype, device=xh.device)
    hprevs = []
    for c in range(nc):
        hprevs.append(hstate)                                # entering chunk c
        hstate = hstate * chunk_decay[:, c][..., None, None].to(xh.dtype) \
            + states[:, c]
    hprevs = torch.stack(hprevs, 1)                          # (B,nc,H,N,P)

    # inter-chunk contribution: y_inter[t] = C_t h_prev * exp(cum_t)
    in_decay = torch.exp(cum)                                # (B,nc,Q,H)
    y_inter = _ein("bqtn,bqhnp->bqthp", c_.to(xh.dtype), hprevs) \
        * in_decay[..., None].to(xh.dtype)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, hstate


def mamba2_block(
    params: Params,
    x: torch.Tensor,                 # (B, S, d)
    cfg: ArchConfig,
    state: Optional[Dict[str, torch.Tensor]] = None,  # decode state
    build_state: bool = False,       # prefill: also return the decode state
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    b, s, d = x.shape
    d_in = cfg.ssm_expand * d
    heads = d_in // cfg.ssm_head_dim
    p_dim = cfg.ssm_head_dim
    n = cfg.ssm_state

    zxbcdt = x @ params["w_in"]
    z, xs, bmat, cmat, dt = torch.split(zxbcdt, [d_in, d_in, n, n, heads], -1)
    dt = _softplus(dt + params["dt_bias"])                    # (B, S, H)

    conv_in = torch.cat([xs, bmat, cmat], dim=-1)             # (B, S, conv_dim)
    if state is None:
        # causal depthwise conv via padding
        pad = F.pad(conv_in, (0, 0, cfg.ssm_conv - 1, 0))
        conv = sum(pad[:, i:i + s] * params["conv"][i]
                   for i in range(cfg.ssm_conv))
        conv = F.silu(conv)
        xs, bmat, cmat = torch.split(conv, [d_in, n, n], -1)
        xh = xs.reshape(b, s, heads, p_dim)
        # chunk must divide S; fall back to the largest divisor
        chunk = cfg.ssm_chunk
        if s % chunk:
            chunk = max(c for c in range(1, min(s, chunk) + 1) if s % c == 0)
        y, h_final = _ssd_chunked(xh, dt, params["a_log"], bmat, cmat, chunk)
        y = y + params["d_skip"][:, None] * xh
        new_state = None
        if build_state:
            new_state = {"conv": conv_in[:, -cfg.ssm_conv:],
                         "ssm": h_final.to(x.dtype)}
    else:
        # single-token decode: roll conv buffer, one recurrence step
        buf = torch.cat([state["conv"][:, 1:], conv_in], dim=1)
        conv = F.silu(_ein("bts,ts->bs", buf, params["conv"]))[:, None]
        xs, bmat, cmat = torch.split(conv, [d_in, n, n], -1)
        xh = xs.reshape(b, 1, heads, p_dim)[:, 0]             # (B, H, P)
        a = -torch.exp(params["a_log"].to(torch.float32))
        dec = torch.exp(dt[:, 0].to(torch.float32) * a)       # (B, H)
        ssm = state["ssm"]                                    # (B, H, N, P)
        upd = (dt[:, 0][..., None, None]
               * bmat[:, 0, None, :, None].to(torch.float32)
               * xh[:, :, None, :].to(torch.float32))
        ssm = ssm * dec[..., None, None].to(ssm.dtype) + upd.to(ssm.dtype)
        y = _ein("bn,bhnp->bhp", cmat[:, 0].to(ssm.dtype), ssm)
        y = (y + params["d_skip"][:, None] * xh)[:, None]     # (B, 1, H, P)
        new_state = {"conv": buf, "ssm": ssm}

    y = y.reshape(b, s, d_in)
    y = rms_norm(y * F.silu(z), params["gate_norm"], cfg.norm_eps)
    return y @ params["w_out"], new_state


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma recurrent block)
# ---------------------------------------------------------------------------

_C_RGLRU = 8.0


def _scan_within_chunks(a: torch.Tensor, bx: torch.Tensor):
    """Inclusive scan of ``h_t = a_t h_{t-1} + bx_t`` along dim 2, with the
    reference's combine ``(a1, b1), (a2, b2) -> (a1 a2, b1 a2 + b2)``
    applied in log2(chunk) doubling steps.  Returns (prod of a, h)."""
    n = a.shape[2]
    off = 1
    while off < n:
        a_prev = F.pad(a[:, :, :-off], (0, 0, off, 0), value=1.0)
        b_prev = F.pad(bx[:, :, :-off], (0, 0, off, 0))
        bx = b_prev * a + bx
        a = a_prev * a
        off *= 2
    return a, bx


def rglru_block(
    params: Params,
    x: torch.Tensor,                 # (B, S, d)
    cfg: ArchConfig,
    state: Optional[Dict[str, torch.Tensor]] = None,
    build_state: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    b, s, d = x.shape
    w = cfg.lru_width or d
    # jax.nn.gelu is the tanh form by default
    gate = constrain_hidden(F.gelu(x @ params["w_gate"], approximate="tanh"))
    xs = constrain_hidden(x @ params["w_x"])

    if state is None:
        pad = F.pad(xs, (0, 0, cfg.ssm_conv - 1, 0))
        xc = sum(pad[:, i:i + s] * params["conv"][i] for i in range(cfg.ssm_conv))
    else:
        buf = torch.cat([state["conv"][:, 1:], xs], dim=1)
        xc = _ein("bts,ts->bs", buf, params["conv"])[:, None]

    nb, wb, _ = params["w_r"].shape
    xg = xc.reshape(b, s, nb, wb)
    r = torch.sigmoid(_ein("bsgi,gij->bsgj", xg, params["w_r"]).reshape(b, s, w))
    i = torch.sigmoid(_ein("bsgi,gij->bsgj", xg, params["w_i"]).reshape(b, s, w))
    log_a = -_C_RGLRU * r * _softplus(params["lam"])         # (B, S, w) <= 0
    a = torch.exp(log_a.to(torch.float32))
    gated_x = i * xc
    beta = torch.sqrt(torch.clamp_min(1.0 - a ** 2, 1e-9)).to(x.dtype)

    if state is None:
        # h_t = a_t h_{t-1} + beta_t (i_t x_t), evaluated chunked: a scan
        # within each chunk, then the chunk-boundary states carried across
        chunk = 256
        if s % chunk:
            chunk = max(c for c in range(1, min(s, chunk) + 1) if s % c == 0)
        nc = s // chunk
        a_ = a.reshape(b, nc, chunk, w)                       # f32
        bx = (beta * gated_x).to(torch.float32).reshape(b, nc, chunk, w)
        a_cum, h_local = _scan_within_chunks(a_, bx)
        h_in = torch.zeros((b, w), dtype=torch.float32, device=x.device)
        h_ins = []
        for c in range(nc):                                   # over chunks
            h_ins.append(h_in)
            h_in = a_cum[:, c, -1] * h_in + h_local[:, c, -1]
        h_ins = torch.stack(h_ins, 1)                         # (B, nc, w)
        h = (h_local + a_cum * h_ins[:, :, None, :]).reshape(b, s, w)
        h = constrain_hidden(h.to(x.dtype))
        new_state = None
        if build_state:
            new_state = {"conv": xs[:, -cfg.ssm_conv:], "lru": h[:, -1]}
    else:
        h = (a[:, 0].to(x.dtype) * state["lru"]
             + beta[:, 0] * gated_x[:, 0])[:, None]
        new_state = {"conv": buf, "lru": h[:, 0]}

    return (h * gate) @ params["w_out"], new_state
