"""Whisper-style encoder-decoder backbone (assigned arch: whisper-large-v3).

Port of ``repro/models/whisper.py``, with its parameter tree (encoder and
decoder layers stacked along dim 0).  The conv frontend is a stub as in
the reference: ``frames`` are precomputed frame embeddings (B, S_enc, d).
LayerNorm (with bias), GELU MLPs (with bias; ``jax.nn.gelu``'s tanh form),
sinusoidal encoder positions, learned decoder positions, MHA, causal
decoder self-attention + cross-attention into the encoder output.  As in
the reference a zero-init k-proj bias exists and the out-proj bias is
dropped.  Layers run as a Python loop over the stacks, each layer body
under ``torch.utils.checkpoint`` while autograd records (the reference's
``jax.checkpoint``).

Decode uses a self-attention KV cache plus cross K/V projected once from
the encoder output.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.distributed.ctx import (constrain_acts, constrain_head,
                                         constrain_logits)

from .config import ArchConfig
from .layers import _dense_init, _ein, attention, init_attention, mask_vocab_pad
from .lm import chunked_ce, remat, unstack

__all__ = [
    "init_whisper",
    "whisper_forward",
    "whisper_loss",
    "whisper_encode",
    "whisper_prefill",
    "init_whisper_decode_state",
    "whisper_decode_step",
    "precompute_cross_kv",
]

Params = Dict[str, Any]


def _layer_norm(x, p, eps):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["g"] + p["b"]).to(x.dtype)


def _ln_init(d, dtype, gen, lead):
    return {"g": torch.ones(tuple(lead) + (d,), dtype=dtype, device=gen.device),
            "b": torch.zeros(tuple(lead) + (d,), dtype=dtype, device=gen.device)}


def _init_mlp(gen, d, ff, dtype, lead):
    return {
        "w1": _dense_init(gen, (d, ff), dtype=dtype, lead=lead),
        "b1": torch.zeros(tuple(lead) + (ff,), dtype=dtype, device=gen.device),
        "w2": _dense_init(gen, (ff, d), dtype=dtype, lead=lead),
        "b2": torch.zeros(tuple(lead) + (d,), dtype=dtype, device=gen.device),
    }


def _mlp(p, x):
    h = F.gelu(x @ p["w1"] + p["b1"], approximate="tanh")
    return h @ p["w2"] + p["b2"]


def _sinusoid(s, d, device):
    pos = torch.arange(s, device=device)[:, None].to(torch.float32)
    dim = torch.arange(d // 2, device=device)[None, :].to(torch.float32)
    ang = pos / (10_000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_whisper(gen: torch.Generator, cfg: ArchConfig,
                 max_dec_pos: int = 65_536, dtype=torch.float32,
                 device=None) -> Params:
    """Random params from ``gen`` (drawn on its device, then moved to
    ``device`` if given) with the reference's tree, distributions and
    scales."""
    d, ff = cfg.d_model, cfg.d_ff
    n_enc = cfg.n_enc_layers or cfg.n_layers
    enc, dec = (n_enc,), (cfg.n_layers,)
    params = {
        "enc": {
            "ln1": _ln_init(d, dtype, gen, enc),
            "attn": init_attention(gen, cfg, dtype=dtype, lead=enc),
            "ln2": _ln_init(d, dtype, gen, enc),
            "mlp": _init_mlp(gen, d, ff, dtype, enc),
        },
        "dec": {
            "ln1": _ln_init(d, dtype, gen, dec),
            "self": init_attention(gen, cfg, dtype=dtype, lead=dec),
            "ln2": _ln_init(d, dtype, gen, dec),
            "cross": init_attention(gen, cfg, dtype=dtype, lead=dec),
            "ln3": _ln_init(d, dtype, gen, dec),
            "mlp": _init_mlp(gen, d, ff, dtype, dec),
        },
        "tok": _dense_init(gen, (cfg.padded_vocab, d), scale=0.02, dtype=dtype),
        "dec_pos": _dense_init(gen, (max_dec_pos, d), scale=0.02, dtype=dtype),
        "ln_enc": _ln_init(d, dtype, gen, ()),
        "ln_dec": _ln_init(d, dtype, gen, ()),
    }
    if device is not None:
        from repro_torch.tree import tree_map

        params = tree_map(lambda t: t.to(device), params)
    return params


def _n_enc(cfg: ArchConfig) -> int:
    return cfg.n_enc_layers or cfg.n_layers


def whisper_encode(params: Params, frames: torch.Tensor, cfg: ArchConfig
                   ) -> torch.Tensor:
    """frames: (B, S_enc, d) stub embeddings -> encoder output."""
    x = frames + _sinusoid(frames.shape[1], cfg.d_model,
                           frames.device).to(frames.dtype)
    x = constrain_acts(x)

    def body(h, p):
        hn = _layer_norm(h, p["ln1"], cfg.norm_eps)
        a, _ = attention(p["attn"], hn, cfg, causal=False)
        h = h + a
        h = h + _mlp(p["mlp"], _layer_norm(h, p["ln2"], cfg.norm_eps))
        return constrain_acts(h)

    for p in unstack(params["enc"], _n_enc(cfg)):
        x = remat(body, x, p)
    return _layer_norm(x, params["ln_enc"], cfg.norm_eps)


def _dec_embed(params: Params, tokens: torch.Tensor,
               start: torch.Tensor) -> torch.Tensor:
    """Token embeddings plus learned positions ``start .. start + s``
    (``dynamic_slice`` clamps the start so the slice fits)."""
    s = tokens.shape[1]
    start = torch.clamp(start, 0, params["dec_pos"].shape[0] - s)
    rows = start.to(torch.int64) + torch.arange(s, device=tokens.device)
    return params["tok"][tokens.long()] + params["dec_pos"].index_select(0, rows)


def _decoder_hidden(params: Params, frames: torch.Tensor, tokens: torch.Tensor,
                    cfg: ArchConfig) -> torch.Tensor:
    enc = whisper_encode(params, frames, cfg)
    s = tokens.shape[1]
    x = constrain_acts(params["tok"][tokens.long()] + params["dec_pos"][:s])

    def body(h, p):
        hn = _layer_norm(h, p["ln1"], cfg.norm_eps)
        a, _ = attention(p["self"], hn, cfg, causal=True)
        h = h + a
        c, _ = attention(p["cross"], _layer_norm(h, p["ln2"], cfg.norm_eps),
                         cfg, kv_x=enc, causal=False)
        h = h + c
        h = h + _mlp(p["mlp"], _layer_norm(h, p["ln3"], cfg.norm_eps))
        return constrain_acts(h)

    for p in unstack(params["dec"], cfg.n_layers):
        x = remat(body, x, p)
    return constrain_head(_layer_norm(x, params["ln_dec"], cfg.norm_eps))


def whisper_forward(params: Params, frames: torch.Tensor, tokens: torch.Tensor,
                    cfg: ArchConfig) -> torch.Tensor:
    """Teacher-forced training forward -> decoder logits (B, S_dec, V)."""
    x = _decoder_hidden(params, frames, tokens, cfg)
    # tied unembedding (Whisper ties)
    return constrain_logits(mask_vocab_pad(x @ params["tok"].T, cfg))


def whisper_loss(params, frames, tokens, labels, cfg,
                 ce_chunk: int = 256) -> torch.Tensor:
    """Chunked CE over decoder positions (see :func:`lm.chunked_ce`)."""
    x = _decoder_hidden(params, frames, tokens, cfg)
    return chunked_ce(x, params["tok"].T, labels, cfg, ce_chunk)


def whisper_prefill(params: Params, frames: torch.Tensor, tokens: torch.Tensor,
                    cfg: ArchConfig):
    """Encode + teacher-forced decoder pass that materializes decode state.

    Returns ``(last_logits (B, 1, V), state)`` with ``state`` shaped like
    :func:`init_whisper_decode_state` (self-KV holds the prompt, cross-KV
    is projected once from the encoder output).
    """
    enc = whisper_encode(params, frames, cfg)
    s = tokens.shape[1]
    x = constrain_acts(params["tok"][tokens.long()] + params["dec_pos"][:s])
    sk, sv = [], []
    for p in unstack(params["dec"], cfg.n_layers):
        hn = _layer_norm(x, p["ln1"], cfg.norm_eps)
        a, cache = attention(p["self"], hn, cfg, causal=True, build_cache=True)
        x = x + a
        c, _ = attention(p["cross"], _layer_norm(x, p["ln2"], cfg.norm_eps),
                         cfg, kv_x=enc, causal=False)
        x = x + c
        x = constrain_acts(x + _mlp(p["mlp"],
                                    _layer_norm(x, p["ln3"], cfg.norm_eps)))
        sk.append(cache["k"])
        sv.append(cache["v"])
    ck, cv = precompute_cross_kv(params, enc, cfg)
    x = constrain_head(_layer_norm(x[:, -1:], params["ln_dec"], cfg.norm_eps))
    logits = mask_vocab_pad(x @ params["tok"].T, cfg)
    state = {
        "self_k": torch.stack(sk), "self_v": torch.stack(sv),
        "cross_k": ck, "cross_v": cv,
        "len": torch.full((), s, dtype=torch.int32, device=x.device),
    }
    return logits, state


def precompute_cross_kv(params: Params, enc: torch.Tensor, cfg: ArchConfig):
    """Project the encoder output once: (L, B, S_enc, H, hd) k/v caches."""
    b, s_enc, d = enc.shape
    nh, hd = cfg.n_heads, cfg.hd
    ks, vs = [], []
    for p in unstack(params["dec"], cfg.n_layers):
        ks.append((enc @ p["cross"]["wk"] + p["cross"]["bk"]
                   ).reshape(b, s_enc, nh, hd))
        vs.append((enc @ p["cross"]["wv"] + p["cross"]["bv"]
                   ).reshape(b, s_enc, nh, hd))
    return torch.stack(ks), torch.stack(vs)


def init_whisper_decode_state(cfg: ArchConfig, batch: int, ctx: int, s_enc: int,
                              dtype=torch.bfloat16, device=None):
    nh, hd = cfg.n_heads, cfg.hd
    n_dec = cfg.n_layers

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "self_k": zeros((n_dec, batch, ctx, nh, hd)),
        "self_v": zeros((n_dec, batch, ctx, nh, hd)),
        "cross_k": zeros((n_dec, batch, s_enc, nh, hd)),
        "cross_v": zeros((n_dec, batch, s_enc, nh, hd)),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def _cross_decode(p, x, ck, cv, cfg):
    """q-len-1 cross attention against precomputed (B, S_enc, H, hd) k/v."""
    b, s, d = x.shape
    nh, hd = cfg.n_heads, cfg.hd
    q = (x @ p["wq"] + p["bq"]).reshape(b, s, nh, hd)
    scores = _ein("bsnh,bcnh->bnsc", q, ck.to(q.dtype)) / math.sqrt(hd)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    out = _ein("bnsc,bcnh->bsnh", probs, cv.to(q.dtype)).reshape(b, s, d)
    return out @ p["wo"]


def whisper_decode_step(params: Params, state, token: torch.Tensor,
                        cfg: ArchConfig):
    """One decoder step with self-KV cache + precomputed cross K/V."""
    s = token.shape[1]
    pos = state["len"]
    x = constrain_acts(_dec_embed(params, token, pos))
    positions = pos + torch.arange(s, device=x.device)[None, :]
    nk, nv = [], []
    n = cfg.n_layers
    for p, sk, sv, ck, cv in zip(unstack(params["dec"], n),
                                 torch.unbind(state["self_k"]),
                                 torch.unbind(state["self_v"]),
                                 torch.unbind(state["cross_k"]),
                                 torch.unbind(state["cross_v"])):
        hn = _layer_norm(x, p["ln1"], cfg.norm_eps)
        a, new_cache = attention(p["self"], hn, cfg,
                                 cache={"k": sk, "v": sv, "len": pos},
                                 positions=positions)
        x = x + a
        x = x + _cross_decode(p["cross"], _layer_norm(x, p["ln2"], cfg.norm_eps),
                              ck, cv, cfg)
        x = x + _mlp(p["mlp"], _layer_norm(x, p["ln3"], cfg.norm_eps))
        nk.append(new_cache["k"])
        nv.append(new_cache["v"])
    x = constrain_head(_layer_norm(x, params["ln_dec"], cfg.norm_eps))
    logits = constrain_logits(mask_vocab_pad(x @ params["tok"].T, cfg))
    new_state = {**state, "self_k": torch.stack(nk), "self_v": torch.stack(nv),
                 "len": pos + s}
    return logits, new_state
