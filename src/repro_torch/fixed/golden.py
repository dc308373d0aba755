"""Pure-NumPy golden reference for the fixed-point datapath.

A copy of the reference's ``repro/fixed/golden.py``, the independent
oracle of the port's integer tier: a tiny interpreter that executes the
FPGA datapath op-for-op — int32 gated accumulation, arithmetic-shift leak
and accumulator scaling, strict threshold compare, soft reset, saturating
int16 membrane write-back, integer Q0.15 Sigma-Delta front end — in numpy
only.  The ``fixed`` backend's torch cells
(:mod:`repro_torch.fixed.backend`) must agree with it to the bit, on the
CPU and on the card.

Offline conversion (float -> codes/shifts/thresholds) is shared with the
backend via :mod:`repro_torch.fixed.quantize` on purpose: a shared conversion
makes any disagreement a runtime *datapath* divergence, which is exactly
what the golden exists to catch.

All integer ops here use wrap-around int32 semantics (NumPy matmul of
int32 operands accumulates in int32; ``>>`` on signed ints is an
arithmetic shift).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.fixed.encoder import ENC_HALF, ENC_ONE
from repro_torch.fixed.quantize import (
    I16_MAX,
    I16_MIN,
    FixedLIF,
    derive_fixed_layer,
    fixed_logit_scale,
    lif_to_fixed,
)
from repro_torch.models.graph import (
    KIND_CONV,
    KIND_FC,
    KIND_POOL,
    KIND_READOUT,
    build_layer_graph,
)

__all__ = ["GoldenNet", "build_golden", "golden_lif_step",
           "golden_normalize_iq", "golden_sigma_delta_encode",
           "golden_encode_frames"]


# ---------------------------------------------------------------------------
# Integer Sigma-Delta front end (mirrors fixed/encoder.py bit for bit).
# ---------------------------------------------------------------------------

def golden_normalize_iq(iq: np.ndarray) -> np.ndarray:
    """float32 max-abs AGC, identical operation order to normalize_iq."""
    iq = np.asarray(iq, np.float32)
    peak = np.max(np.abs(iq), axis=(-2, -1), keepdims=True)
    return np.float32(0.5) * (iq / (peak + np.float32(1e-8)) + np.float32(1.0))


def golden_sigma_delta_encode(x: np.ndarray, osr: int) -> np.ndarray:
    """x (...,) float32 in [0, 1] -> bits (osr, ...) int32 in {0, 1}."""
    xq = np.round(np.asarray(x, np.float32) * np.float32(ENC_ONE)).astype(np.int32)
    integ = np.zeros_like(xq)
    y = np.zeros_like(xq)
    bits = np.empty((osr,) + xq.shape, np.int32)
    for t in range(osr):
        integ = integ + xq - y * np.int32(ENC_ONE)
        y = (integ >= ENC_HALF).astype(np.int32)
        bits[t] = y
    return bits


def golden_encode_frames(iq: np.ndarray, osr: int) -> np.ndarray:
    """(..., 2, L) float I/Q -> (T=osr, ..., 2, L) int32 spike frames."""
    return golden_sigma_delta_encode(golden_normalize_iq(iq), osr)


# ---------------------------------------------------------------------------
# Integer LIF + layer interpreter.
# ---------------------------------------------------------------------------

def golden_lif_step(v16: np.ndarray, acc32: np.ndarray, flif: FixedLIF):
    """One integer LIF update (NumPy mirror of backend.fixed_lif_step)."""
    v32 = v16.astype(np.int32)
    v_dec = v32 - (v32 >> flif.leak_shift)
    v_acc = v_dec + (acc32 >> np.int32(flif.acc_shift))
    s = (v_acc > flif.vth).astype(np.int32)
    v_next = np.clip(v_acc - flif.theta * s, I16_MIN, I16_MAX).astype(np.int16)
    return v_next, s


def _shift_buffer(ifm: np.ndarray, kw: int) -> np.ndarray:
    """(IC, WI) -> X'(IC*KW, OI), row ic*KW+ci holds I[ic] shifted by ci."""
    ic, wi = ifm.shape
    oi = wi - kw + 1
    idx = np.arange(kw)[:, None] + np.arange(oi)[None, :]
    return ifm[:, idx].reshape(ic * kw, oi)


def _pad_same(x: np.ndarray, kw: int) -> np.ndarray:
    left = (kw - 1) // 2
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(left, kw - 1 - left)])


@dataclasses.dataclass
class _Layer:
    kind: str
    kw: int = 0
    pool: int = 0
    wmat: Optional[np.ndarray] = None   # conv: (OC, IC*KW); fc: (DIN, DOUT)
    oc: int = 0
    flif: Optional[FixedLIF] = None
    use_current: bool = False


@dataclasses.dataclass
class GoldenNet:
    """The built golden model: layers + the logit dequantization scale."""

    layers: List[_Layer]
    timesteps: int
    logit_scale: float

    def forward(self, frames: np.ndarray) -> np.ndarray:
        """(T, IC0, W) binary frames -> int32 logits."""
        frames = np.asarray(frames).astype(np.int32)
        states: List = []
        for layer in self.layers:
            states.append(None)
        acc = None
        for t in range(frames.shape[0]):
            x = frames[t]
            for i, layer in enumerate(self.layers):
                if layer.kind == KIND_CONV:
                    if states[i] is None:
                        states[i] = np.zeros((layer.oc, x.shape[-1]), np.int16)
                    cur = layer.wmat @ _shift_buffer(
                        _pad_same(x, layer.kw), layer.kw).astype(np.int32)
                    states[i], x = golden_lif_step(states[i], cur, layer.flif)
                elif layer.kind == KIND_POOL:
                    c, w = x.shape
                    w2 = (w // layer.pool) * layer.pool
                    x = x[:, :w2].reshape(c, w2 // layer.pool, layer.pool).max(axis=-1)
                elif layer.kind == KIND_FC:
                    if states[i] is None:
                        states[i] = np.zeros((layer.wmat.shape[1],), np.int16)
                    s_in = x[0] if isinstance(x, tuple) else x  # _spikes_of
                    s_in = s_in.reshape(-1).astype(np.int32)
                    cur = s_in @ layer.wmat
                    states[i], spikes = golden_lif_step(states[i], cur, layer.flif)
                    x = (spikes, cur)
                elif layer.kind == KIND_READOUT:
                    spikes_t, cur_t = x
                    inc = cur_t if layer.use_current else spikes_t
                    acc = inc.copy() if acc is None else acc + inc
                    x = spikes_t
        return np.asarray(acc, np.int32)

    def forward_iq(self, iq: np.ndarray) -> np.ndarray:
        """(2, L) float I/Q -> int32 logits via the integer encoder."""
        return self.forward(golden_encode_frames(np.asarray(iq),
                                                 self.timesteps))


def build_golden(cfg, params, masks=None, quant_fn=None) -> GoldenNet:
    """Build the golden model from float params (+ optional masks/LSQ).

    Uses the same offline conversion as the fixed backend.  When
    ``quant_fn`` is a stateful fake-quant closure it is consumed in graph
    order exactly like a bind — pass a **fresh** FixedQuantFn, never one
    already used for a backend bind.
    """
    layers: List[_Layer] = []
    for spec in build_layer_graph(cfg):
        if spec.kind == KIND_CONV:
            lp = params["conv"][spec.index]
            m = masks["conv"][spec.index] if masks else None
            ql = derive_fixed_layer("conv", spec.index, lp["w"], mask=m,
                                    quant_fn=quant_fn)
            wmat = np.transpose(ql.codes, (2, 1, 0)).reshape(
                spec.oc, -1).astype(np.int32)
            layers.append(_Layer(kind=spec.kind, kw=spec.kw, oc=spec.oc,
                                 wmat=wmat,
                                 flif=lif_to_fixed(lp["lif"], ql.step)))
        elif spec.kind == KIND_POOL:
            layers.append(_Layer(kind=spec.kind, pool=spec.pool))
        elif spec.kind == KIND_FC:
            lp = params["fc"][spec.index]
            m = masks["fc"][spec.index] if masks else None
            ql = derive_fixed_layer("fc", spec.index, lp["w"], mask=m,
                                    quant_fn=quant_fn)
            layers.append(_Layer(kind=spec.kind,
                                 wmat=ql.codes.astype(np.int32),
                                 flif=lif_to_fixed(lp["lif"], ql.step)))
        elif spec.kind == KIND_READOUT:
            layers.append(_Layer(kind=spec.kind,
                                 use_current=spec.mode == "current_sum"))
    # note: scale uses the *stateless* step lookup, so it does not disturb
    # the quant_fn's layer-order index
    scale = fixed_logit_scale(
        params, cfg, masks=masks,
        quant_fn=quant_fn if hasattr(quant_fn, "step_for") else None)
    return GoldenNet(layers=layers, timesteps=cfg.timesteps, logit_scale=scale)
