"""Learned Step Size Quantization (LSQ) for 16-bit fixed-point weights.

Port of ``repro/train/lsq.py`` (paper §IV-C.2; Esser et al., ICLR 2020).
Weights are fake-quantized with a trainable per-tensor step size:
forward and backward simulate the quantization, full-precision master
weights receive the gradients.

``lsq_fake_quant`` is a ``torch.autograd.Function`` that writes out the
reference's forward arithmetic op for op in float32, including the
grad-scale trick ``s = step * g + stop_grad(step * (1 - g))`` (whose
value may differ from ``step`` in the last bit), and its backward is the
reference's chain: straight-through to ``w`` inside the clip range, and
the LSQ step gradient scaled by ``g = 1 / sqrt(N * Q_max)``.
``torch.round`` rounds half to even, like ``jnp.round``.
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["lsq_fake_quant", "init_lsq_scales", "make_serving_quant_fn",
           "quantize_to_int", "dequantize", "STEP_FLOOR"]

STEP_FLOOR = 1e-8  # minimum usable step: keeps w/s finite for all-zero layers
_S_FLOOR = 1e-12   # the fake-quant's guard on the scaled step


def _qrange(bits: int):
    return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1


def _grad_scale(w: torch.Tensor, qmax: int) -> torch.Tensor:
    n = torch.tensor(float(w.numel()), dtype=torch.float32, device=w.device)
    return 1.0 / torch.sqrt(n * qmax)


class _LsqFakeQuant(torch.autograd.Function):

    @staticmethod
    def forward(ctx, w: torch.Tensor, step: torch.Tensor, bits: int):
        qmin, qmax = _qrange(bits)
        step_d = step.to(device=w.device, dtype=torch.float32)
        g = _grad_scale(w, qmax)
        s0 = step_d * g + step_d * (1.0 - g)
        s = torch.clamp_min(s0, _S_FLOOR)
        w_div = w / s
        w_clip = torch.clamp(w_div, qmin, qmax)
        w_q = w_clip + (torch.round(w_clip) - w_clip)
        ctx.save_for_backward(w, s0, s, w_div, w_q, g)
        ctx.bits = bits
        ctx.step_shape = step.shape
        ctx.step_device = step.device
        return w_q * s

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        w, s0, s, w_div, w_q, g = ctx.saved_tensors
        qmin, qmax = _qrange(ctx.bits)
        ct_wq = grad * s                                     # out = w_q * s
        inside = (w_div >= qmin) & (w_div <= qmax)           # clip pass-through
        ct_wdiv = torch.where(inside, ct_wq, torch.zeros_like(ct_wq))
        grad_w = ct_wdiv / s                                 # w_div = w / s
        ct_s = (grad * w_q).sum() + ((-ct_wdiv * w) * (1.0 / (s * s))).sum()
        ct_s0 = torch.where(s0 > _S_FLOOR, ct_s, torch.zeros_like(ct_s))
        grad_step = (ct_s0 * g).reshape(ctx.step_shape).to(ctx.step_device)
        return grad_w, grad_step, None


def lsq_fake_quant(w: torch.Tensor, step, bits: int = 16) -> torch.Tensor:
    """Fake-quantize ``w`` with a trainable per-tensor step size.

    Gradients: straight-through to ``w`` inside the clip range; the LSQ
    gradient (with the grad-scale trick) to ``step``.
    """
    step = torch.as_tensor(step, dtype=torch.float32)
    return _LsqFakeQuant.apply(w, step, bits)


def init_lsq_scales(params: Dict, bits: int = 16) -> Dict:
    """Per-layer initial step size: 2*mean|w| / sqrt(Q_max) (LSQ init),
    floored at :data:`STEP_FLOOR` so an all-zero layer keeps a usable step.
    The float32 mean may differ from the reference's in the last bit
    (a different summation order)."""
    _, qmax = _qrange(bits)

    def init_one(w):
        w = torch.as_tensor(w, dtype=torch.float32).detach()
        s = 2.0 * w.abs().mean() / torch.sqrt(
            torch.tensor(float(qmax), dtype=torch.float32, device=w.device))
        return torch.clamp_min(s, STEP_FLOOR)

    return {
        "conv": [init_one(layer["w"]) for layer in params["conv"]],
        "fc": [init_one(layer["w"]) for layer in params["fc"]],
    }


def make_serving_quant_fn(lsq_scales: Dict, bits: int = 16):
    """Per-layer fake-quant closure for the bind paths.

    The bind walks the weighted layers in graph order (conv then fc), so a
    stateful index hands each layer its own step size.  Returns a fresh
    closure: never share one across compiles.
    """
    flat = list(lsq_scales["conv"]) + list(lsq_scales["fc"])
    idx = {"i": 0}

    def quant_fn(w: torch.Tensor) -> torch.Tensor:
        s = flat[idx["i"] % len(flat)]
        idx["i"] += 1
        return lsq_fake_quant(torch.as_tensor(w), s, bits)

    return quant_fn


def quantize_to_int(w: torch.Tensor, step, bits: int = 16) -> torch.Tensor:
    """Final conversion to integer codes (deployment form)."""
    qmin, qmax = _qrange(bits)
    step = torch.as_tensor(step, dtype=torch.float32, device=w.device)
    codes = torch.clamp(torch.round(w / step), qmin, qmax)
    return codes.to(torch.int16 if bits <= 16 else torch.int32)


def dequantize(codes: torch.Tensor, step) -> torch.Tensor:
    step = torch.as_tensor(step, dtype=torch.float32, device=codes.device)
    return codes.to(torch.float32) * step
