"""Leaky integrate-and-fire neuron dynamics (paper §IV-B, eq. (3)).

Hardware write-back convention, as in the reference (``repro/core/lif.py``):

    v_acc  = alpha * v + current
    s      = H(v_acc - v_th)          (strict >)
    v_next = v_acc - theta * s        (soft reset at fire time)

``alpha = sigmoid(alpha_logit)`` keeps the decay in (0, 1).  The spike is a
Heaviside step whose backward pass is the fast-sigmoid surrogate
``1 / (1 + k|u|)^2`` with ``k = SURROGATE_SLOPE``.

Rounding: eager torch rounds ``alpha * v`` and ``+ current`` separately
(no fused multiply-add); the CUDA kernels write the same update with
``__fmul_rn``/``__fadd_rn`` so that kernel and plain version agree bit for
bit on the card.  In bf16 every op rounds to bf16 on its own, which is
what the reference computes on the CPU (under ``lax.scan`` and in its
Pallas kernel's interpret mode alike; ``tests/test_torch_bf16.py``).

Dtypes follow torch's promotion, which agrees with the reference's here:
bf16 params (``init_snn(dtype=torch.bfloat16)``) against an f32 membrane
give f32, and against a bf16 membrane bf16.  (A 0-d f32 tensor would not
promote a bf16 one in torch, where jax promotes; none enters these ops.)
The decay's value is the reference's too: :meth:`LIFParams.alpha_for`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["SURROGATE_SLOPE", "LIFParams", "init_lif_params", "spike",
           "lif_step", "lif_unroll"]

SURROGATE_SLOPE = 4.0  # k in 1 / (1 + k|u|)^2


class _Spike(torch.autograd.Function):
    """Heaviside spike with fast-sigmoid surrogate gradient."""

    @staticmethod
    def forward(ctx, u: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(u)
        return (u > 0).to(u.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (u,) = ctx.saved_tensors
        # the reference's order: g times the surrogate (a quotient of g
        # would round differently)
        return g * (1.0 / (1.0 + SURROGATE_SLOPE * u.abs()) ** 2)


def spike(v_minus_th: torch.Tensor) -> torch.Tensor:
    return _Spike.apply(v_minus_th)


@dataclasses.dataclass
class LIFParams:
    """Per-neuron (or per-channel, broadcast) trainable LIF parameters."""

    alpha_logit: torch.Tensor  # sigmoid(alpha_logit) = decay in (0, 1)
    theta: torch.Tensor        # soft-reset amount
    v_th: torch.Tensor         # firing threshold

    @property
    def alpha(self) -> torch.Tensor:
        """sigmoid(alpha_logit) in the logit's dtype.  In bf16 it is the
        reference's ``1 / (1 + exp(-x))`` with every op rounded to bf16
        (``torch.sigmoid`` rounds once, which differs in about a third of
        bf16 logits)."""
        x = self.alpha_logit
        if x.dtype == torch.bfloat16:
            return 1.0 / (1.0 + torch.exp(-x))
        return torch.sigmoid(x)

    def alpha_for(self, dtype: torch.dtype) -> torch.Tensor:
        """alpha as the reference applies it to a membrane of ``dtype``.

        bf16 parameters against an f32 membrane are promoted inside the
        reference's traced step, where XLA keeps the sigmoid's last divide
        in f32: ``1 / bf16(1 + bf16(exp(-x)))`` unrounded.  Everywhere else
        it is :attr:`alpha`."""
        x = self.alpha_logit
        if x.dtype == torch.bfloat16 and dtype == torch.float32:
            return 1.0 / (1.0 + torch.exp(-x)).float()
        return self.alpha

    def to(self, device) -> "LIFParams":
        return LIFParams(self.alpha_logit.to(device), self.theta.to(device),
                         self.v_th.to(device))


def init_lif_params(shape: Tuple[int, ...], alpha: float = 0.9,
                    theta: float = 1.0, v_th: float = 1.0,
                    dtype=torch.float32) -> LIFParams:
    alpha = min(max(alpha, 1e-4), 1 - 1e-4)
    logit = torch.log(torch.tensor(alpha / (1.0 - alpha), dtype=dtype))
    return LIFParams(alpha_logit=torch.full(shape, float(logit), dtype=dtype),
                     theta=torch.full(shape, theta, dtype=dtype),
                     v_th=torch.full(shape, v_th, dtype=dtype))


def lif_step(v: torch.Tensor, current: torch.Tensor, params: LIFParams
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LIF update; returns ``(v_next, s)``.  Params broadcast."""
    v_acc = params.alpha_for(v.dtype) * v + current
    s = spike(v_acc - params.v_th)
    return v_acc - params.theta * s, s


def lif_unroll(currents: torch.Tensor, params: LIFParams,
               v0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LIF over a leading time axis: currents (T, ...) -> (spikes (T, ...),
    final v); the state starts at zero in the currents' dtype."""
    v = torch.zeros_like(currents[0]) if v0 is None else v0
    spikes = []
    for c in currents:
        v, s = lif_step(v, c, params)
        spikes.append(s)
    return torch.stack(spikes), v
