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
bit on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["SURROGATE_SLOPE", "LIFParams", "init_lif_params", "spike",
           "lif_step"]

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
        return torch.sigmoid(self.alpha_logit)

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
    v_acc = params.alpha * v + current
    s = spike(v_acc - params.v_th)
    return v_acc - params.theta * s, s
