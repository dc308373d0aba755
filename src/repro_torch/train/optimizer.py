"""Pytree optimizers (AdamW, SGD with momentum) and gradient clipping.

Port of ``repro/train/optimizer.py``, with its ``(init_fn, update_fn)``
convention.  State has the structure of the params (nested dicts, lists
and :class:`~repro_torch.core.lif.LIFParams` with tensor leaves), walked
in ``jax.tree_util`` order (:mod:`repro_torch.tree`), so a checkpoint of
the state restores in either package.

Each update writes the reference's arithmetic op for op, in float32, on
every leaf: AdamW is ``mu = b1*m + (1-b1)*g``, ``nu = b2*v + (1-b2)*g*g``,
``u = -lr * (mu/bc1 / (sqrt(nu/bc2) + eps) + wd*p)`` with ``bc = 1 -
b**step``.  ``torch.optim.AdamW`` is deliberately not used: it decays
``p *= 1 - lr*wd`` first, divides by ``sqrt(v)/sqrt(bc2) + eps`` and
scales by ``lr/bc1``, a different order that rounds differently.  The
functions here run under ``torch.no_grad()`` in the trainer.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["adamw", "sgd", "clip_by_global_norm", "apply_updates",
           "global_norm", "AdamWState", "SGDState"]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, summed in leaf order."""
    total = 0
    for x in tree_leaves(tree):
        x = x.to(torch.float32)
        total = total + torch.sum(x * x)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to at most ``max_norm`` in global norm, the norm)."""
    norm = global_norm(tree)
    # a tensor quotient: ``float / tensor`` would multiply by a reciprocal
    scale = torch.clamp_max(
        torch.full_like(norm, max_norm) / (norm + 1e-9), 1.0)
    return tree_map(lambda g: g * scale, tree), norm


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _lr_at(lr, step):
    return lr(step) if callable(lr) else lr


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


def _step0(like) -> torch.Tensor:
    leaves = tree_leaves(like)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    mu: Any
    nu: Any


def adamw(
    lr: float | Callable[[torch.Tensor], Any],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Tuple[Callable, Callable]:
    """Returns ``(init_fn, update_fn)``; ``update_fn(grads, state, params)
    -> (updates, state)``."""

    def init_fn(params) -> AdamWState:
        return AdamWState(step=_step0(params), mu=tree_map(_zeros, params),
                          nu=tree_map(_zeros, params))

    def update_fn(grads, state: AdamWState, params):
        step = state.step + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                      state.mu, grads)

        def second(v, g):
            g = g.to(torch.float32)
            return b2 * v + (1 - b2) * (g * g)

        nu = tree_map(second, state.nu, grads)
        step_f = step.to(torch.float32)
        bc1 = 1 - torch.pow(b1, step_f)
        bc2 = 1 - torch.pow(b2, step_f)
        lr_t = _lr_at(lr, step)

        def upd(m, v, p):
            mhat = m / bc1
            vhat = v / bc2
            u = -lr_t * (mhat / (torch.sqrt(vhat) + eps)
                         + weight_decay * p.to(torch.float32))
            return u.to(p.dtype)

        return tree_map(upd, mu, nu, params), AdamWState(step=step, mu=mu, nu=nu)

    return init_fn, update_fn


class SGDState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    momentum: Any


def sgd(
    lr: float | Callable[[torch.Tensor], Any],
    momentum: float = 0.9,
    nesterov: bool = False,
) -> Tuple[Callable, Callable]:
    """Returns ``(init_fn, update_fn)``; ``update_fn(grads, state, params=None)
    -> (updates, state)``."""

    def init_fn(params) -> SGDState:
        return SGDState(step=_step0(params), momentum=tree_map(_zeros, params))

    def update_fn(grads, state: SGDState, params=None):
        step = state.step + 1
        buf = tree_map(lambda b, g: momentum * b + g.to(torch.float32),
                       state.momentum, grads)
        lr_t = _lr_at(lr, step)
        if nesterov:
            updates = tree_map(
                lambda g, b: -lr_t * (g.to(torch.float32) + momentum * b),
                grads, buf)
        else:
            updates = tree_map(lambda b: -lr_t * b, buf)
        return updates, SGDState(step=step, momentum=buf)

    return init_fn, update_fn
