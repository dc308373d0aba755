"""Activation-sharding constraint context.

Port of ``repro/distributed/ctx.py``.  The reference's models call
:func:`constrain_acts` / :func:`constrain_logits` (and the other
``constrain_*``) at the canonical cut points (post-embedding, between
layers, pre-unembedding); inside ``activation_constraints(...)`` they
apply ``jax.lax.with_sharding_constraint`` with the registered specs, so
XLA's sharding propagation cannot drift layer by layer.

The port has no GSPMD: nothing propagates shardings through a PyTorch
program, and a tensor lives on the one device it was made on.  So here
:func:`activation_constraints` keeps the same context stack and
:func:`current_act_sharding` returns what was registered, while every
``constrain_*`` returns its input unchanged, inside a context or not.
The port's models call them at the reference's cut points all the same,
so the cut points stay where a later sharded runner would hook in.
"""
from __future__ import annotations

import contextlib

__all__ = [
    "activation_constraints",
    "constrain_acts",
    "constrain_logits",
    "constrain_head",
    "current_act_sharding",
]

_STACK: list = []  # (act_sharding, logits_sharding, head_sharding)


@contextlib.contextmanager
def activation_constraints(act_sharding=None, logits_sharding=None,
                           head_sharding=None):
    """Register shardings for the residual stream, the logits, and the
    pre-unembedding residual (``head``) for the ``with`` block; any may be
    ``None``.  They are recorded only (see the module docstring)."""
    _STACK.append((act_sharding, logits_sharding, head_sharding))
    try:
        yield
    finally:
        _STACK.pop()


def current_act_sharding():
    return _STACK[-1][0] if _STACK else None


def constrain_acts(x):
    """The residual stream (batch, seq, d_model), unchanged."""
    return x


def constrain_logits(x):
    """The logits (batch, seq, vocab), unchanged."""
    return x


def constrain_head(x):
    """The pre-unembedding residual (batch, seq, d_model), unchanged."""
    return x


def constrain_expert(x, e_axis: int):
    """An MoE dispatch tensor with its expert dim at ``e_axis``, unchanged."""
    return x


def constrain_seq_gathered(x):
    """A (B, S, ...) tensor the reference replicates over the model axis
    (K/V before KV-chunked attention), unchanged."""
    return x


def constrain_hidden(x):
    """A (B, S, hidden) stream whose last dim the reference shards over
    the model axis (an RG-LRU / MLP inner stream), unchanged."""
    return x
