"""Nested state walked in ``jax.tree_util`` order.

The reference keeps params, optimizer state, masks and LSQ scales as jax
pytrees; the port keeps the same nesting with torch leaves.  The
optimizer, the gradient clip and the checkpoints walk that nesting in the
order ``jax.tree_util.tree_flatten`` gives the reference's pytrees, so a
norm sums its leaves in the reference's order and one checkpoint
directory restores in either package:

* a dict: its values by sorted key (``"lif"`` before ``"w"``);
* a list or tuple: in order; a NamedTuple (``AdamWState``) by field;
* :class:`~repro_torch.core.lif.LIFParams`: ``(alpha_logit, theta, v_th)``;
* ``None``: no leaves;
* anything else (a tensor, an array, a number): one leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List

from repro_torch.core.lif import LIFParams

__all__ = ["tree_leaves", "tree_unflatten", "tree_map"]


def _lif_fields(p: LIFParams):
    return (p.alpha_logit, p.theta, p.v_th)


def _walk(node, out: List[Any]) -> None:
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], out)
    elif isinstance(node, LIFParams):
        out.extend(_lif_fields(node))
    elif isinstance(node, (list, tuple)):
        for child in node:
            _walk(child, out)
    else:
        out.append(node)


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree_util`` order."""
    out: List[Any] = []
    _walk(tree, out)
    return out


def _build(node, it: Iterator[Any]):
    if node is None:
        return None
    if isinstance(node, dict):
        built = {k: _build(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}
    if isinstance(node, LIFParams):
        return LIFParams(next(it), next(it), next(it))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_build(child, it) for child in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_build(child, it) for child in node)
    return next(it)


def tree_unflatten(like, leaves) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (in leaf order)."""
    leaves = list(leaves)
    it = iter(leaves)
    try:
        tree = _build(like, it)
    except StopIteration:
        raise ValueError(f"{len(leaves)} leaves are too few for the "
                         "structure") from None
    if next(it, it) is not it:
        raise ValueError(f"{len(leaves)} leaves are too many for the "
                         "structure")
    return tree


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of same-shaped ``rest``."""
    leaves = tree_leaves(tree)
    others = [tree_leaves(r) for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError(f"tree_map over trees of {len(leaves)} and "
                             f"{len(o)} leaves")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(leaves, *others)])
