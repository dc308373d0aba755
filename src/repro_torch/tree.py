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

``is_leaf`` (as in ``jax.tree_util``) stops the walk at a node it accepts,
so a tuple-valued leaf (a sharding spec) stays one leaf.  A leaf's path
(:func:`tree_leaves_with_path`) spells the keys that
``jax.tree_util.tree_map_with_path`` gives: a dict key, a sequence index,
a NamedTuple or ``LIFParams`` field name.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple

from repro_torch.core.lif import LIFParams

__all__ = ["tree_leaves", "tree_leaves_with_path", "tree_unflatten",
           "tree_map"]

IsLeaf = Optional[Callable[[Any], bool]]
_LIF_FIELDS = ("alpha_logit", "theta", "v_th")


def _walk(node, out: List[Any], path: Tuple[str, ...], is_leaf: IsLeaf) -> None:
    if is_leaf is not None and is_leaf(node):
        out.append((path, node))
    elif node is None:
        return
    elif isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], out, path + (str(k),), is_leaf)
    elif isinstance(node, LIFParams):
        out.extend((path + (f,), getattr(node, f)) for f in _LIF_FIELDS)
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for f, child in zip(node._fields, node):
            _walk(child, out, path + (f,), is_leaf)
    elif isinstance(node, (list, tuple)):
        for i, child in enumerate(node):
            _walk(child, out, path + (str(i),), is_leaf)
    else:
        out.append((path, node))


def tree_leaves_with_path(tree, is_leaf: IsLeaf = None
                          ) -> List[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` pairs in ``jax.tree_util`` order; ``path`` is the
    tuple of keys from the root (joined by ``"/"`` in the reference's
    sharding rules)."""
    out: List[Any] = []
    _walk(tree, out, (), is_leaf)
    return out


def tree_leaves(tree, is_leaf: IsLeaf = None) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree_util`` order."""
    return [leaf for _, leaf in tree_leaves_with_path(tree, is_leaf)]


def _build(node, it: Iterator[Any], is_leaf: IsLeaf):
    if is_leaf is not None and is_leaf(node):
        return next(it)
    if node is None:
        return None
    if isinstance(node, dict):
        built = {k: _build(node[k], it, is_leaf) for k in sorted(node)}
        return {k: built[k] for k in node}
    if isinstance(node, LIFParams):
        return LIFParams(next(it), next(it), next(it))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_build(child, it, is_leaf) for child in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_build(child, it, is_leaf) for child in node)
    return next(it)


def tree_unflatten(like, leaves, is_leaf: IsLeaf = None) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (in leaf order)."""
    leaves = list(leaves)
    it = iter(leaves)
    try:
        tree = _build(like, it, is_leaf)
    except StopIteration:
        raise ValueError(f"{len(leaves)} leaves are too few for the "
                         "structure") from None
    if next(it, it) is not it:
        raise ValueError(f"{len(leaves)} leaves are too many for the "
                         "structure")
    return tree


def tree_map(fn: Callable, tree, *rest, is_leaf: IsLeaf = None) -> Any:
    """``fn`` over the leaves of ``tree`` and of same-shaped ``rest``."""
    leaves = tree_leaves(tree, is_leaf)
    others = [tree_leaves(r, is_leaf) for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError(f"tree_map over trees of {len(leaves)} and "
                             f"{len(o)} leaves")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(leaves, *others)],
                          is_leaf)
