"""Parameter trees: nested dicts, lists and tuples (NamedTuples included)
of tensors, as the port keeps params, optimizer state and train state.

The twin of the ``jax.tree`` calls the reference makes. A dict keeps its
insertion order (the reference's trees sort their keys), so a tree's
leaves come in one fixed order for one structure, which is what a
checkpoint needs. ``None`` is an empty subtree, as in ``jax.tree``.
"""
from __future__ import annotations

from typing import Any, Callable, List


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def leaves(tree: Any) -> List[Any]:
    """Every leaf, depth first."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure), in a tree of ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_tree(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if _is_namedtuple(tree):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)
