"""Nested containers in ``jax.tree``'s order (the port's stand-in for
``jax.tree``, which the optimizer, the train step and the checkpoint
walk the same way).

Nodes are dicts (keys sorted), lists, tuples, NamedTuples (fields in
order) and ``None``; anything else is a leaf.  :func:`flatten` also
gives the structure as JAX prints it inside ``PyTreeDef(...)``: a
NamedTuple is ``CustomNode(namedtuple[Name], [...])``.
"""

from __future__ import annotations

__all__ = ["flatten", "unflatten", "leaves", "map", "rebuild"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def rebuild(like, items):
    """A list, tuple or NamedTuple of ``like``'s type holding ``items``."""
    return type(like)(*items) if _is_namedtuple(like) else type(like)(items)


def _flatten(tree, out: list) -> str:
    if tree is None:
        return "None"
    if type(tree) is dict:
        return "{" + ", ".join(f"{k!r}: {_flatten(tree[k], out)}"
                               for k in sorted(tree)) + "}"
    if type(tree) is list:
        return "[" + ", ".join(_flatten(x, out) for x in tree) + "]"
    if _is_namedtuple(tree):
        inner = ", ".join(_flatten(x, out) for x in tree)
        return f"CustomNode(namedtuple[{type(tree).__name__}], [{inner}])"
    if type(tree) is tuple:
        inner = [_flatten(x, out) for x in tree]
        return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") + ")"
    out.append(tree)
    return "*"


def flatten(tree) -> tuple[list, str]:
    """→ (leaves in ``jax.tree.flatten`` order, ``str(treedef)``)."""
    out: list = []
    return out, f"PyTreeDef({_flatten(tree, out)})"


def leaves(tree) -> list:
    return flatten(tree)[0]


def unflatten(like, it):
    """``like``'s structure filled from the iterator ``it`` of leaves."""
    if like is None:
        return None
    if type(like) is dict:
        return {k: unflatten(like[k], it) for k in sorted(like)}
    if type(like) is list or isinstance(like, tuple):
        return rebuild(like, [unflatten(x, it) for x in like])
    return next(it)


def map(fn, tree, *rest):   # noqa: A001 - jax.tree.map's name
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``
    (same structure) → a tree shaped like ``tree``."""
    cols = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees of different structure")
    return unflatten(tree, iter([fn(*xs) for xs in zip(*cols)]))
