"""Nested containers of tensors: the port's counterpart of ``jax.tree``.

A tree is a dict, list, tuple or NamedTuple of trees, or a leaf (a tensor
or a Python number); ``None`` is an empty subtree, as in JAX.  Paths join
dict keys, list indices and NamedTuple field names with ``/`` -- the
reference checkpoint's key format (``checkpoint/manager.py::_key_str``).
``is_leaf`` stops the walk at a container it accepts (a sharding spec is
a plain tuple: ``sharding.rules.is_spec``), as ``jax.tree``'s does.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    raise TypeError(f"not a container: {type(tree).__name__}")


def _is_leaf(tree) -> bool:
    return not isinstance(tree, (dict, list, tuple))


def flatten_with_paths(tree, prefix: str = "", *,
                       is_leaf: Optional[Callable] = None
                       ) -> List[Tuple[str, Any]]:
    """Leaves in a fixed order, each with its path."""
    if tree is None:
        return []
    if _is_leaf(tree) or (is_leaf is not None and is_leaf(tree)):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key, child in _children(tree):
        out.extend(flatten_with_paths(
            child, f"{prefix}/{key}" if prefix else key, is_leaf=is_leaf))
    return out


def leaves(tree, *, is_leaf: Optional[Callable] = None) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree, is_leaf=is_leaf)]


def unflatten(like, new_leaves, *, is_leaf: Optional[Callable] = None
              ) -> Any:
    """A tree shaped like ``like`` holding ``new_leaves`` in the order of
    ``leaves(like)``."""
    it: Iterator = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if _is_leaf(t) or (is_leaf is not None and is_leaf(t)):
            return next(it)
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if _is_namedtuple(t):
            return type(t)(*[build(v) for v in t])
        return type(t)(build(v) for v in t)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map_tree(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None
             ) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure (the
    structure of ``tree``; ``is_leaf`` applies to every tree)."""
    cols = [leaves(t, is_leaf=is_leaf) for t in (tree, *rest)]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees differ in structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)], is_leaf=is_leaf)
