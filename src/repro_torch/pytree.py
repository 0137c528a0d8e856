"""Nested containers of tensors: the flatten, map and path helpers that the
training path and checkpoints share (the port's counterpart of the few
``jax.tree_util`` calls the reference makes).

A tree is a dict (flattened in sorted key order, as JAX does), a NamedTuple
(field order), a tuple or list, ``None`` (no leaves), or a node type
registered with ``register_node``; anything else is a leaf.  A path is JAX's
``keystr`` of each key joined by ``/``: ``[0]``, ``.params``, ``['embed']``
and, for a registered node's children, ``[<flat index i>]``.  Checkpoints of
both packages name their leaves by these paths.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

_NODES: dict = {}     # type -> (flatten, unflatten)


def register_node(cls, flatten: Callable, unflatten: Callable) -> None:
    """Make ``cls`` a node: ``flatten(x)`` gives (children, aux), where aux
    is what is static (JAX's aux data), and ``unflatten(aux, children)``
    makes a like node of new children."""
    _NODES[cls] = (flatten, unflatten)


def _node(x):
    """(keys, children, rebuild) of a node, or None for a leaf.  ``rebuild``
    holds only what is static (keys, a type, aux data): never ``x`` or its
    leaves, so a rebuild function kept alive keeps no tensor alive."""
    if isinstance(x, dict):
        keys = sorted(x)
        return ([f"[{k!r}]" for k in keys], [x[k] for k in keys],
                lambda ch: dict(zip(keys, ch)))
    cls = type(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return [f".{f}" for f in x._fields], list(x), lambda ch: cls(*ch)
    if isinstance(x, (tuple, list)):
        return [f"[{i}]" for i in range(len(x))], list(x), lambda ch: cls(ch)
    if x is None:
        return [], [], lambda ch: None
    if cls in _NODES:
        flatten, unflatten = _NODES[cls]
        children, aux = flatten(x)
        children = list(children)
        return ([f"[<flat index {i}>]" for i in range(len(children))], children,
                lambda ch: unflatten(aux, ch))
    return None


def _walk(x, prefix: list, is_leaf, paths: list, leaves: list):
    """Append x's leaves and their paths; return x's rebuild function (a
    module-level recursion: a nested one would close over itself and the
    leaves, a reference cycle that keeps every leaf alive until Python's
    cyclic collector runs)."""
    node = None if is_leaf is not None and is_leaf(x) else _node(x)
    if node is None:
        paths.append("/".join(prefix))
        leaves.append(x)
        return next
    keys, children, rebuild = node
    subs = [_walk(c, prefix + [k], is_leaf, paths, leaves) for k, c in zip(keys, children)]
    return lambda it: rebuild([s(it) for s in subs])


def flatten_with_paths(tree: Any, is_leaf: Optional[Callable] = None):
    """(paths, leaves, unflatten): the leaves in JAX's order, their paths,
    and a function that rebuilds the tree from a list of new leaves."""
    paths, leaves = [], []
    build = _walk(tree, [], is_leaf, paths, leaves)
    return paths, leaves, lambda new: build(iter(new))


def flatten(tree: Any, is_leaf: Optional[Callable] = None):
    """(leaves, unflatten)."""
    _, leaves, unflatten = flatten_with_paths(tree, is_leaf)
    return leaves, unflatten


def leaves(tree: Any, is_leaf: Optional[Callable] = None) -> list:
    return flatten(tree, is_leaf)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Optional[Callable] = None) -> Any:
    """``fn`` over the leaves of ``tree`` and, leaf for leaf, of ``rest``
    (trees of the same structure)."""
    flat, unflatten = flatten(tree, is_leaf)
    others = [leaves(r, is_leaf) for r in rest]
    if any(len(o) != len(flat) for o in others):
        raise ValueError("trees of different structure")
    return unflatten([fn(*xs) for xs in zip(flat, *others)])
