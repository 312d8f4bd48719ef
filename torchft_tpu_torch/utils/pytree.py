"""Pytree flatten/unflatten in JAX's leaf order.

The JAX package flattens state with ``jax.tree_util``; leaf order fixes the
checkpoint wire layout and the in-place receive map, so the port must
produce the same order.  ``torch.utils._pytree`` keeps a dict's insertion
order, while JAX sorts a plain dict's keys (``{'b': 1, 'a': 2}`` flattens to
``[2, 1]`` in JAX and ``[1, 2]`` in torch).  This module follows JAX:

- ``dict`` (and ``defaultdict``): children in sorted key order;
- ``OrderedDict``: children in insertion order;
- ``list``, ``tuple`` and namedtuples: children in order;
- ``None``: a node with no children (not a leaf);
- anything else (tensors, arrays, numbers, strings): a leaf.

The tree definition is a *skeleton*: the same structure with each leaf
replaced by its slot index.  It pickles, so transports ship it as is.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, List, Tuple


def _children(node: Any) -> "Tuple[str, List[Any], Any]":
    """(kind, children, aux) of a container node; kind "" for a leaf."""
    if node is None:
        return "none", [], None
    if isinstance(node, collections.OrderedDict):
        keys = list(node.keys())
        return "odict", [node[k] for k in keys], keys
    if isinstance(node, dict):
        keys = sorted(node.keys())
        return "dict", [node[k] for k in keys], (type(node), keys)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return "namedtuple", list(node), type(node)
    if isinstance(node, (list, tuple)):
        return type(node).__name__, list(node), None
    return "", [], None


def _rebuild(kind: str, aux: Any, children: "List[Any]") -> Any:
    if kind == "none":
        return None
    if kind == "odict":
        return collections.OrderedDict(zip(aux, children))
    if kind == "dict":
        cls, keys = aux
        if cls is dict:
            return dict(zip(keys, children))
        out = cls.__new__(cls)
        dict.update(out, zip(keys, children))
        if isinstance(out, collections.defaultdict):
            out.default_factory = None
        return out
    if kind == "namedtuple":
        return aux(*children)
    if kind == "tuple":
        return tuple(children)
    return list(children)


def tree_flatten(tree: Any) -> "Tuple[List[Any], Any]":
    """Leaves in JAX's order, and the skeleton that restores the tree."""
    leaves: List[Any] = []

    def walk(node: Any) -> Any:
        kind, children, aux = _children(node)
        if not kind:
            leaves.append(node)
            return len(leaves) - 1
        return _rebuild(kind, aux, [walk(c) for c in children])

    skeleton = walk(tree)
    return leaves, skeleton


def tree_unflatten(skeleton: Any, leaves: "List[Any]") -> Any:
    """Inverse of :func:`tree_flatten`: put ``leaves`` back by slot."""

    def walk(node: Any) -> Any:
        kind, children, aux = _children(node)
        if not kind:
            return leaves[node]
        return _rebuild(kind, aux, [walk(c) for c in children])

    return walk(skeleton)


def tree_leaves(tree: Any) -> "List[Any]":
    return tree_flatten(tree)[0]


def tree_map(fn: "Callable[[Any], Any]", tree: Any) -> Any:
    leaves, skeleton = tree_flatten(tree)
    return tree_unflatten(skeleton, [fn(x) for x in leaves])
