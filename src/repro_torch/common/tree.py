"""Small utilities over nested dicts and lists of tensors (the port's
pytrees), counterparts of the reference's ``common/tree.py``."""
from __future__ import annotations

import torch


def tree_leaves(tree):
    """The tensors of a nested dict/list/tuple, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` on every leaf; dicts, lists and tuples keep their structure
    (a NamedTuple its type)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_zip_map(fn, tree, *others):
    """``fn(leaf, *leaves of others)`` over ``tree``'s dicts; ``others``
    mirror its dict structure (their leaves may be anything, e.g. an int8
    moment pair)."""
    if isinstance(tree, dict):
        return {k: tree_zip_map(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    return fn(tree, *others)


def tree_count(tree) -> int:
    """Total number of parameters in a tree."""
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_cast(tree, dtype):
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)
