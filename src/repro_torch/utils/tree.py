"""Small tree utilities over the port's nested dicts, lists and tuples of
tensors (the JAX package's ``utils/tree.py`` over pytrees). A ``meta``
tensor counts by its shape and dtype, as a ``ShapeDtypeStruct`` does."""
from __future__ import annotations

import math

import torch


def tree_leaves(tree) -> list:
    """The tensors of a nested dict / list / tuple (other leaves dropped:
    None, ints), in insertion order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in tree_leaves(sub)]
    return []


def tree_count(tree) -> int:
    """Total number of elements across all leaves."""
    return sum(math.prod(x.shape) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes across all leaves (shape and dtype; nothing is read)."""
    return sum(math.prod(x.shape) * x.element_size()
               for x in tree_leaves(tree))


def tree_cast(tree, dtype):
    """The tree with every floating-point tensor cast to ``dtype``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: tree_cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_cast(v, dtype) for v in tree)
    return tree
