"""Nested containers of tensors: dicts, lists, tuples and NamedTuples, the
shapes the port's parameters, statics and batches take."""

from __future__ import annotations

from typing import Any, Callable, List

import torch


def tree_map(fn: Callable[[torch.Tensor], Any], tree):
    """``fn`` applied to every tensor; everything else is kept as it is."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def tree_to(tree, device):
    """Every tensor moved to ``device``."""
    return tree_map(lambda x: x.to(device), tree)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree, dict entries in insertion order."""
    leaves: List[torch.Tensor] = []
    tree_map(leaves.append, tree)
    return leaves
