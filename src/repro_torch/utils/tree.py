"""Size helpers over the port's parameter collections (a state dict, a dict
of tensors or a list of them): the JAX package's ``utils/tree.py``."""
from __future__ import annotations

import torch


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def tree_size(tree) -> int:
    """Total number of elements."""
    return sum(t.numel() for t in _leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes at the tensors' dtypes."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def tree_summary(tree, name: str = "tree") -> str:
    n = tree_size(tree)
    b = tree_bytes(tree)
    return f"{name}: {n / 1e6:.2f}M params, {b / 2**30:.3f} GiB"
