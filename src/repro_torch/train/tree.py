"""Parameter trees: nested dicts, lists and tuples (NamedTuples too) of
tensors, flattened in ``jax.tree.flatten``'s order (dict keys sorted,
sequences in order, ``None`` an empty subtree), the order ``repro``'s
``jax.flatten_util.ravel_pytree`` lays a gradient out in."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from ..runtime.checkpoint import _flatten, _unflatten as tree_unflatten


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.leaves``' order (the walk of
    ``repro_torch.runtime.checkpoint``, so that a checkpoint and a raveled
    gradient lay the leaves out alike)."""
    return _flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``."""
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(tree_leaves(tree),
                                                      *others)])


def ravel(tree: Any) -> Tuple[torch.Tensor, Callable]:
    """``ravel_pytree``: (the leaves raveled and concatenated into one
    vector, the function mapping such a vector back to the tree, each leaf
    in its own dtype)."""
    leaves = tree_leaves(tree)
    shapes = [t.shape for t in leaves]
    dtypes = [t.dtype for t in leaves]
    sizes = [t.numel() for t in leaves]
    flat = torch.cat([t.reshape(-1) for t in leaves]) if leaves else \
        torch.zeros(0)

    def unravel(vec: torch.Tensor) -> Any:
        parts = torch.split(vec, sizes)
        return tree_unflatten(tree, [p.reshape(s).to(d) for p, s, d in
                                     zip(parts, shapes, dtypes)])

    return flat, unravel
