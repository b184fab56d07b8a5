"""Error-feedback int8 gradient compression for the slow (inter-pod) hop.

Ported from ``repro.train.compression``.  ``compress(g)`` -> (int8
payload, fp32 scale), ``decompress`` reverses, and ``ef_compress_tree``
applies it leafwise with the residual carried to the next step (1-bit
Adam / EF-SGD lineage), so the compression stays unbiased over time.  The
trainer keeps ``residual`` in the train state when compression is on.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .tree import tree_leaves, tree_map, tree_unflatten


def compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress_tree(grads, residual):
    """Error-feedback compression leafwise: (the decompressed grads the
    optimizer sees, the new residual)."""

    def one(g, r):
        gf = g.to(torch.float32) + r
        q, s = compress(gf)
        deq = decompress(q, s)
        return deq.to(g.dtype), gf - deq

    out = [one(g, r) for g, r in zip(tree_leaves(grads),
                                     tree_leaves(residual))]
    return (tree_unflatten(grads, [t[0] for t in out]),
            tree_unflatten(grads, [t[1] for t in out]))


def init_residual(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
