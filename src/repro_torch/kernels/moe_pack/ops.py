"""Public MoE pack / combine ops: input validation and dispatch.

Both ops validate their operands the same way whatever the device, so the
plain version and the CUDA kernel reject malformed input alike, and they
follow one index rule on both: an index outside the row table (negative, or
at or past its last row) reads a zero row; no index raises.  CPU tensors go
to :mod:`.ref`, CUDA tensors to the kernels in :mod:`.cuda`.  Unlike the
Pallas wrappers these need no padding: the kernels cover ragged row counts
and widths themselves.
"""
from __future__ import annotations

import torch

from .. import use_kernel
from . import cuda
from .ref import combine_lanes_ref, combine_rows_ref, gather_rows_ref

_INDEX = (torch.int32, torch.int64)


def _int32(idx: torch.Tensor, rows: int) -> torch.Tensor:
    """The kernels' int32 indices: an int64 index is first clamped to
    ``[-1, rows]``, so that one outside int32 stays outside the table."""
    if idx.dtype == torch.int64:
        idx = idx.clamp(-1, rows)
    return idx.to(torch.int32).contiguous()


def pack(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K5: ``out[i] = x[idx[i]]``; an index outside ``[0, N)`` gives a zero
    row (the MoE layer still points its pads at a zero row it appends)."""
    if x.dim() != 2 or idx.dim() != 1 or idx.dtype not in _INDEX:
        raise ValueError(f"pack: x {tuple(x.shape)} / idx {tuple(idx.shape)} "
                         f"{idx.dtype}: expected [N, D] and an int [M]")
    if use_kernel(x, idx):
        return cuda.gather_rows(x.contiguous(), _int32(idx, x.shape[0]))
    return gather_rows_ref(x, idx)


def combine(buf: torch.Tensor, idx: torch.Tensor,
            w: torch.Tensor) -> torch.Tensor:
    """K6 as ``repro``'s ``combine_rows``: ``out[t] = sum_k w[t, k] *
    buf[idx[t, k]]`` in float32, cast to ``buf``'s dtype; a gather, never a
    scatter-add.  An index outside ``[0, N)`` adds exactly zero, whatever
    its weight.  On the card, :func:`combine_lanes`'s kernel on one lane."""
    if (buf.dim() != 2 or idx.dim() != 2 or w.shape != idx.shape
            or idx.dtype not in _INDEX or not w.is_floating_point()):
        raise ValueError(
            f"combine: buf {tuple(buf.shape)} / idx {tuple(idx.shape)} "
            f"{idx.dtype} / w {tuple(w.shape)} {w.dtype}: expected [N, D], "
            "an int [T, K] and a float [T, K]"
        )
    if use_kernel(buf, idx, w):
        return cuda.combine_rows(buf.contiguous(), _int32(idx, buf.shape[0]),
                                 w.to(torch.float32).contiguous())
    return combine_rows_ref(buf, idx, w)


def combine_lanes(buf: torch.Tensor, idx: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """K6 over G stacked lanes: ``out[g, n] = sum_k w[g, n, k] *
    buf[g, idx[g, n, k]]`` (buf [G, R, D], idx / w [G, N, K]) in float32,
    cast to ``buf``'s dtype.  An index outside ``[0, R)`` (the MoE layer's
    sentinel ``R`` for a dropped pair) adds exactly zero: no pad row is
    needed."""
    if (buf.dim() != 3 or idx.dim() != 3 or w.shape != idx.shape
            or idx.shape[0] != buf.shape[0] or idx.dtype not in _INDEX
            or not w.is_floating_point()):
        raise ValueError(
            f"combine_lanes: buf {tuple(buf.shape)} / idx {tuple(idx.shape)} "
            f"{idx.dtype} / w {tuple(w.shape)} {w.dtype}: expected [G, R, D], "
            "an int [G, N, K] and a float [G, N, K]"
        )
    if use_kernel(buf, idx, w):
        return cuda.combine_lanes(buf.contiguous(), _int32(idx, buf.shape[1]),
                                  w.to(torch.float32).contiguous())
    return combine_lanes_ref(buf, idx, w)
