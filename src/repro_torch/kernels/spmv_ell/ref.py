"""Plain torch versions of the four ELL SpMV kernels (K1-K4).

All take rank-stacked operands, one independent product per rank: K1 the
flat ``cols``/``vals`` ``[P, R, K]``, K2-K4 the bucket-major
``[P, C, R, K]`` (bucket ``b`` of row ``r`` holds in-bucket indices into
x's slice of that bucket; :func:`.ops.to_bucket_major`), and ``x``
``[P, N]``.  They are the CPU path of :mod:`repro_torch.kernels.spmv_ell.ops`
and the values the CUDA kernels are held against on the card.  K2-K4
round exactly as their kernels do: each product rounded, a bucket's K
products summed in order into a partial, and the partials added in walk
order onto y0 (or zero), steps past a count adding nothing; so the kernels
(which do not fuse the multiply and the add) agree with them bit for bit.
"""
from __future__ import annotations

import torch


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[p, ...] = x[p, idx[p, ...]]``; an index outside
    ``[0, x.shape[1])`` raises."""
    flat = idx.long().reshape(idx.shape[0], -1)
    return torch.gather(x, 1, flat).reshape(idx.shape)


def spmv_ell_ref(cols: torch.Tensor, vals: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """K1, flat ELL: ``y[p, i] = sum_k vals[p,i,k] * x[p, cols[p,i,k]]``."""
    return torch.sum(vals * _gather(x, cols), dim=-1)


def _partial(v: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """A bucket's K products summed in order: ``[..., K] -> [...]``."""
    part = v[..., 0] * xv[..., 0]
    for k in range(1, v.shape[-1]):
        part = part + v[..., k] * xv[..., k]
    return part


def _range_sum(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
               acc: torch.Tensor, lo: int, hi: int,
               block_cols: int) -> torch.Tensor:
    """``acc`` plus the partial of each bucket of [lo, hi) in turn; ``x``
    holds exactly the range's slices, bucket ``j`` reading the slice
    ``j - lo``."""
    bc = int(block_cols)
    for j in range(lo, hi):
        xj = x[:, (j - lo) * bc:(j - lo + 1) * bc]
        acc = acc + _partial(vals[:, j], _gather(xj, cols[:, j]))
    return acc


def spmv_ell_blocked_ref(cols: torch.Tensor, vals: torch.Tensor,
                         x: torch.Tensor, block_cols: int) -> torch.Tensor:
    """K2, every bucket: bucket ``j`` reads
    ``x[p, j*block_cols:(j+1)*block_cols]``."""
    P_, C, R, _ = cols.shape
    zero = torch.zeros((P_, R), dtype=vals.dtype, device=vals.device)
    return _range_sum(cols, vals, x, zero, 0, C, block_cols)


def spmv_ell_blocked_partial_ref(
    cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
    y0: torch.Tensor, bucket_lo: int, bucket_hi: int, block_cols: int,
) -> torch.Tensor:
    """K3: buckets [lo, hi) accumulated into a carried ``y0``; ``x`` covers
    exactly that range.  ``hi == lo`` returns ``y0``."""
    return _range_sum(cols, vals, x, y0, int(bucket_lo), int(bucket_hi),
                      block_cols)


def spmv_ell_blocked_skip_ref(
    cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
    bucket_lists: torch.Tensor, bucket_counts: torch.Tensor,
    block_cols: int, block_rows: int,
    bucket_base: int = 0, y0: torch.Tensor | None = None,
) -> torch.Tensor:
    """K4: step ``j`` of row block ``i`` visits bucket
    ``bucket_lists[p, i, j]``; steps ``j >= bucket_counts[p, i]`` add
    exactly 0.  ``x`` covers buckets from ``bucket_base`` on."""
    P_, C, R, K = cols.shape
    r = torch.arange(R, device=cols.device)
    rb = r // int(block_rows)
    lists = bucket_lists.long()[:, rb, :]                     # [P, R, M]
    counts = bucket_counts.long()[:, rb]                      # [P, R]
    flat_cols = cols.reshape(P_, C * R, K)
    flat_vals = vals.reshape(P_, C * R, K)
    acc = (torch.zeros((P_, R), dtype=vals.dtype, device=vals.device)
           if y0 is None else y0)
    for j in range(lists.shape[-1]):
        b = lists[..., j]                                     # [P, R]
        at = (b * R + r).unsqueeze(-1).expand(-1, -1, K)      # entry (b, r)
        off = (b - int(bucket_base)) * int(block_cols)
        c = torch.gather(flat_cols, 1, at).long() + off[..., None]
        v = torch.gather(flat_vals, 1, at)
        acc = torch.where(j < counts, acc + _partial(v, _gather(x, c)), acc)
    return acc
