"""Plain torch versions of the four ELL SpMV kernels (K1-K4).

All take rank-stacked operands: ``cols``/``vals`` ``[P, R, W]`` and
``x`` ``[P, N]``, one independent product per rank.  They are the CPU path
of :mod:`repro_torch.kernels.spmv_ell.ops` and the values the CUDA kernels
are held against on the card.
"""
from __future__ import annotations

import torch


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[p, i, k] = x[p, idx[p, i, k]]``; an index outside
    ``[0, x.shape[1])`` raises."""
    flat = idx.long().reshape(idx.shape[0], -1)
    return torch.gather(x, 1, flat).reshape(idx.shape)


def _bucket_base(n_buckets: int, K: int, block_cols: int,
                 device) -> torch.Tensor:
    """x offset of every column of a ``[., n_buckets*K]`` bucketed row."""
    return torch.repeat_interleave(
        torch.arange(n_buckets, device=device) * int(block_cols), K
    )


def spmv_ell_ref(cols: torch.Tensor, vals: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """K1, flat ELL: ``y[p, i] = sum_k vals[p,i,k] * x[p, cols[p,i,k]]``."""
    return torch.sum(vals * _gather(x, cols), dim=-1)


def spmv_ell_blocked_ref(cols: torch.Tensor, vals: torch.Tensor,
                         x: torch.Tensor, block_cols: int) -> torch.Tensor:
    """K2, column-bucketed ELL: bucket ``j`` occupies columns
    [j*K, (j+1)*K) of ``cols``/``vals`` and holds in-bucket indices into
    ``x[p, j*block_cols:(j+1)*block_cols]``."""
    C = x.shape[-1] // int(block_cols)
    K = cols.shape[-1] // C
    base = _bucket_base(C, K, block_cols, cols.device)
    return torch.sum(vals * _gather(x, cols.long() + base), dim=-1)


def spmv_ell_blocked_partial_ref(
    cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
    y0: torch.Tensor, bucket_lo: int, bucket_hi: int, block_cols: int,
    n_buckets: int,
) -> torch.Tensor:
    """K3: buckets [lo, hi) of the full layout accumulated into a carried
    ``y0``; ``x`` covers exactly that range.  ``hi == lo`` returns ``y0``."""
    lo, hi = int(bucket_lo), int(bucket_hi)
    if hi <= lo:
        return y0
    K = cols.shape[-1] // int(n_buckets)
    sl_cols = cols[..., lo * K: hi * K].long()
    sl_vals = vals[..., lo * K: hi * K]
    base = _bucket_base(hi - lo, K, block_cols, cols.device)
    return y0 + torch.sum(sl_vals * _gather(x, sl_cols + base), dim=-1)


def spmv_ell_blocked_skip_ref(
    cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
    bucket_lists: torch.Tensor, bucket_counts: torch.Tensor,
    n_buckets: int, block_cols: int, block_rows: int,
    bucket_base: int = 0, y0: torch.Tensor | None = None,
) -> torch.Tensor:
    """K4: step ``j`` of row block ``i`` visits bucket
    ``bucket_lists[p, i, j]``; steps ``j >= bucket_counts[p, i]`` add
    exactly 0.  ``x`` covers buckets from ``bucket_base`` on."""
    P_, R, W = cols.shape
    K = W // int(n_buckets)
    M = bucket_lists.shape[-1]
    rb = torch.arange(R, device=cols.device) // int(block_rows)
    lists = bucket_lists.long()[:, rb, :]                     # [P, R, M]
    live = (torch.arange(M, device=cols.device)
            < bucket_counts.long()[:, rb, None])              # [P, R, M]
    slot = (lists[..., None] * K
            + torch.arange(K, device=cols.device)).reshape(P_, R, M * K)
    c = torch.gather(cols.long(), 2, slot)
    v = torch.gather(vals, 2, slot)
    xoff = ((lists - int(bucket_base)) * int(block_cols)).repeat_interleave(
        K, dim=-1)
    partial = torch.sum((v * _gather(x, c + xoff)).reshape(P_, R, M, K),
                        dim=-1)
    contrib = torch.where(live, partial, torch.zeros((), dtype=vals.dtype))
    y = torch.sum(contrib, dim=-1)
    return y if y0 is None else y0 + y
