"""Public ELL SpMV ops: CSR->ELL conversion, input validation, dispatch.

Every op takes rank-stacked operands (``cols``/``vals`` ``[P, R, W]``,
vectors ``[P, N]``) and validates them the same way whatever the device,
so the plain version and the CUDA kernel reject malformed input alike.
CPU tensors go to :mod:`.ref`, CUDA tensors to the kernels in :mod:`.cuda`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import use_kernel
from . import cuda
from .ref import (
    spmv_ell_blocked_partial_ref,
    spmv_ell_blocked_ref,
    spmv_ell_blocked_skip_ref,
    spmv_ell_ref,
)

DEFAULT_BLOCK_ROWS = 256
DEFAULT_BLOCK_COLS = 512


def csr_to_ell(
    indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
    n_rows: int, pad_col: int, block_rows: int = DEFAULT_BLOCK_ROWS,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad rows to uniform K and pad the row count to the block size.
    ``pad_col`` must point at an x entry that is always zero."""
    lens = np.diff(indptr)
    K = max(int(lens.max()) if len(lens) else 1, 1)
    R = int(n_rows + ((-n_rows) % min(block_rows, max(n_rows, 1))))
    cols = np.full((R, K), pad_col, dtype=np.int32)
    vals = np.zeros((R, K), dtype=np.float32)
    for i in range(n_rows):
        lo, hi = int(indptr[i]), int(indptr[i + 1])
        cols[i, : hi - lo] = indices[lo:hi]
        vals[i, : hi - lo] = data[lo:hi]
    return cols, vals


def _check_stacked(cols: torch.Tensor, vals: torch.Tensor,
                   x: torch.Tensor) -> None:
    if cols.dim() != 3 or vals.shape != cols.shape:
        raise ValueError(
            f"cols {tuple(cols.shape)} / vals {tuple(vals.shape)}: expected "
            "equal [P, R, W] shapes"
        )
    if x.dim() != 2 or x.shape[0] != cols.shape[0]:
        raise ValueError(
            f"x {tuple(x.shape)}: expected [P, N] with P={cols.shape[0]}"
        )


def spmv(cols: torch.Tensor, vals: torch.Tensor,
         x: torch.Tensor) -> torch.Tensor:
    """K1, flat ELL SpMV: ``x`` holds every column index (local values ++
    ghost values ++ one zero sentinel that the padding points at)."""
    _check_stacked(cols, vals, x)
    if use_kernel(cols, vals, x):
        return cuda.spmv_ell(cols, vals, x)
    return spmv_ell_ref(cols, vals, x)


def spmv_blocked(
    cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
    block_cols: int = DEFAULT_BLOCK_COLS,
) -> torch.Tensor:
    """K2, column-blocked ELL SpMV over the bucketed ``[P, R, C*K]`` layout.

    ``x`` must be bucket-padded (length a multiple of ``block_cols``, as
    produced by the bucketed packing)."""
    _check_stacked(cols, vals, x)
    if x.shape[-1] % block_cols:
        raise ValueError(
            f"x length {x.shape[-1]} not a multiple of block_cols "
            f"{block_cols}: pack with partitioned_to_ell_blocked"
        )
    if cols.shape[-1] % (x.shape[-1] // block_cols):
        raise ValueError(
            f"cols width {cols.shape[-1]} not divisible by the "
            f"{x.shape[-1] // block_cols} x buckets"
        )
    if use_kernel(cols, vals, x):
        return cuda.spmv_ell_blocked(cols, vals, x, block_cols)
    return spmv_ell_blocked_ref(cols, vals, x, block_cols)


def spmv_blocked_partial(
    cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
    y0: torch.Tensor,
    *,
    bucket_lo: int, bucket_hi: int, n_buckets: int,
    block_cols: int = DEFAULT_BLOCK_COLS,
) -> torch.Tensor:
    """K3, blocked SpMV over buckets [lo, hi) accumulated into a carried
    ``y0`` (the overlap schedule's per-phase entry point).  ``x`` holds
    only the range's slices: (hi - lo) * block_cols entries."""
    _check_stacked(cols, vals, x)
    lo, hi = int(bucket_lo), int(bucket_hi)
    if not (0 <= lo <= hi <= n_buckets):
        raise ValueError(
            f"bucket range [{lo}, {hi}) outside [0, {n_buckets})"
        )
    if x.shape[-1] != (hi - lo) * block_cols:
        raise ValueError(
            f"x length {x.shape[-1]} != (hi-lo)*block_cols "
            f"{(hi - lo) * block_cols}"
        )
    if cols.shape[-1] % n_buckets:
        raise ValueError(
            f"cols width {cols.shape[-1]} not divisible by n_buckets "
            f"{n_buckets}"
        )
    if y0.shape != cols.shape[:2]:
        raise ValueError(
            f"y0 {tuple(y0.shape)}: expected {tuple(cols.shape[:2])}"
        )
    if use_kernel(cols, vals, x, y0):
        return cuda.spmv_ell_blocked_partial(
            cols, vals, x, y0, lo, hi, n_buckets, block_cols
        )
    return spmv_ell_blocked_partial_ref(
        cols, vals, x, y0, lo, hi, block_cols, n_buckets
    )


def spmv_blocked_skip(
    cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
    bucket_lists: torch.Tensor, bucket_counts: torch.Tensor,
    *,
    n_buckets: int, block_cols: int = DEFAULT_BLOCK_COLS,
    bucket_base: int = 0, y0: Optional[torch.Tensor] = None,
    block_rows: int = DEFAULT_BLOCK_ROWS,
) -> torch.Tensor:
    """K4, bucket-skipping blocked SpMV driven by per-row-block bucket
    lists ``[P, NRB, M]`` and counts ``[P, NRB]``
    (:func:`repro_torch.sparse.device.row_block_bucket_map`).  ``x``
    covers buckets [base, base + len(x)/block_cols)."""
    _check_stacked(cols, vals, x)
    if x.shape[-1] % block_cols:
        raise ValueError(
            f"x length {x.shape[-1]} not a multiple of block_cols "
            f"{block_cols}"
        )
    if cols.shape[-1] % n_buckets:
        raise ValueError(
            f"cols width {cols.shape[-1]} not divisible by n_buckets "
            f"{n_buckets}"
        )
    P_, R = cols.shape[:2]
    br = min(int(block_rows), R)
    nrb = -(-R // br)
    if (bucket_lists.dim() != 3
            or tuple(bucket_lists.shape[:2]) != (P_, nrb)
            or tuple(bucket_counts.shape) != (P_, nrb)):
        raise ValueError(
            f"bucket_lists {tuple(bucket_lists.shape)} / counts "
            f"{tuple(bucket_counts.shape)}: expected [{P_}, {nrb}, M] / "
            f"[{P_}, {nrb}] for {R} rows in blocks of {br}"
        )
    if y0 is not None and y0.shape != cols.shape[:2]:
        raise ValueError(
            f"y0 {tuple(y0.shape)}: expected {tuple(cols.shape[:2])}"
        )
    operands = [cols, vals, x, bucket_lists, bucket_counts]
    if use_kernel(*operands, *([] if y0 is None else [y0])):
        return cuda.spmv_ell_blocked_skip(
            cols, vals, x, bucket_lists, bucket_counts, n_buckets,
            block_cols, br, bucket_base, y0,
        )
    return spmv_ell_blocked_skip_ref(
        cols, vals, x, bucket_lists, bucket_counts, n_buckets, block_cols,
        br, bucket_base, y0,
    )
