"""Public ELL SpMV ops: CSR->ELL conversion, input validation, dispatch.

Every op takes rank-stacked operands and validates them the same way
whatever the device, so the plain version and the CUDA kernel reject
malformed input alike.  K1 takes the flat ``cols``/``vals`` ``[P, R, K]``;
K2-K4 take the bucketed operator bucket-major, ``[P, C, R, K]``
(:func:`to_bucket_major` of the ``[P, R, C*K]`` layout that
:func:`repro_torch.sparse.device.partitioned_to_ell_blocked` packs, as the
reference does), so that a row block's tile of one bucket is contiguous.
Vectors are ``[P, N]``.  CPU tensors go to :mod:`.ref`, CUDA tensors to the
kernels in :mod:`.cuda`.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

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


def to_bucket_major(a: Union[np.ndarray, torch.Tensor], n_buckets: int,
                    device=None) -> torch.Tensor:
    """``[P, R, C*K]`` (a row's C buckets of K entries consecutive) ->
    ``[P, C, R, K]`` on ``device`` (default: where ``a`` is), the layout of
    K2-K4: bucket ``b`` of rows ``r0..r1`` is one contiguous run.  Copied
    one rank at a time, so ``device`` holds the result and one rank's
    slice in flight, never a second whole copy."""
    src = torch.as_tensor(a)
    P_, R, W = src.shape
    C = int(n_buckets)
    if C <= 0 or W % C:
        raise ValueError(f"width {W} not divisible by n_buckets {C}")
    out = torch.empty((P_, C, R, W // C), dtype=src.dtype,
                      device=src.device if device is None else device)
    for p in range(P_):
        out[p].copy_(src[p].to(out.device).reshape(R, C, W // C)
                     .transpose(0, 1))
    return out


def from_bucket_major(a: torch.Tensor) -> torch.Tensor:
    """``[P, C, R, K]`` -> ``[P, R, C*K]``: the inverse of
    :func:`to_bucket_major`."""
    P_, C, R, K = a.shape
    return a.transpose(1, 2).reshape(P_, R, C * K)


def _check_vector(x: torch.Tensor, P_: int) -> None:
    if x.dim() != 2 or x.shape[0] != P_:
        raise ValueError(f"x {tuple(x.shape)}: expected [P, N] with P={P_}")


def _check_stacked(cols: torch.Tensor, vals: torch.Tensor,
                   x: torch.Tensor) -> None:
    if cols.dim() != 3 or vals.shape != cols.shape:
        raise ValueError(
            f"cols {tuple(cols.shape)} / vals {tuple(vals.shape)}: expected "
            "equal [P, R, W] shapes"
        )
    _check_vector(x, cols.shape[0])


def _check_bucketed(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                    block_cols: int, n_buckets: Optional[int] = None) -> None:
    """Bucket-major cols/vals, x [P, N] in whole buckets, and (if given)
    ``n_buckets`` equal to the layout's."""
    if cols.dim() != 4 or vals.shape != cols.shape:
        raise ValueError(
            f"cols {tuple(cols.shape)} / vals {tuple(vals.shape)}: expected "
            "equal bucket-major [P, C, R, K] shapes (to_bucket_major)"
        )
    _check_vector(x, cols.shape[0])
    if x.shape[-1] % block_cols:
        raise ValueError(
            f"x length {x.shape[-1]} not a multiple of block_cols "
            f"{block_cols}: pack with partitioned_to_ell_blocked"
        )
    if n_buckets is not None and n_buckets != cols.shape[1]:
        raise ValueError(
            f"n_buckets {n_buckets} != the layout's {cols.shape[1]} buckets"
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
    """K2, column-blocked ELL SpMV over every bucket of the bucket-major
    ``[P, C, R, K]`` layout.

    ``x`` must be bucket-padded: C slices of ``block_cols``, as produced
    by the bucketed packing."""
    _check_bucketed(cols, vals, x, block_cols)
    if x.shape[-1] != cols.shape[1] * block_cols:
        raise ValueError(
            f"x's {x.shape[-1]} entries are not divisible into the layout's "
            f"{cols.shape[1]} buckets of {block_cols}"
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
    _check_bucketed(cols, vals, x, block_cols, n_buckets)
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
    if y0.shape != (cols.shape[0], cols.shape[2]):
        raise ValueError(
            f"y0 {tuple(y0.shape)}: expected "
            f"{(cols.shape[0], cols.shape[2])}"
        )
    if use_kernel(cols, vals, x, y0):
        return cuda.spmv_ell_blocked_partial(
            cols, vals, x, y0, lo, hi, block_cols
        )
    return spmv_ell_blocked_partial_ref(cols, vals, x, y0, lo, hi,
                                        block_cols)


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
    _check_bucketed(cols, vals, x, block_cols, n_buckets)
    P_, _, R, _ = cols.shape
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
    if y0 is not None and y0.shape != (P_, R):
        raise ValueError(f"y0 {tuple(y0.shape)}: expected {(P_, R)}")
    operands = [cols, vals, x, bucket_lists, bucket_counts]
    if use_kernel(*operands, *([] if y0 is None else [y0])):
        return cuda.spmv_ell_blocked_skip(
            cols, vals, x, bucket_lists, bucket_counts, block_cols, br,
            bucket_base, y0,
        )
    return spmv_ell_blocked_skip_ref(
        cols, vals, x, bucket_lists, bucket_counts, block_cols, br,
        bucket_base, y0,
    )
