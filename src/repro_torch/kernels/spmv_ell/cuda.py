"""Launch the CUDA ELL SpMV kernels (``csrc/spmv_ell.cu``).

The source is built and loaded by :class:`repro_torch.kernels.build.CudaLibrary`
on the first CUDA call (never at import).  Each wrapper checks what the launch needs (CUDA
device, contiguity, dtypes, sizes within int32), allocates its output with
``torch.empty``, launches on the current stream, raises if the launch
reports an error, and counts the launch in
:data:`repro_torch.kernels.LAUNCHES`.  Operand shapes are validated once, by
the public wrappers in :mod:`.ops` that every call goes through.

K2-K4 take the bucket-major ``[P, C, R, K]`` cols/vals; their launchers
choose rows and threads per row from the shapes (``csrc/spmv_ell.cu``).

Column indices, bucket lists and counts are not range-checked on the card:
the packing in :mod:`repro_torch.sparse.device` produces them in range, and
the plain versions in :mod:`.ref` raise on an index out of range.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..build import CudaLibrary, I, P, check_cuda

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_ARGS = {
    "spmv_ell": [P, P, P, P, I, I, I, I],
    "spmv_ell_blocked": [P, P, P, P] + [I] * 5,
    "spmv_ell_blocked_partial": [P] * 5 + [I] * 7,
    "spmv_ell_blocked_skip": [P] * 7 + [I] * 9,
}
LIBRARY = CudaLibrary("spmv_ell.cu", {
    f"repro_{name}_{sfx}": args
    for name, args in _ARGS.items() for sfx in _SUFFIX.values()
})


def _check(name: str, dtype: torch.dtype, **tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device, contiguous and within int32 sizes;
    cols / lists / counts int32; values in ``dtype`` (float32 or
    float64)."""
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: values must be float32 or float64, "
                        f"got {dtype}")
    check_cuda(name, **tensors)
    for arg, t in tensors.items():
        want = torch.int32 if arg in ("cols", "lists", "counts") else dtype
        if t.dtype != want:
            raise TypeError(f"{name}: {arg} is {t.dtype}, expected {want}")


def _launch(name: str, dtype: torch.dtype, device: torch.device,
            *args) -> None:
    LIBRARY.launch(name, f"repro_{name}_{_SUFFIX[dtype]}", device, *args)


def spmv_ell(cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """K1 on the card: cols/vals [P, R, K], x [P, N] -> y [P, R]."""
    _check("spmv_ell", vals.dtype, cols=cols, vals=vals, x=x)
    P_, R, K = cols.shape
    y = torch.empty((P_, R), dtype=vals.dtype, device=vals.device)
    if y.numel():
        _launch("spmv_ell", vals.dtype, vals.device, cols.data_ptr(),
                vals.data_ptr(), x.data_ptr(), y.data_ptr(), P_, R, K,
                x.shape[1])
    return y


def spmv_ell_blocked(cols: torch.Tensor, vals: torch.Tensor,
                     x: torch.Tensor, block_cols: int) -> torch.Tensor:
    """K2 on the card: cols/vals [P, C, R, K], x [P, C*block_cols]."""
    _check("spmv_ell_blocked", vals.dtype, cols=cols, vals=vals, x=x)
    P_, C, R, K = cols.shape
    y = torch.empty((P_, R), dtype=vals.dtype, device=vals.device)
    if y.numel():
        _launch("spmv_ell_blocked", vals.dtype, vals.device,
                cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
                P_, R, C, K, int(block_cols))
    return y


def spmv_ell_blocked_partial(
    cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
    y0: torch.Tensor, bucket_lo: int, bucket_hi: int, block_cols: int,
) -> torch.Tensor:
    """K3 on the card: buckets [lo, hi) added to ``y0``; ``hi == lo``
    returns ``y0`` without a launch."""
    _check("spmv_ell_blocked_partial", vals.dtype, cols=cols, vals=vals,
           x=x, y0=y0)
    if bucket_hi == bucket_lo:
        return y0
    P_, C, R, K = cols.shape
    y = torch.empty((P_, R), dtype=vals.dtype, device=vals.device)
    if y.numel():
        _launch("spmv_ell_blocked_partial", vals.dtype, vals.device,
                cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
                y0.data_ptr(), y.data_ptr(), P_, R, C, K, int(bucket_lo),
                int(bucket_hi), int(block_cols))
    return y


def spmv_ell_blocked_skip(
    cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
    bucket_lists: torch.Tensor, bucket_counts: torch.Tensor,
    block_cols: int, block_rows: int, bucket_base: int,
    y0: Optional[torch.Tensor],
) -> torch.Tensor:
    """K4 on the card: one thread block of ``block_rows`` threads per row
    block, following that block's bucket list."""
    operands = dict(cols=cols, vals=vals, x=x, lists=bucket_lists,
                    counts=bucket_counts)
    if y0 is not None:
        operands["y0"] = y0
    _check("spmv_ell_blocked_skip", vals.dtype, **operands)
    P_, C, R, K = cols.shape
    M = bucket_lists.shape[2]
    if not 0 < block_rows <= 1024:
        raise ValueError(f"spmv_ell_blocked_skip: {block_rows} rows per "
                         "row block; a thread block holds at most 1024")
    y = torch.empty((P_, R), dtype=vals.dtype, device=vals.device)
    if y.numel():
        _launch("spmv_ell_blocked_skip", vals.dtype, vals.device,
                cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
                bucket_lists.data_ptr(), bucket_counts.data_ptr(),
                None if y0 is None else y0.data_ptr(), y.data_ptr(),
                P_, R, C, K, M, int(block_rows), int(bucket_base),
                int(block_cols), x.shape[1])
    return y
