"""Launch the CUDA MoE pack / combine kernels (``csrc/moe_pack.cu``).

The source is built and loaded by :class:`repro_torch.kernels.build.CudaLibrary`
on the first CUDA call (never at import).  Each wrapper checks what the
launch needs (one CUDA device, contiguity, dtypes, sizes within int32),
allocates its output with ``torch.empty``, picks the widest copy unit that
the row length and the pointers' alignment allow, launches on the current
stream, raises if the launch reports an error, and counts the launch in
:data:`repro_torch.kernels.LAUNCHES`.  Shapes are validated once, by the
public wrappers in :mod:`.ops`.
"""
from __future__ import annotations

import torch

from ..build import CudaLibrary, I, P, check_cuda

LIBRARY = CudaLibrary("moe_pack.cu", {
    "repro_gather_rows": [P, P, P, I, I, I, I],
    "repro_combine_lanes_bf16": [P, P, P, P, I, I, I, I, I, I],
    "repro_combine_lanes_f32": [P, P, P, P, I, I, I, I, I, I],
})
_COMBINE = {torch.bfloat16: "repro_combine_lanes_bf16",
            torch.float32: "repro_combine_lanes_f32"}


def _unit(nbytes: int, *tensors: torch.Tensor) -> int:
    """The widest of 16, 4, 2, 1 bytes dividing ``nbytes`` and every
    tensor's address."""
    for unit in (16, 4, 2, 1):
        if nbytes % unit == 0 and all(t.data_ptr() % unit == 0
                                      for t in tensors):
            return unit
    return 1


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K5 on the card: x [N, D] (any dtype), idx [M] int32 -> [M, D]; an
    index outside [0, N) gives a zero row and reads nothing of x."""
    device = check_cuda("gather_rows", x=x, idx=idx)
    if idx.dtype != torch.int32:
        raise TypeError(f"gather_rows: idx is {idx.dtype}, expected int32")
    (N, D), M = x.shape, idx.shape[0]
    out = torch.empty((M, D), dtype=x.dtype, device=device)
    if out.numel():
        row_bytes = D * x.element_size()
        LIBRARY.launch("gather_rows", "repro_gather_rows", device,
                       x.data_ptr(), idx.data_ptr(), out.data_ptr(), M, N,
                       row_bytes, _unit(row_bytes, x, out))
    return out


def combine_lanes(buf: torch.Tensor, idx: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """K6 on the card: buf [G, R, D] bf16/f32, idx [G, N, K] int32, w
    [G, N, K] f32 -> [G, N, D] in buf's dtype; an index outside [0, R)
    adds zero and reads no row."""
    device = check_cuda("combine_lanes", buf=buf, idx=idx, w=w)
    if buf.dtype not in _COMBINE:
        raise TypeError(f"combine_lanes: buf is {buf.dtype}, expected "
                        "bfloat16 or float32")
    if idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"combine_lanes: idx {idx.dtype} / w {w.dtype}, "
                        "expected int32 / float32")
    (G, R, D), (N, K) = buf.shape, idx.shape[1:]
    out = torch.empty((G, N, D), dtype=buf.dtype, device=device)
    if out.numel():
        vector = int(_unit(D * buf.element_size(), buf, out) == 16)
        LIBRARY.launch("combine_rows", _COMBINE[buf.dtype], device,
                       buf.data_ptr(), idx.data_ptr(), w.data_ptr(),
                       out.data_ptr(), G, N, K, R, D, vector)
    return out


def combine_rows(buf: torch.Tensor, idx: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """K6 on one table: buf [N, D], idx [T, K] int32, w [T, K] f32 -> [T, D]
    (:func:`combine_lanes` on one lane)."""
    return combine_lanes(buf[None], idx[None], w[None])[0]
