"""Launch the CUDA SSD scan kernel (``csrc/ssd_scan.cu``).

The source is built and loaded by :class:`repro_torch.kernels.build.CudaLibrary`
on the first CUDA call (never at import).  The wrapper checks what the
launch needs (one CUDA device, contiguity, x / B / C in one of bf16 or f32,
dt and A in f32, a (P, N) the source is built for, 16-byte aligned x, B
and C, sizes within int32),
allocates y with ``torch.empty``, launches on the current stream, raises if
the launch reports an error, and counts the launch in
:data:`repro_torch.kernels.LAUNCHES`.  Shapes are validated by
:func:`repro_torch.kernels.ssd_scan.ops.ssd`.
"""
from __future__ import annotations

import torch

from ..build import CudaLibrary, I, P, check_cuda

_ARGS = [P, P, P, P, P, P, I, I, I, I, I, I]
LIBRARY = CudaLibrary("ssd_scan.cu", {
    "repro_ssd_scan_bf16": _ARGS,
    "repro_ssd_scan_f32": _ARGS,
})
_FN = {torch.bfloat16: "repro_ssd_scan_bf16",
       torch.float32: "repro_ssd_scan_f32"}
SHAPES = ((64, 64), (64, 128))      # the (P, N) the source is built for


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """K8 on the card: x [Bt, T, H, P], dt [Bt, T, H] f32, A [H] f32,
    B / C [Bt, T, G, N] in x's dtype -> y [Bt, T, H, P] in x's dtype."""
    device = check_cuda("ssd_scan_h", x=x, dt=dt, A=A, B=B, C=C)
    if x.dtype not in _FN or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan_h: x/B/C {x.dtype}/{B.dtype}/{C.dtype}, "
                        "expected all bfloat16 or all float32")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan_h: dt/A {dt.dtype}/{A.dtype}, expected "
                        "float32")
    Bt, T, H, P_ = x.shape
    G, N = B.shape[2], B.shape[3]
    if (P_, N) not in SHAPES:
        raise ValueError(f"ssd_scan_h: (P, N) = ({P_}, {N}), expected one "
                         f"of {SHAPES}")
    if any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("ssd_scan_h: x/B/C not 16-byte aligned")
    y = torch.empty_like(x)
    if y.numel():
        LIBRARY.launch("ssd_scan_h", _FN[x.dtype], device, x.data_ptr(),
                       dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                       C.data_ptr(), y.data_ptr(), Bt, T, H, G, P_, N)
    return y
