"""Hand-written CUDA kernels, their plain torch versions, and dispatch.

Each kernel lives in ``kernels/<name>/``: ``ref.py`` holds the plain torch
version, ``ops.py`` the public wrappers (input validation + dispatch), and a
``cuda.py`` builds and launches the CUDA source from ``repro_torch/csrc``.

Dispatch is on the tensors' device (:func:`use_kernel`): CPU tensors take the
plain version, CUDA tensors the kernel.  There is no fallback: a kernel that
fails to build or launch raises.

:data:`LAUNCHES` counts kernel calls by kernel name.  A wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels.  :data:`CUDA_LAUNCHES` counts the CUDA
kernel launches those calls made (K7's one-row decode makes two a call,
its backward three).
"""
from __future__ import annotations

from typing import Dict

import torch

LAUNCHES: Dict[str, int] = {
    "spmv_ell": 0,
    "spmv_ell_blocked": 0,
    "spmv_ell_blocked_partial": 0,
    "spmv_ell_blocked_skip": 0,
    "gather_rows": 0,
    "combine_rows": 0,
    "flash_attention_bh": 0,
    "flash_attention_bh_bwd": 0,
    "ssd_scan_h": 0,
}


CUDA_LAUNCHES: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)


def reset_launches() -> None:
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        CUDA_LAUNCHES[name] = 0


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version); raises on mixed or other devices."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(
        f"tensors on devices {sorted(kinds)}: expected all on cpu or all "
        "on cuda"
    )
