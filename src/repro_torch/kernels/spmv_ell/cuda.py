"""Build, load and launch the CUDA ELL SpMV kernels (``csrc/spmv_ell.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, on the first CUDA call (never at import), under
``build/repro_torch/`` in the checkout, keyed on a hash of the source.  It is
loaded with ``ctypes``.  Each wrapper checks what the launch needs (CUDA
device, contiguity, dtypes, sizes within int32), allocates its output with
``torch.empty``, launches on the current stream, raises if the launch
reports an error, and counts the launch in
:data:`repro_torch.kernels.LAUNCHES`.  Operand shapes are validated once, by
the public wrappers in :mod:`.ops` that every call goes through.

Column indices, bucket lists and counts are not range-checked on the card:
the packing in :mod:`repro_torch.sparse.device` produces them in range, and
the plain versions in :mod:`.ref` raise on an index out of range.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

from .. import LAUNCHES

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "spmv_ell.cu"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "spmv_ell": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "spmv_ell_blocked": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "spmv_ell_blocked_partial": [_P, _P, _P, _P, _P] + [_I] * 7 + [_P],
    "spmv_ell_blocked_skip": [_P] * 7 + [_I] * 10 + [_P],
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

_lib: Optional[ctypes.CDLL] = None
build_log = ""


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> Path:
    """Compile the source (unless this version is already built) and return
    the library's path; the compiler's output lands in :data:`build_log`."""
    global build_log
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libspmv_ell-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {res.returncode}:\n{build_log}"
        )
    os.replace(tmp, out)
    return out


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            for sfx in _SUFFIX.values():
                fn = getattr(lib, f"repro_{name}_{sfx}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name: str, dtype: torch.dtype, **tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device, contiguous and within int32 sizes;
    cols / lists / counts int32; values in ``dtype`` (float32 or
    float64)."""
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: values must be float32 or float64, "
                        f"got {dtype}")
    device = None
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, not cuda")
        if device is not None and t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, others on "
                             f"{device}")
        device = t.device
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        want = torch.int32 if arg in ("cols", "lists", "counts") else dtype
        if t.dtype != want:
            raise TypeError(f"{name}: {arg} is {t.dtype}, expected {want}")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{name}: {arg} has {t.numel()} elements, "
                             "above the kernel's int32 sizes")


def _launch(name: str, dtype: torch.dtype, device: torch.device,
            *args) -> None:
    lib = _library()
    fn = getattr(lib, f"repro_{name}_{_SUFFIX[dtype]}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    LAUNCHES[name] += 1


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
    """K2 on the card: cols/vals [P, R, C*K], x [P, C*block_cols]."""
    _check("spmv_ell_blocked", vals.dtype, cols=cols, vals=vals, x=x)
    P_, R, W = cols.shape
    C = x.shape[1] // int(block_cols)
    y = torch.empty((P_, R), dtype=vals.dtype, device=vals.device)
    if y.numel():
        _launch("spmv_ell_blocked", vals.dtype, vals.device,
                cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
                P_, R, W, W // C, C, int(block_cols))
    return y


def spmv_ell_blocked_partial(
    cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
    y0: torch.Tensor, bucket_lo: int, bucket_hi: int, n_buckets: int,
    block_cols: int,
) -> torch.Tensor:
    """K3 on the card: buckets [lo, hi) added to ``y0``; ``hi == lo``
    returns ``y0`` without a launch."""
    _check("spmv_ell_blocked_partial", vals.dtype, cols=cols, vals=vals,
           x=x, y0=y0)
    if bucket_hi == bucket_lo:
        return y0
    P_, R, W = cols.shape
    y = torch.empty((P_, R), dtype=vals.dtype, device=vals.device)
    if y.numel():
        _launch("spmv_ell_blocked_partial", vals.dtype, vals.device,
                cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
                y0.data_ptr(), y.data_ptr(), P_, R, W, W // int(n_buckets),
                int(bucket_lo), int(bucket_hi), int(block_cols))
    return y


def spmv_ell_blocked_skip(
    cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
    bucket_lists: torch.Tensor, bucket_counts: torch.Tensor,
    n_buckets: int, block_cols: int, block_rows: int, bucket_base: int,
    y0: Optional[torch.Tensor],
) -> torch.Tensor:
    """K4 on the card: one thread block of ``block_rows`` threads per row
    block, following that block's bucket list."""
    operands = dict(cols=cols, vals=vals, x=x, lists=bucket_lists,
                    counts=bucket_counts)
    if y0 is not None:
        operands["y0"] = y0
    _check("spmv_ell_blocked_skip", vals.dtype, **operands)
    P_, R, W = cols.shape
    nrb, M = bucket_lists.shape[1:]
    if not 0 < block_rows <= 1024:
        raise ValueError(f"spmv_ell_blocked_skip: {block_rows} rows per "
                         "row block; a thread block holds at most 1024")
    y = torch.empty((P_, R), dtype=vals.dtype, device=vals.device)
    if y.numel():
        _launch("spmv_ell_blocked_skip", vals.dtype, vals.device,
                cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
                bucket_lists.data_ptr(), bucket_counts.data_ptr(),
                None if y0 is None else y0.data_ptr(), y.data_ptr(),
                P_, R, W, W // int(n_buckets), M, nrb, int(block_rows),
                int(bucket_base), int(block_cols), x.shape[1])
    return y
