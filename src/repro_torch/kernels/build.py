"""Build, load and launch a CUDA source of ``repro_torch/csrc``.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, on the first CUDA call (never at import), under
``build/repro_torch/`` in the checkout, keyed on a hash of the source and
of the shared headers (``csrc/*.cuh``).  It is loaded with ``ctypes``.
Every exported launcher returns the CUDA error code of its launch
(``cudaGetLastError``) and every source exports ``repro_cuda_error_string``;
:meth:`CudaLibrary.launch` raises on a non-zero code and counts the call in
:data:`repro_torch.kernels.LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import CUDA_LAUNCHES, LAUNCHES

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


class CudaLibrary:
    """One ``csrc`` source: its build, its ctypes handle and its launchers.

    ``signatures`` maps each exported launcher to its argument types, the
    trailing stream pointer excluded (it is appended here)."""

    def __init__(self, source: str, signatures: Dict[str, List]):
        self.source = CSRC / source
        self.signatures = signatures
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None

    def build(self) -> Path:
        """Compile the source (unless this version is already built) and
        return the library's path; the compiler's output lands in
        :attr:`build_log`."""
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        digest = h.hexdigest()[:16]
        out = BUILD_DIR / f"lib{self.source.stem}-{digest}.so"
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        self.build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {self.source.name} with code "
                f"{res.returncode}:\n{self.build_log}"
            )
        os.replace(tmp, out)
        return out

    def library(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for name, argtypes in self.signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes) + [P]
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, kernel: str, fn_name: str, device: torch.device,
               *args, cuda_launches: int = 1) -> None:
        """Call launcher ``fn_name`` on ``device``'s current stream; raise if
        the launch reports an error, else count the call under ``kernel``
        in :data:`LAUNCHES` and its ``cuda_launches`` kernel launches in
        :data:`CUDA_LAUNCHES`."""
        lib = self.library()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, fn_name)(*args, stream)
        if err != 0:
            msg = lib.repro_cuda_error_string(err).decode()
            raise RuntimeError(f"{kernel}: kernel launch failed: CUDA error "
                               f"{err} ({msg})")
        LAUNCHES[kernel] += 1
        CUDA_LAUNCHES[kernel] += cuda_launches


def check_cuda(name: str, **tensors: torch.Tensor) -> torch.device:
    """Every tensor on one CUDA device, contiguous and within int32 sizes;
    returns that device."""
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
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{name}: {arg} has {t.numel()} elements, "
                             "above the kernel's int32 sizes")
    return device
