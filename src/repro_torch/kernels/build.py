"""Build, load and launch a CUDA source of ``repro_torch/csrc``.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, on the first CUDA call (never at import), under
``build/repro_torch/`` in the checkout, keyed on a hash of the source and
of the shared headers (``csrc/*.cuh``).  It is loaded with ``ctypes``.
Every exported launcher returns the CUDA error code of its launch
(``cudaGetLastError``) and every source exports ``repro_cuda_error_string``;
:meth:`CudaLibrary.launch` raises on a non-zero code and counts the call in
:data:`repro_torch.kernels.LAUNCHES`.  Every source also exports the
attributes of its kernels and the card's limits (``csrc/kernel_attrs.cuh``),
read by :meth:`CudaLibrary.kernel_attributes` and
:meth:`CudaLibrary.device_limits`.
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

# repro_kernel_attributes' out[0..8] and repro_device_limits' out[0..5]
# (csrc/kernel_attrs.cuh)
ATTR_FIELDS = ("num_regs", "static_smem", "max_threads_per_block",
               "local_bytes", "threads", "dyn_smem", "blocks_per_sm",
               "min_blocks", "max_dyn_smem")
LIMIT_FIELDS = ("regs_per_sm", "smem_per_block_optin", "smem_per_sm",
                "threads_per_sm", "sm_count", "regs_per_block")


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
        :attr:`build_log`, and in a ``.ptxas.log`` beside the library, from
        which a later process reads it back."""
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        digest = h.hexdigest()[:16]
        out = BUILD_DIR / f"lib{self.source.stem}-{digest}.so"
        log_path = out.with_suffix(".ptxas.log")
        if out.exists():
            # the log is written before the library, so a built library
            # has its log unless someone removed it
            self.build_log = (log_path.read_text() if log_path.exists()
                              else "")
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
        tmp_log = log_path.with_name(f"{log_path.name}.{os.getpid()}.tmp")
        tmp_log.write_text(self.build_log)
        os.replace(tmp_log, log_path)
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
            lib.repro_kernel_count.argtypes = []
            lib.repro_kernel_count.restype = ctypes.c_int
            lib.repro_kernel_attributes.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_int)]
            lib.repro_kernel_attributes.restype = ctypes.c_int
            lib.repro_device_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
            lib.repro_device_limits.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def _check(self, err: int, what: str) -> None:
        if err != 0:
            msg = self.library().repro_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.source.name}: {what} failed: CUDA "
                               f"error {err} ({msg})")

    def kernel_attributes(self, device=None) -> List[Dict[str, int]]:
        """The card's attributes of every kernel of the source, at its
        launch's block size and dynamic shared memory (the fields of
        ``csrc/kernel_attrs.cuh``, with the kernel's table name and mangled
        ``symbol``), one dict each, on ``device``."""
        lib = self.library()
        out = []
        with torch.cuda.device(device or torch.cuda.current_device()):
            for i in range(lib.repro_kernel_count()):
                name, symbol = ctypes.c_char_p(), ctypes.c_char_p()
                vals = (ctypes.c_int * len(ATTR_FIELDS))()
                self._check(lib.repro_kernel_attributes(
                    i, ctypes.byref(name), ctypes.byref(symbol), vals),
                    f"kernel attributes {i}")
                out.append({"name": name.value.decode(),
                            "symbol": symbol.value.decode(),
                            "source": self.source.name,
                            **dict(zip(ATTR_FIELDS, vals))})
        return out

    def device_limits(self, device=None) -> Dict[str, int]:
        """The card's per-SM and per-block limits (``LIMIT_FIELDS``)."""
        lib = self.library()
        vals = (ctypes.c_int * len(LIMIT_FIELDS))()
        with torch.cuda.device(device or torch.cuda.current_device()):
            self._check(lib.repro_device_limits(vals), "device limits")
        return dict(zip(LIMIT_FIELDS, vals))

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
