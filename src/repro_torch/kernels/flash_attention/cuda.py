"""Launch the CUDA attention kernels (``csrc/flash_attention.cu``).

The source is built and loaded by :class:`repro_torch.kernels.build.CudaLibrary`
on the first CUDA call (never at import).  The wrapper checks what the
launch needs (one CUDA device, contiguity, bf16 or f32, a head dim the
source is built for, 16-byte aligned rows, sizes within int32), allocates
the output (and, for one query row, one fp32 scratch for the split
partials) with ``torch.empty``, launches on the current stream, raises if
the launch reports an error, and counts the call in
:data:`repro_torch.kernels.LAUNCHES`.  A call with one query row runs the
split-key decode, two CUDA launches (the splits' partials, then their
combine); any other runs the prefill kernel.  Shapes are validated by
:func:`repro_torch.kernels.flash_attention.ops.flash_attention_bh`.
"""
from __future__ import annotations

import torch

from ..build import F, CudaLibrary, I, P, check_cuda
from .ref import DECODE_SPLIT, decode_splits

_PREFILL = [P, P, P, P, I, I, I, I, F, I, I, I, I]
_DECODE = [P, P, P, P, P, P, I, I, I, F, I, I, I]
LIBRARY = CudaLibrary("flash_attention.cu", {
    "repro_flash_attention_bh_bf16": _PREFILL,
    "repro_flash_attention_bh_f32": _PREFILL,
    "repro_flash_decode_bf16": _DECODE,
    "repro_flash_decode_f32": _DECODE,
})
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
ROWS_PER_BLOCK = 64          # kRows in the source
HEAD_DIMS = (64, 112, 128, 192, 256)    # the head dims the source is built for


def flash_attention_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float, causal: bool, window: int, kv_len: int,
                       q_offset: int) -> torch.Tensor:
    """K7 on the card: q [BH, Tq, d], k / v [BH, Tk, d] -> [BH, Tq, d]."""
    device = check_cuda("flash_attention_bh", q=q, k=k, v=v)
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_bh: q/k/v {q.dtype}/{k.dtype}/"
                        f"{v.dtype}, expected all bfloat16 or all float32")
    BH, Tq, d = q.shape
    Tk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bh: head dim {d}, expected one "
                         f"of {HEAD_DIMS}")
    if -(-Tq // ROWS_PER_BLOCK) > 65535:
        raise ValueError(f"flash_attention_bh: {Tq} query rows, above the "
                         "kernel's grid")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_bh: q/k/v not 16-byte aligned")
    out = torch.empty_like(q)
    if not out.numel():
        return out
    sfx = _SUFFIX[q.dtype]
    if Tq == 1:
        begin, end, n_split = decode_splits(Tk, kv_len, causal, window,
                                            q_offset, DECODE_SPLIT)
        if n_split > 65535:
            raise ValueError(f"flash_attention_bh: {n_split} key splits, "
                             "above the kernel's grid")
        # part_acc [BH, n_split, d], then part_ml [BH, n_split, 2]
        n_acc = BH * n_split * d
        part = torch.empty(n_acc + 2 * BH * n_split, dtype=torch.float32,
                           device=device)
        LIBRARY.launch("flash_attention_bh", f"repro_flash_decode_{sfx}",
                       device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), part.data_ptr(),
                       part.data_ptr() + 4 * n_acc, BH, Tk, d,
                       float(scale), begin, end, n_split, cuda_launches=2)
        return out
    LIBRARY.launch("flash_attention_bh", f"repro_flash_attention_bh_{sfx}",
                   device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   out.data_ptr(), BH, Tq, Tk, d, float(scale), int(causal),
                   int(window), int(kv_len), int(q_offset))
    return out
