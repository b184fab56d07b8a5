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
combine); any other runs the prefill kernel, which on request also writes
the rows' log-sum-exp for the backward; its tiles (bf16 on the tensor
cores, float32 in ``csrc/attn_fwd_f32.cuh``) are mirrored here
(``FWD_ROWS``, ``FWD_STEP``) with the key steps a block walks
(:func:`fwd_key_steps`).  The backward (``csrc/flash_attention_bwd.cu``)
is three CUDA launches a call and counts under ``flash_attention_bh_bwd``;
its tiles are mirrored too (``BWD_ROWS``, ``BWD_STEP``) with the steps a
block walks (:func:`bwd_query_steps`, :func:`bwd_key_steps`).  Shapes are
validated by :mod:`repro_torch.kernels.flash_attention.ops`.
"""
from __future__ import annotations

import torch

from ..build import F, CudaLibrary, I, P, check_cuda
from .ref import DECODE_SPLIT, decode_splits

_PREFILL = [P, P, P, P, P, I, I, I, I, F, I, I, I, I]
_DECODE = [P, P, P, P, P, P, I, I, I, F, I, I, I]
LIBRARY = CudaLibrary("flash_attention.cu", {
    "repro_flash_attention_bh_bf16": _PREFILL,
    "repro_flash_attention_bh_f32": _PREFILL,
    "repro_flash_decode_bf16": _DECODE,
    "repro_flash_decode_f32": _DECODE,
})
_BWD = [P, P, P, P, P, P, P, P, P, P, I, I, I, I, F, I, I]
BWD_LIBRARY = CudaLibrary("flash_attention_bwd.cu", {
    "repro_flash_attention_bh_bwd_bf16": _BWD,
    "repro_flash_attention_bh_bwd_f32": _BWD,
})
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
HEAD_DIMS = (64, 112, 128, 192, 256)    # the head dims the source is built for
# The prefill's tiles by dtype: query rows a block (kRows, f32::kRows) and
# keys a step by head dim (Prefill<E, D>::kKeys, f32::Tiles<D>::kStep)
FWD_ROWS = {torch.bfloat16: 64, torch.float32: 32}
FWD_STEP = {torch.bfloat16: {d: 64 for d in HEAD_DIMS},
            torch.float32: {d: 64 if d == 64 else 32 for d in HEAD_DIMS}}
BWD_HEAD_DIMS = (64, 128)    # the head dims the backward is built for
# The backward's tiles by dtype: rows a block owns (keys in dK / dV,
# queries in dQ; kRows, f32::kOwn) and rows of the other side a step by
# head dim (kStep, f32::Tiles<D>::kStep)
BWD_ROWS = {torch.bfloat16: 64, torch.float32: 32}
BWD_STEP = {torch.bfloat16: {64: 32, 128: 32},
            torch.float32: {64: 64, 128: 32}}


def fwd_key_steps(q0: int, rows: int, step: int, Tq: int, Tk: int,
                  causal: bool, window: int, kv_len: int,
                  q_offset: int) -> range:
    """The key steps a prefill block owning query rows [q0, q0 + rows)
    walks, ``step`` keys each, as the kernels compute them: from the first
    row's window to the last row's causal bound, below kv_len."""
    q_last = min(q0 + rows, Tq) - 1
    k_end = min(kv_len, Tk)
    if causal:
        k_end = min(k_end, q_offset + q_last + 1)
    k_begin = max(0, q_offset + q0 - window + 1) if window > 0 else 0
    first = k_begin // step
    return range(first, -(-k_end // step) if k_end > k_begin else first)


def bwd_query_steps(k0: int, rows: int, step: int, Tq: int, Tk: int,
                    causal: bool, window: int) -> range:
    """The query steps a dK / dV block owning keys [k0, k0 + rows) walks,
    ``step`` queries each, as the kernels compute them: from the block's
    first key under the causal mask to its last key + window - 1 under a
    window."""
    k_last = min(k0 + rows, Tk) - 1
    q_begin = k0 if causal else 0
    q_end = min(Tq, k_last + window) if window > 0 else Tq
    first = q_begin // step
    return range(first, -(-q_end // step) if q_end > q_begin else first)


def bwd_key_steps(q0: int, rows: int, step: int, Tq: int, Tk: int,
                  causal: bool, window: int) -> range:
    """The key steps a dQ block owning query rows [q0, q0 + rows) walks,
    ``step`` keys each, as the kernels compute them."""
    q_last = min(q0 + rows, Tq) - 1
    k_end = min(Tk, q_last + 1) if causal else Tk
    k_begin = max(0, q0 - window + 1) if window > 0 else 0
    first = k_begin // step
    return range(first, -(-k_end // step) if k_end > k_begin else first)


def _check_operands(name: str, dims, q: torch.Tensor, rows_per_block: int,
                    **kv: torch.Tensor):
    """One CUDA device, contiguity, bf16 or f32 throughout, a built head
    dim, 16-byte aligned rows, a grid of ``rows_per_block`` rows a block
    within its limit; the device."""
    device = check_cuda(name, q=q, **kv)
    if q.dtype not in _SUFFIX or any(t.dtype != q.dtype
                                     for t in kv.values()):
        raise TypeError(f"{name}: dtypes q {q.dtype}, " + ", ".join(
            f"{n} {t.dtype}" for n, t in kv.items())
            + "; expected all bfloat16 or all float32")
    d = q.shape[2]
    if d not in dims:
        raise ValueError(f"{name}: head dim {d}, expected one of {dims}")
    rows = max(t.shape[1] for t in (q, *kv.values()))
    if -(-rows // rows_per_block) > 65535:
        raise ValueError(f"{name}: {rows} rows, above the kernel's grid")
    if any(t.data_ptr() % 16 for t in (q, *kv.values())):
        raise ValueError(f"{name}: operands not 16-byte aligned")
    return device


def flash_attention_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float, causal: bool, window: int, kv_len: int,
                       q_offset: int, lse: bool = False):
    """K7 on the card: q [BH, Tq, d], k / v [BH, Tk, d] -> [BH, Tq, d];
    with ``lse`` (a call of Tq > 1) -> (out, lse [BH, Tq] float32)."""
    device = _check_operands("flash_attention_bh", HEAD_DIMS, q,
                             rows_per_block=FWD_ROWS.get(q.dtype, 1),
                             k=k, v=v)
    BH, Tq, d = q.shape
    Tk = k.shape[1]
    out = torch.empty_like(q)
    lse_out = (torch.empty(BH, Tq, dtype=torch.float32, device=device)
               if lse else None)
    if lse and Tq == 1:
        raise ValueError("flash_attention_bh: the log-sum-exp is written by "
                         "the prefill kernel (Tq > 1), not by the decode")
    if not out.numel():
        return (out, lse_out) if lse else out
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
                   out.data_ptr(), lse_out.data_ptr() if lse else None,
                   BH, Tq, Tk, d, float(scale), int(causal), int(window),
                   int(kv_len), int(q_offset))
    return (out, lse_out) if lse else out


def flash_attention_bh_bwd(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, o: torch.Tensor,
                           lse: torch.Tensor, do: torch.Tensor, scale: float,
                           causal: bool, window: int):
    """K7's backward on the card for a prefill call over all its keys from
    position 0: (dq, dk, dv) in the inputs' dtype.  Three launches: the
    rows' D = rowsum(dO o) into an fp32 scratch, then dK / dV by key
    tiles and dQ by query tiles."""
    device = _check_operands("flash_attention_bh_bwd", BWD_HEAD_DIMS, q,
                             rows_per_block=min(BWD_ROWS.values()),
                             k=k, v=v, o=o, do=do)
    check_cuda("flash_attention_bh_bwd", lse=lse)
    BH, Tq, d = q.shape
    Tk = k.shape[1]
    if o.shape != q.shape or do.shape != q.shape \
            or lse.shape != (BH, Tq) or lse.dtype != torch.float32:
        raise ValueError(
            f"flash_attention_bh_bwd: o {tuple(o.shape)}, do "
            f"{tuple(do.shape)}, lse {tuple(lse.shape)} {lse.dtype}; "
            f"expected {tuple(q.shape)} twice and ({BH}, {Tq}) float32")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if not (dq.numel() or dk.numel()):
        return dq, dk, dv
    delta = torch.empty(BH, Tq, dtype=torch.float32, device=device)
    BWD_LIBRARY.launch(
        "flash_attention_bh_bwd", f"repro_flash_attention_bh_bwd_"
        f"{_SUFFIX[q.dtype]}", device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH,
        Tq, Tk, d, float(scale), int(causal), int(window), cuda_launches=3)
    return dq, dk, dv
