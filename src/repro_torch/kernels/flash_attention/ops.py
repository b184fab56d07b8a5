"""Public attention op: validation, GQA broadcast, dispatch.

:func:`attention` takes ``[B, H, T, d]`` tensors as ``repro``'s
``kernels.flash_attention.ops.attention`` does: it broadcasts the kv heads
over their query-head groups and flattens (batch, heads) for the kernel.
The Pallas wrapper also pads the sequence dims to its block sizes; the CUDA
kernel masks the ragged edges itself and is built for each head dim the
served models use (``cuda.HEAD_DIMS``), so the port pads nothing; another
head dim raises.  CPU tensors go to the plain version in :mod:`.ref`, CUDA
tensors to the kernel in :mod:`.cuda`.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import use_kernel
from . import cuda
from .ref import flash_attention_bh_ref


def flash_attention_bh(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
    causal: bool, window: int = 0, kv_len: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """K7 over flattened (batch * heads): q [BH, Tq, d], k / v [BH, Tk, d]."""
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention_bh: q {tuple(q.shape)} / k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}: expected "
                         "[BH, Tq, d] and two equal [BH, Tk, d]")
    Tk = k.shape[1]
    kv_len = Tk if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= Tk or int(window) < 0 or int(q_offset) < 0:
        raise ValueError(f"flash_attention_bh: kv_len {kv_len} (Tk {Tk}), "
                         f"window {window}, q_offset {q_offset}")
    if not use_kernel(q, k, v):
        return flash_attention_bh_ref(q, k, v, scale=scale, causal=causal,
                                      window=window, kv_len=kv_len,
                                      q_offset=q_offset)
    return cuda.flash_attention_bh(
        q.contiguous(), k.contiguous(), v.contiguous(), scale, causal,
        int(window), kv_len, int(q_offset))


def attention(
    q: torch.Tensor,          # [B, Hq, Tq, d]
    k: torch.Tensor,          # [B, Hkv, Tk, d]
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    causal: bool = True,
    window: int = 0,
    kv_len: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """GQA attention through K7; ``scale`` defaults to ``d ** -0.5``."""
    B, Hq, Tq, d = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"attention: {Hq} query heads over {Hkv} kv heads")
    scale = d ** -0.5 if scale is None else float(scale)
    group = Hq // Hkv
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    out = flash_attention_bh(
        q.reshape(B * Hq, Tq, d), k.reshape(B * Hq, Tk, d),
        v.reshape(B * Hq, Tk, d), scale=scale, causal=causal, window=window,
        kv_len=kv_len, q_offset=q_offset)
    return out.reshape(B, Hq, Tq, d)
