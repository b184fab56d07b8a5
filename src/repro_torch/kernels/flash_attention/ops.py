"""Public attention op: validation, GQA broadcast, dispatch.

:func:`attention` takes ``[B, H, T, d]`` tensors as ``repro``'s
``kernels.flash_attention.ops.attention`` does: it broadcasts the kv heads
over their query-head groups and flattens (batch, heads) for the kernel.
The Pallas wrapper also pads the sequence dims to its block sizes; the CUDA
kernel masks the ragged edges itself and is built for each head dim the
served models use (``cuda.HEAD_DIMS``), so the port pads nothing; another
head dim raises.  CPU tensors go to the plain version in :mod:`.ref`, CUDA
tensors to the kernel in :mod:`.cuda`.

When a gradient is wanted (grad mode on and q, k or v requiring one),
:func:`flash_attention_bh` runs through :class:`FlashAttentionBH`, an
``autograd.Function`` that saves q, k, v, the output and the rows'
log-sum-exp and takes K7's backward: the CUDA kernel on the card, the plain
version on the CPU.  The backward takes a prefill call over all its keys
from position 0 (the training forward's); another call that wants a
gradient raises.  Otherwise nothing is saved and serving runs as it did.
GQA's broadcast stays outside the function, so autograd sums dk / dv over
each query-head group.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import use_kernel
from . import cuda
from .ref import (
    check_backward_form,
    flash_attention_bh_bwd_ref,
    flash_attention_bh_ref,
)


class FlashAttentionBH(torch.autograd.Function):
    """K7 with its backward: q [BH, Tq, d], k / v [BH, Tk, d] ->
    [BH, Tq, d], a prefill call over all its keys from position 0."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool, window: int):
        if use_kernel(q, k, v):
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            out, lse = cuda.flash_attention_bh(
                q, k, v, scale, causal, int(window), k.shape[1], 0, lse=True)
        else:
            out, lse = flash_attention_bh_ref(
                q, k, v, scale=scale, causal=causal, window=window,
                return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, int(window))
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        scale, causal, window = ctx.args
        dq, dk, dv = flash_attention_bh_bwd(q, k, v, out, lse, do,
                                            scale=scale, causal=causal,
                                            window=window)
        return dq, dk, dv, None, None, None


def flash_attention_bh_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *, scale: float, causal: bool,
    window: int = 0,
):
    """K7's backward over flattened (batch * heads) for a prefill call over
    all its keys from position 0: (dq, dk, dv) from the forward's q, k, v,
    output o and lse and the output's gradient do; the kernel on the card,
    the plain version on the CPU."""
    check_backward_form(q.shape[1], k.shape[1], k.shape[1], 0)
    if not use_kernel(q, k, v, o, lse, do):
        return flash_attention_bh_bwd_ref(q, k, v, o, lse, do, scale=scale,
                                          causal=causal, window=window)
    return cuda.flash_attention_bh_bwd(
        q.contiguous(), k.contiguous(), v.contiguous(), o.contiguous(),
        lse.contiguous(), do.contiguous(), float(scale), bool(causal),
        int(window))


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        check_backward_form(q.shape[1], Tk, kv_len, int(q_offset))
        return FlashAttentionBH.apply(q, k, v, float(scale), bool(causal),
                                      int(window))
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
