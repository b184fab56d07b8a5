"""Plain torch version of the online-softmax attention kernel (K7).

It materializes the ``[Tq, Tk]`` scores of each (batch * head) row in at
least float32, masks them (padding ``key < kv_len``, causal
``key <= q_offset + row``, window ``key > q_pos - window``) and normalizes.
A row whose every key is masked outputs 0.  It is the CPU path of
:mod:`repro_torch.kernels.flash_attention.ops` and the value the CUDA kernel
is held against on the card; :func:`attention_ref` is the plain version of
``ops.attention``, which a model can be bound to as its oracle.
"""
from __future__ import annotations

import torch


def attention_mask(Tq: int, Tk: int, causal: bool, window: int,
                   kv_len: int, q_offset: int, device) -> torch.Tensor:
    """[Tq, Tk] bool: query row i (at q_offset + i) sees key j."""
    q_pos = q_offset + torch.arange(Tq, device=device)[:, None]
    k_pos = torch.arange(Tk, device=device)[None, :]
    mask = k_pos < kv_len
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window > 0:
        mask = mask & (k_pos > q_pos - window)
    return mask


def flash_attention_bh_ref(
    q: torch.Tensor,          # [BH, Tq, d]
    k: torch.Tensor,          # [BH, Tk, d]
    v: torch.Tensor,          # [BH, Tk, d]
    *,
    scale: float,
    causal: bool,
    window: int = 0,
    kv_len: int | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """K7 over flattened (batch * heads): out [BH, Tq, d] in q's dtype."""
    Tq, Tk = q.shape[1], k.shape[1]
    kv_len = Tk if kv_len is None else int(kv_len)
    cdt = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bqd,bkd->bqk", q.to(cdt), k.to(cdt)) * scale
    mask = attention_mask(Tq, Tk, causal, int(window), kv_len, int(q_offset),
                 q.device)
    s = s.masked_fill(~mask, float("-inf"))
    m = torch.amax(s, dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)                       # masked keys: exp(-inf) = 0
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bqk,bkd->bqd", p, v.to(cdt))
    out = out / torch.where(l == 0, torch.ones_like(l), l)
    return out.to(q.dtype)


def attention_ref(
    q: torch.Tensor,          # [B, Hq, Tq, d]
    k: torch.Tensor,          # [B, Hkv, Tk, d]
    v: torch.Tensor,
    *,
    scale: float | None = None,
    causal: bool = True,
    window: int = 0,
    kv_len: int | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """``ops.attention`` through the plain version: the kv heads broadcast
    over their query-head groups, (batch, heads) flattened."""
    B, Hq, Tq, d = q.shape
    group = Hq // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    Tk = k.shape[2]
    out = flash_attention_bh_ref(
        q.reshape(B * Hq, Tq, d), k.reshape(B * Hq, Tk, d),
        v.reshape(B * Hq, Tk, d), scale=d ** -0.5 if scale is None else scale,
        causal=causal, window=window, kv_len=kv_len, q_offset=q_offset)
    return out.reshape(B, Hq, Tq, d)
