"""Plain torch version of the online-softmax attention kernel (K7).

It materializes the ``[Tq, Tk]`` scores of each (batch * head) row in at
least float32, masks them (padding ``key < kv_len``, causal
``key <= q_offset + row``, window ``key > q_pos - window``) and normalizes.
A row whose every key is masked outputs 0.
:func:`flash_attention_bh_bwd_ref` is the plain version of K7's backward
(the CPU path of the ``autograd.Function`` in :mod:`.ops`, and the value
the CUDA backward is held against on the card); ``repro`` has no Pallas
backward, its gradient is ``jax``'s VJP of ``attention_ref``.  It is the CPU path of
:mod:`repro_torch.kernels.flash_attention.ops` and the value the CUDA kernel
is held against on the card; :func:`attention_ref` is the plain version of
``ops.attention``, which a model can be bound to as its oracle.

The kernel computes a call with one query row (a decode step) split over
its keys: :func:`decode_splits` cuts the row's visible keys into splits of
``DECODE_SPLIT``, :func:`flash_decode_partials_ref` reduces each split to
a partial ``(m, l, acc)`` and :func:`flash_decode_combine_ref` combines
them; :func:`flash_decode_ref` is the two in turn, the same function as
:func:`flash_attention_bh_ref` at ``Tq = 1``.

``operand``, where given, is applied to the softmax weights P before the
P V product: the chip smoke's control rounds them once to bf16, which the
kernel must not do.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

DECODE_SPLIT = 64       # keys per split of a one-row call (kSplit)


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
    operand: Optional[Callable] = None,
    return_lse: bool = False,
):
    """K7 over flattened (batch * heads): out [BH, Tq, d] in q's dtype;
    with ``return_lse`` also the rows' log-sum-exp of the scaled scores,
    lse [BH, Tq] in the compute dtype, at least float32 (+inf where a row
    sees no key), which the backward takes."""
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
    if operand is not None:
        p = operand(p)
    out = torch.einsum("bqk,bkd->bqd", p, v.to(cdt))
    out = out / torch.where(l == 0, torch.ones_like(l), l)
    if not return_lse:
        return out.to(q.dtype)
    lse = torch.where(l == 0, float("inf"), m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def check_backward_form(Tq: int, Tk: int, kv_len: int,
                        q_offset: int) -> None:
    """The backward's form: a prefill call (Tq > 1) over all its keys
    (kv_len == Tk) from position 0; anything else raises."""
    if Tq <= 1 or int(kv_len) != Tk or int(q_offset) != 0:
        raise ValueError(
            f"flash_attention_bh backward: Tq {Tq}, kv_len {kv_len} (Tk "
            f"{Tk}), q_offset {q_offset}; the backward takes a prefill "
            "call (Tq > 1) with kv_len == Tk and q_offset == 0")


def flash_attention_bh_bwd_ref(
    q: torch.Tensor,          # [BH, Tq, d]
    k: torch.Tensor,          # [BH, Tk, d]
    v: torch.Tensor,          # [BH, Tk, d]
    o: torch.Tensor,          # [BH, Tq, d], the forward's output
    lse: torch.Tensor,        # [BH, Tq] float32, the forward's lse
    do: torch.Tensor,         # [BH, Tq, d], the output's gradient
    *,
    scale: float,
    causal: bool,
    window: int = 0,
    kv_len: int | None = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7's backward, the kernel's formulas materialized in at least
    float32: P = exp(S scale - lse) on the visible keys (0 elsewhere),
    D = rowsum(dO o), dV = P^T dO, dS = P (dO V^T - D),
    dQ = scale dS K, dK = scale dS^T Q; (dq, dk, dv) in the inputs'
    dtypes.  A row that sees no key (lse +inf) has P = 0 and adds
    nothing."""
    Tq, Tk = q.shape[1], k.shape[1]
    kv_len = Tk if kv_len is None else int(kv_len)
    check_backward_form(Tq, Tk, kv_len, q_offset)
    cdt = torch.promote_types(q.dtype, torch.float32)
    qc, kc, vc, oc, dc = (t.to(cdt) for t in (q, k, v, o, do))
    s = torch.einsum("bqd,bkd->bqk", qc, kc) * scale
    mask = attention_mask(Tq, Tk, causal, int(window), kv_len,
                          int(q_offset), q.device)
    p = torch.where(mask, torch.exp(s - lse.to(cdt)[..., None]),
                    torch.zeros((), dtype=cdt, device=q.device))
    delta = (dc * oc).sum(dim=-1, keepdim=True)
    dv = torch.einsum("bqk,bqd->bkd", p, dc)
    ds = p * (torch.einsum("bqd,bkd->bqk", dc, vc) - delta)
    dq = torch.einsum("bqk,bkd->bqd", ds, kc) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, qc) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def decode_splits(Tk: int, kv_len: int, causal: bool, window: int,
                  q_offset: int, split: int = DECODE_SPLIT
                  ) -> Tuple[int, int, int]:
    """(begin, end, splits) of a one-row call: the row at ``q_offset`` sees
    the keys [begin, end), cut into ``splits`` pieces of ``split`` keys
    from ``begin`` (at least one, which is empty when no key is seen)."""
    end = min(int(kv_len), int(Tk))
    if causal:
        end = min(end, int(q_offset) + 1)
    begin = max(0, int(q_offset) - int(window) + 1) if window > 0 else 0
    return begin, end, max(1, -(-(end - begin) // split))


def flash_decode_partials_ref(
    q: torch.Tensor,          # [BH, 1, d]
    k: torch.Tensor,          # [BH, Tk, d]
    v: torch.Tensor,          # [BH, Tk, d]
    *,
    scale: float,
    causal: bool,
    window: int = 0,
    kv_len: int | None = None,
    q_offset: int = 0,
    split: int = DECODE_SPLIT,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each split's partial in at least float32: m [BH, S] the max score
    (-inf where the split sees no key), l [BH, S] the sum of
    exp(score - m), acc [BH, S, d] the sum of exp(score - m) v."""
    BH, Tq, d = q.shape
    Tk = k.shape[1]
    if Tq != 1:
        raise ValueError(f"flash_decode_partials_ref: {Tq} query rows, "
                         "expected 1")
    kv_len = Tk if kv_len is None else int(kv_len)
    begin, end, n = decode_splits(Tk, kv_len, causal, int(window),
                                  int(q_offset), split)
    cdt = torch.promote_types(q.dtype, torch.float32)
    keys = begin + torch.arange(n * split, device=q.device)
    seen = keys < end
    keys = keys.clamp(max=max(Tk - 1, 0))
    kk, vv = k[:, keys].to(cdt), v[:, keys].to(cdt)
    s = torch.einsum("bd,bkd->bk", q[:, 0].to(cdt), kk) * scale
    s = s.masked_fill(~seen, float("-inf")).reshape(BH, n, split)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - torch.where(torch.isinf(m), torch.zeros_like(m),
                                  m)[..., None])
    acc = torch.einsum("bns,bnsd->bnd", p, vv.reshape(BH, n, split, d))
    return m, p.sum(dim=-1), acc


def flash_decode_combine_ref(m: torch.Tensor, l: torch.Tensor,
                             acc: torch.Tensor, dtype) -> torch.Tensor:
    """The partials of each row combined: out [BH, 1, d] in ``dtype``,
    sum_s acc_s exp(m_s - M) / sum_s l_s exp(m_s - M) with M the row's
    max; 0 where no split saw a key."""
    M = torch.amax(m, dim=1, keepdim=True)
    w = torch.exp(m - torch.where(torch.isinf(M), torch.zeros_like(M), M))
    den = (w * l).sum(dim=1)[:, None]
    out = (w[..., None] * acc).sum(dim=1)
    out = out / torch.where(den == 0, torch.ones_like(den), den)
    return out[:, None].to(dtype)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     **kw) -> torch.Tensor:
    """A one-row call split over its keys and combined: equal to
    :func:`flash_attention_bh_ref` at ``Tq = 1``."""
    return flash_decode_combine_ref(*flash_decode_partials_ref(q, k, v, **kw),
                                    q.dtype)
