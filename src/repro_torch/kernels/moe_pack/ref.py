"""Plain torch versions of the MoE pack / combine kernels (K5, K6).

They are the CPU path of :mod:`repro_torch.kernels.moe_pack.ops` and the
values the CUDA kernels are held against on the card.  An index outside the
row table raises, but for :func:`combine_lanes_ref`'s sentinels (an index
at or past a lane's last row adds zero).
"""
from __future__ import annotations

import torch


def gather_rows_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K5: ``out[i] = x[idx[i]]``."""
    return x[idx.long()]


def combine_rows_ref(buf: torch.Tensor, idx: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """K6: ``out[t] = sum_k w[t, k] * buf[idx[t, k]]``, accumulated in
    float32 in ascending k and cast once to ``buf``'s dtype."""
    idx = idx.long()
    wf = w.float()
    acc = torch.zeros((idx.shape[0], buf.shape[1]), dtype=torch.float32,
                      device=buf.device)
    for k in range(idx.shape[1]):
        acc = acc + wf[:, k:k + 1] * buf[idx[:, k]].float()
    return acc.to(buf.dtype)


def combine_lanes_ref(buf: torch.Tensor, idx: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """K6 over lanes: ``out[g, n] = sum_k w[g, n, k] * buf[g, idx[g, n, k]]``
    (buf [G, R, D], idx / w [G, N, K]), accumulated in float32 in ascending
    k and cast once to ``buf``'s dtype.  An index ``>= R`` adds exactly
    zero, whatever its weight; a negative index raises."""
    G, R, D = buf.shape
    idx = idx.long()
    if idx.numel() and bool((idx < 0).any()):
        raise IndexError("combine_lanes_ref: negative index")
    real = idx < R
    lane = torch.arange(G, device=idx.device)[:, None, None] * R
    flat = torch.where(real, idx, 0) + lane
    table = buf.reshape(G * R, D)
    wf = w.float()
    acc = torch.zeros(idx.shape[:2] + (D,), dtype=torch.float32,
                      device=buf.device)
    for k in range(idx.shape[2]):
        term = wf[..., k:k + 1] * table[flat[..., k]].float()
        acc = acc + torch.where(real[..., k:k + 1], term, 0.0)
    return acc.to(buf.dtype)
