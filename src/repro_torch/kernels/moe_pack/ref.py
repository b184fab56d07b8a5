"""Plain torch versions of the MoE pack / combine kernels (K5, K6).

They are the CPU path of :mod:`repro_torch.kernels.moe_pack.ops` and the
values the CUDA kernels are held against on the card.  They follow the
kernels' index rule: an index outside the row table (negative, or at or
past its last row) reads a zero row, and no index raises.
"""
from __future__ import annotations

import torch


def _in_range(idx: torch.Tensor, rows: int):
    """(whether each index lies in [0, rows), the index with the others
    at row 0)."""
    idx = idx.long()
    real = (idx >= 0) & (idx < rows)
    return real, torch.where(real, idx, 0)


def gather_rows_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K5: ``out[i] = x[idx[i]]``, a zero row for an index outside
    ``[0, N)``."""
    N = x.shape[0]
    if N == 0:
        return x.new_zeros((idx.shape[0],) + x.shape[1:])
    real, safe = _in_range(idx, N)
    return torch.where(real[:, None], x[safe], x.new_zeros(()))


def combine_rows_ref(buf: torch.Tensor, idx: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """K6: ``out[t] = sum_k w[t, k] * buf[idx[t, k]]``, accumulated in
    float32 in ascending k and cast once to ``buf``'s dtype.  An index
    outside ``[0, N)`` adds exactly zero, whatever its weight."""
    return combine_lanes_ref(buf[None], idx[None], w[None])[0]


def combine_lanes_ref(buf: torch.Tensor, idx: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """K6 over lanes: ``out[g, n] = sum_k w[g, n, k] * buf[g, idx[g, n, k]]``
    (buf [G, R, D], idx / w [G, N, K]), accumulated in float32 in ascending
    k and cast once to ``buf``'s dtype.  An index outside ``[0, R)`` (the
    MoE layer's dropped-pair sentinel ``R``) adds exactly zero, whatever
    its weight."""
    G, R, D = buf.shape
    acc = torch.zeros(idx.shape[:2] + (D,), dtype=torch.float32,
                      device=buf.device)
    if R == 0:
        return acc.to(buf.dtype)
    real, safe = _in_range(idx, R)
    lane = torch.arange(G, device=idx.device)[:, None, None] * R
    flat = safe + lane
    table = buf.reshape(G * R, D)
    wf = w.float()
    for k in range(idx.shape[2]):
        term = wf[..., k:k + 1] * table[flat[..., k]].float()
        acc = acc + torch.where(real[..., k:k + 1], term, 0.0)
    return acc.to(buf.dtype)
