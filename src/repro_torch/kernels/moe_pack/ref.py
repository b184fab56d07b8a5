"""Plain torch versions of the MoE pack / combine kernels (K5, K6).

They are the CPU path of :mod:`repro_torch.kernels.moe_pack.ops` and the
values the CUDA kernels are held against on the card.  An index outside the
row table raises.
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
