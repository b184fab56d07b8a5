"""Public SSD ops: the batched chunked scan (K8) and the one-token step.

:func:`ssd` takes the model's layout, as ``repro``'s ``ops.ssd`` does:
x ``[Bt, T, H, P]``, dt ``[Bt, T, H]`` (post-softplus), A ``[H]``
(negative), B / C ``[Bt, T, G, N]`` with ``H % G == 0``, and any T.  The
Pallas wrapper repeats B and C over the heads of each group, moves the
heads to the front and pads T to the chunk; the CUDA kernel reads the
group of head h as ``h // (H // G)`` and bounds the ragged last chunk
itself, so the port passes the tensors as they are.  CPU tensors go to the
plain version in :mod:`.ref`, CUDA tensors to the kernel in :mod:`.cuda`.

:func:`ssd_decode_step` is a plain op, as in ``repro``: serving's
one-token recurrence.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import use_kernel
from . import cuda
from .ref import ssd_scan_ref

DEFAULT_CHUNK = 128


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        B: torch.Tensor, C: torch.Tensor, *,
        chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Batched SSD with B / C groups broadcast over heads -> y [Bt, T, H, P]
    in x's dtype.  ``chunk`` is the plain version's; the kernel takes its
    own (every chunk computes the same function)."""
    if x.dim() != 4 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError(f"ssd: x {tuple(x.shape)} / B {tuple(B.shape)} / C "
                         f"{tuple(C.shape)}: expected [Bt, T, H, P] and two "
                         "equal [Bt, T, G, N]")
    Bt, T, H, _ = x.shape
    G = B.shape[2]
    if (tuple(B.shape[:2]) != (Bt, T) or tuple(dt.shape) != (Bt, T, H)
            or tuple(A.shape) != (H,) or G < 1 or H % G):
        raise ValueError(f"ssd: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, B/C {tuple(B.shape)}: expected "
                         "dt [Bt, T, H], A [H] and H a multiple of G")
    if not use_kernel(x, dt, A, B, C):
        return ssd_scan_ref(x, dt, A, B, C, chunk=chunk)
    return cuda.ssd_scan(x.contiguous(), dt.to(torch.float32).contiguous(),
                         A.to(torch.float32).contiguous(),
                         B.to(x.dtype).contiguous(),
                         C.to(x.dtype).contiguous())


def ssd_decode_step(
    S: torch.Tensor,    # [Bt, H, N, P] running state (float32)
    x: torch.Tensor,    # [Bt, H, P]
    dt: torch.Tensor,   # [Bt, H]
    A: torch.Tensor,    # [H]
    B: torch.Tensor,    # [Bt, G, N]
    C: torch.Tensor,    # [Bt, G, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the recurrence for serving: (S_new, y [Bt, H, P] in x's
    dtype)."""
    rep = x.shape[1] // B.shape[1]
    Bh = B.repeat_interleave(rep, dim=1)                  # [Bt, H, N]
    Ch = C.repeat_interleave(rep, dim=1)
    a = torch.exp(dt * A[None, :])[..., None, None]       # [Bt, H, 1, 1]
    S_new = a * S + (dt[..., None] * Bh)[..., None] * x[:, :, None, :]
    y = torch.einsum("bhn,bhnp->bhp", Ch.to(S_new.dtype), S_new)
    return S_new, y.to(x.dtype)
