"""Plain torch versions of the Mamba-2 SSD scan (K8).

Per head: ``S_t = exp(dt_t A) S_{t-1} + dt_t B_t (x) x_t``,
``y_t = C_t S_t``, with an fp32 state ``[N, P]``.

``ssd_ref``          the literal per-timestep recurrence (``repro``'s
                     ``ssd_ref``): the ground truth of the tests.
``ssd_chunked_ref``  the chunked form the kernel computes (``repro``'s
                     ``ssd_chunked_ref``): per chunk an intra-chunk
                     ``[L, L]`` product, the inter-chunk term from the
                     carried state, and the state update.
``ssd_scan_ref``     ``ssd_chunked_ref`` at the kernel's own signature,
                     the model's layout ``x [Bt, T, H, P]``, ``B / C
                     [Bt, T, G, N]``: groups broadcast, T padded to the
                     chunk.  It is the CPU path of ``ops.ssd`` and the
                     value the CUDA kernel is held against on the card.

The decay ``exp(l_t - l_s)`` is masked *before* ``exp``: only the pairs
``s <= t`` enter it, so the exponent is never positive.  ``repro``'s
``ssd_chunked_ref`` computes ``exp(l_t - l_s) * causal`` (``ref.py:61``);
at chunk 128 with dt around 1 the masked-out exponents pass 88, ``exp``
overflows and ``inf * 0`` is NaN (ROADMAP Queue 3).  Everything is
computed in float32 (float64 for float64 x) and rounded once to x's dtype.
``operand``, where given, is applied to each fp32 intermediate that enters
a product (M, the state S entering a chunk, the weighted inputs w x): the
chip smoke's control rounds them once to bf16, which the kernel must not
do.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as tf

F32 = torch.float32


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """x [H, T, P], dt [H, T], A [H], B / C [H, T, N] -> y [H, T, P]."""
    H, T, P = x.shape
    N = B.shape[-1]
    a = torch.exp(dt.to(F32) * A.to(F32)[:, None])            # [H, T]
    S = torch.zeros((H, N, P), dtype=F32, device=x.device)
    ys = []
    for t in range(T):
        S = (a[:, t, None, None] * S
             + (dt[:, t, None].to(F32) * B[:, t].to(F32))[..., None]
             * x[:, t, None, :].to(F32))
        ys.append(torch.einsum("hn,hnp->hp", C[:, t].to(F32), S))
    if not ys:
        return torch.empty_like(x)
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, chunk: int = 128,
                    operand: Optional[Callable] = None) -> torch.Tensor:
    """The chunked form over chunks of ``chunk`` steps (T a multiple of
    it): x [H, T, P], dt [H, T], A [H], B / C [H, T, N] -> y [H, T, P]."""
    H, T, P = x.shape
    N = B.shape[-1]
    if chunk < 1 or T % chunk:
        raise ValueError(f"ssd_chunked_ref: T {T} is not a multiple of the "
                         f"chunk {chunk}")
    nc, L = T // chunk, chunk
    cdt = torch.promote_types(x.dtype, F32)
    op = (lambda t: t) if operand is None else operand
    xc = x.reshape(H, nc, L, P).to(cdt)
    dtc = dt.reshape(H, nc, L).to(cdt)
    Bc = B.reshape(H, nc, L, N).to(cdt)
    Cc = C.reshape(H, nc, L, N).to(cdt)
    l_cum = torch.cumsum(dtc * A.to(cdt)[:, None, None], dim=-1)  # [H,nc,L]
    l_tot = l_cum[..., -1]                                        # [H, nc]

    # intra-chunk: M[t, s] = (C_t . B_s) exp(l_t - l_s) dt_s over s <= t
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    diff = (l_cum[..., :, None] - l_cum[..., None, :]).masked_fill(
        ~causal, float("-inf"))
    cb = torch.einsum("hctn,hcsn->hcts", Cc, Bc)
    M = cb * torch.exp(diff) * dtc[..., None, :]
    y = torch.einsum("hcts,hcsp->hctp", op(M), xc)

    # each chunk's own state contribution, then the carry across chunks:
    # S_in[c] is the state entering chunk c
    w = torch.exp(l_tot[..., None] - l_cum) * dtc                 # [H,nc,L]
    S_chunk = torch.einsum("hcln,hclp->hcnp", Bc, op(w[..., None] * xc))
    S = torch.zeros((H, N, P), dtype=cdt, device=x.device)
    S_in = []
    for c in range(nc):
        S_in.append(S)
        S = torch.exp(l_tot[:, c])[:, None, None] * S + S_chunk[:, c]
    S_in = torch.stack(S_in, dim=1)                               # [H,nc,N,P]
    y = y + torch.exp(l_cum)[..., None] * torch.einsum(
        "hcln,hcnp->hclp", Cc, op(S_in))
    return y.reshape(H, T, P).to(x.dtype)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int = 128,
                 operand: Optional[Callable] = None) -> torch.Tensor:
    """K8's function in the model's layout: x [Bt, T, H, P], dt [Bt, T, H],
    A [H], B / C [Bt, T, G, N] (H % G == 0) -> y [Bt, T, H, P] in x's
    dtype, through :func:`ssd_chunked_ref` at chunk ``min(chunk, T)`` with
    T zero-padded to a multiple of it (a padded step has dt = 0 and x = 0,
    and no earlier output depends on it)."""
    Bt, T, H, P = x.shape
    G = B.shape[2]
    if T == 0:
        return torch.empty_like(x)
    L = min(int(chunk), T)
    pad = (-T) % L

    def heads(t):                  # [Bt, T, H, k] -> [Bt * H, T + pad, k]
        t = t.movedim(2, 1).reshape(Bt * H, T, -1)
        return tf.pad(t, (0, 0, 0, pad)) if pad else t

    rep = H // G
    xh = heads(x)
    Bh = heads(B.repeat_interleave(rep, dim=2))
    Ch = heads(C.repeat_interleave(rep, dim=2))
    dth = heads(dt[..., None])[..., 0]
    y = ssd_chunked_ref(xh, dth, A.repeat(Bt), Bh, Ch, chunk=L,
                        operand=operand)[:, :T]
    return y.reshape(Bt, H, T, P).movedim(1, 2)
