"""Mamba-2 (SSD) block: projections, depthwise conv, SSD scan, gated norm.

Ported from ``repro.models.ssm`` (``init_mamba``, ``_causal_conv``,
``_final_ssm_state``, ``mamba_block``, ``init_mamba_state``) with the
reference's casts: dt and A in float32, the D skip in float32, y back in
the model's dtype before the gated norm.  Used by mamba2-780m (a pure SSM
stack) and zamba2-7b (the hybrid backbone).  The scan runs through K8
(:mod:`repro_torch.kernels.ssd_scan`); serving keeps O(1) state per layer,
the conv tail and the SSM state, and decodes with the plain
``ssd_decode_step``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as tf

from ..kernels.ssd_scan import ssd, ssd_decode_step
from .common import ArchConfig, Initializer, rms_norm

F32 = torch.float32


def init_mamba(init: Initializer, cfg: ArchConfig, L: int) -> Dict:
    d, di = cfg.d_model, cfg.d_inner
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
    K = cfg.d_conv
    return {
        "norm": init.tensor((L, d), zero=True),
        "wz": init.tensor((L, d, di), fan_in=d),
        "wx": init.tensor((L, d, di), fan_in=d),
        "wB": init.tensor((L, d, G * N), fan_in=d),
        "wC": init.tensor((L, d, G * N), fan_in=d),
        "wdt": init.tensor((L, d, H), fan_in=d),
        "conv_x": init.tensor((L, K, di), fan_in=K),
        "conv_B": init.tensor((L, K, G * N), fan_in=K),
        "conv_C": init.tensor((L, K, G * N), fan_in=K),
        "A_log": init.tensor((L, H), zero=True),       # A = -exp(A_log)
        "D": init.tensor((L, H), zero=True),
        "dt_bias": init.tensor((L, H), zero=True),
        "out_norm": init.tensor((L, di), zero=True),
        "wo": init.tensor((L, di, d), fan_in=di),
    }


def _conv_taps(xp: torch.Tensor, w: torch.Tensor, T: int) -> torch.Tensor:
    """sum_i xp[:, i:i+T] * w[i]: the depthwise conv over a padded input."""
    out = xp[:, :T] * w[0]
    for i in range(1, w.shape[0]):
        out = out + xp[:, i:i + T] * w[i]
    return out


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv + SiLU.  x: [B, T, Cdim], w: [K, Cdim];
    ``tail``: [B, K-1, Cdim] cached inputs."""
    K = w.shape[0]
    pad = (torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device)
           if tail is None else tail.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)                      # [B, T+K-1, C]
    return tf.silu(_conv_taps(xp, w, x.shape[1]))


def _final_ssm_state(xc, dt, A, Bc, cfg: ArchConfig) -> torch.Tensor:
    """State after the whole sequence (the prefill -> decode handoff).
    xc: [B,T,H,P], dt: [B,T,H], Bc: [B,T,G,N] -> [B,H,N,P] (f32)."""
    H, G = cfg.n_ssm_heads, cfg.ssm_groups
    Bh = Bc.repeat_interleave(H // G, dim=2).to(F32)     # [B,T,H,N]
    la = dt * A[None, None, :]                           # [B,T,H]
    rev = la.sum(dim=1, keepdim=True) - la.cumsum(dim=1)
    w = torch.exp(rev) * dt                              # decay s -> T
    return torch.einsum("bthn,bthp->bhnp", Bh * w[..., None], xc.to(F32))


def mamba_block(
    p: Dict,                      # single-layer slice
    x: torch.Tensor,              # [B, T, d]
    cfg: ArchConfig,
    state: Optional[Dict] = None,  # decode: {"conv": [B,K-1,Cc], "ssm": [B,H,N,P]}
    return_state: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    B, T, _ = x.shape
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
    P, di = cfg.ssm_head_dim, cfg.d_inner
    h = rms_norm(x, p["norm"])
    z = h @ p["wz"]                                      # [B, T, di]
    xin = h @ p["wx"]
    Bin = h @ p["wB"]
    Cin = h @ p["wC"]
    dt = tf.softplus(h.to(F32) @ p["wdt"].to(F32)
                     + p["dt_bias"].to(F32))             # [B, T, H]
    A = -torch.exp(p["A_log"].to(F32))                   # [H]

    new_state = None
    if state is None:
        xc = _causal_conv(xin, p["conv_x"])
        Bc = _causal_conv(Bin, p["conv_B"])
        Cc = _causal_conv(Cin, p["conv_C"])
        xs = xc.reshape(B, T, H, P)
        y = ssd(xs, dt, A, Bc.reshape(B, T, G, N), Cc.reshape(B, T, G, N))
        if return_state:
            K = cfg.d_conv
            conv_in = torch.cat([xin, Bin, Cin], dim=-1)
            pad = torch.zeros((B, max(0, K - 1 - T), conv_in.shape[-1]),
                              dtype=conv_in.dtype, device=x.device)
            tail = torch.cat([pad, conv_in[:, -(K - 1):]], dim=1)
            S = _final_ssm_state(xs, dt, A, Bc.reshape(B, T, G, N), cfg)
            new_state = {"conv": tail, "ssm": S}
    else:
        conv_in = torch.cat([xin, Bin, Cin], dim=-1)     # [B, 1, Cc]
        full = torch.cat([state["conv"], conv_in], dim=1)
        w = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1)
        out = tf.silu(_conv_taps(full, w, 1))[:, 0]      # [B, Cc]
        xc = out[:, :di]
        Bc = out[:, di:di + G * N]
        Cc = out[:, di + G * N:]
        S, yh = ssd_decode_step(state["ssm"], xc.reshape(B, H, P), dt[:, 0],
                                A, Bc.reshape(B, G, N), Cc.reshape(B, G, N))
        xs = xc.reshape(B, 1, H, P)
        y = yh.reshape(B, 1, H, P)
        new_state = {"conv": full[:, 1:], "ssm": S}

    y = y + p["D"].to(F32)[None, None, :, None] * xs.to(F32)
    y = y.reshape(B, T, di).to(x.dtype)
    y = rms_norm(y, p["out_norm"]) * tf.silu(z)
    return x + y @ p["wo"], new_state


def init_mamba_state(cfg: ArchConfig, B: int, dtype,
                     device=None) -> Dict:
    """Per-layer decode state."""
    Cc = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "conv": torch.zeros((B, cfg.d_conv - 1, Cc), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((B, cfg.n_ssm_heads, cfg.ssm_state,
                            cfg.ssm_head_dim), dtype=F32, device=device),
    }
