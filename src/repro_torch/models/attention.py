"""DeepSeek-style MLA attention (compressed KV cache with decoupled RoPE).

Ported from ``repro.models.attention`` (``init_mla``, ``mla_attention``);
GQA and cross-attention are still to port (ROADMAP Queue 1 item 11).  The
attention itself runs through K7 (:mod:`repro_torch.kernels.flash_attention`).

Cache contract (as in ``repro``): without a cache the call attends over its
own T tokens; with a compressed cache ``[B, S, kv_lora + rope]`` the new
entries are written at ``kv_len`` and the kernel masks keys at or past
``kv_len + T``.  Unlike ``jax.lax.dynamic_update_slice`` the port writes the
new entries into the given cache in place (no second S-long cache per
layer) and returns that same tensor.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as tf

from ..kernels.flash_attention import attention as flash
from .common import ArchConfig, Initializer, apply_rope, rms_norm


def init_mla(init: Initializer, cfg: ArchConfig, L: int) -> Dict:
    d = cfg.d_model
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wq": init.tensor((L, d, cfg.n_heads * qk), fan_in=d),
        "w_dkv": init.tensor((L, d, cfg.kv_lora + cfg.qk_rope_dim), fan_in=d),
        "kv_norm": init.tensor((L, cfg.kv_lora), zero=True),
        "w_uk": init.tensor((L, cfg.kv_lora, cfg.n_heads * cfg.qk_nope_dim),
                            fan_in=cfg.kv_lora),
        "w_uv": init.tensor((L, cfg.kv_lora, cfg.n_heads * cfg.v_head_dim),
                            fan_in=cfg.kv_lora),
        "wo": init.tensor((L, cfg.n_heads * cfg.v_head_dim, d),
                          fan_in=cfg.n_heads * cfg.v_head_dim),
    }


def mla_attention(
    p: Dict,
    x: torch.Tensor,               # [B, T, d]
    positions: torch.Tensor,       # [B, T]
    cfg: ArchConfig,
    cache: Optional[torch.Tensor] = None,   # [B, S, kv_lora + rope]
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    B, T, _ = x.shape
    H, lora = cfg.n_heads, cfg.kv_lora
    nope, vd = cfg.qk_nope_dim, cfg.v_head_dim
    qk = nope + cfg.qk_rope_dim

    q = (x @ p["wq"]).reshape(B, T, H, qk).transpose(1, 2)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    ckv_new = x @ p["w_dkv"]                       # [B, T, lora+rope]
    # rope part of k is shared across heads, rotated at its own position
    k_rope_new = apply_rope(ckv_new[:, None, :, lora:], positions,
                            cfg.rope_theta)[:, 0]
    ckv_new = torch.cat([ckv_new[..., :lora], k_rope_new], dim=-1)

    new_cache = None
    if cache is not None:
        start = int(kv_len) if kv_len is not None else 0
        if not 0 <= start <= cache.shape[1] - T:
            raise ValueError(f"mla_attention: {T} entries at {start} do not "
                             f"fit a cache of {cache.shape[1]}")
        cache[:, start:start + T] = ckv_new.to(cache.dtype)
        new_cache = ckv = cache
        total, q_offset = start + T, start
    else:
        ckv, total, q_offset = ckv_new, T, 0

    S = ckv.shape[1]
    c = rms_norm(ckv[..., :lora], p["kv_norm"])
    k_nope = (c @ p["w_uk"]).reshape(B, S, H, nope).transpose(1, 2)
    v = (c @ p["w_uv"]).reshape(B, S, H, vd).transpose(1, 2)
    k_rope = ckv[:, None, :, lora:].expand(B, H, S, cfg.qk_rope_dim)
    k = torch.cat([k_nope, k_rope], dim=-1)
    qfull = torch.cat([q_nope, q_rope], dim=-1)

    # pad v's head dim up to qk's for the shared kernel, slice after
    if vd < qk:
        v = tf.pad(v, (0, qk - vd))
    out = flash(qfull, k, v, causal=True, kv_len=total, q_offset=q_offset,
                scale=qk ** -0.5)
    out = out[..., :vd].transpose(1, 2).reshape(B, T, H * vd)
    return out @ p["wo"], new_cache
