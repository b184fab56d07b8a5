"""Attention: standard GQA and DeepSeek-style MLA (compressed KV cache with
decoupled RoPE).

Ported from ``repro.models.attention`` (``init_gqa``, ``gqa_project_qkv``,
``gqa_project_out``, ``gqa_attention``, ``init_mla``, ``mla_attention``),
GQA with Qwen-style ``qkv_bias``, gemma3's per-head ``qk_norm`` and
Qwen2-VL's M-RoPE (positions ``[B, 3, T]``).  Cross-attention (``kv_x``,
``gqa_cross_from_cache``, ``project_cross_kv``) is still to port with the
audio family (ROADMAP Queue 1): a ``kv_x`` raises
``NotImplementedError``.  The attention itself runs through K7
(:mod:`repro_torch.kernels.flash_attention`), always by this module's
``flash``: the serving and hybrid call sites go through it too, so that
binding ``attention.flash`` reaches every K7 call.

Cache contract (as in ``repro``): without a cache the call attends over its
own T tokens; with a cache the new entries are written at ``kv_len`` and
the kernel masks keys at or past ``kv_len + T``.  Unlike
``jax.lax.dynamic_update_slice`` the port writes the new entries into the
given cache in place (no second S-long cache per layer) and returns that
same tensor.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as tf

from ..kernels.flash_attention import attention as flash
from .common import ArchConfig, Initializer, apply_mrope, apply_rope, rms_norm


# ---------------------------------------------------------------------------
# standard GQA
# ---------------------------------------------------------------------------


def _check_gqa(cfg: ArchConfig, kv_x) -> None:
    if kv_x is not None:
        raise NotImplementedError(
            f"{cfg.name}: cross-attention (kv_x) is not ported yet; it comes "
            "with the audio family (ROADMAP Queue 1)")


def init_gqa(init: Initializer, cfg: ArchConfig, L: int,
             d_in: int = 0) -> Dict:
    d = d_in or cfg.d_model
    dh = cfg.head_dim
    p = {
        "wq": init.tensor((L, d, cfg.n_heads * dh), fan_in=d),
        "wk": init.tensor((L, d, cfg.n_kv_heads * dh), fan_in=d),
        "wv": init.tensor((L, d, cfg.n_kv_heads * dh), fan_in=d),
        "wo": init.tensor((L, cfg.n_heads * dh, cfg.d_model),
                          fan_in=cfg.n_heads * dh),
    }
    if cfg.qkv_bias:
        p["bq"] = init.tensor((L, cfg.n_heads * dh), zero=True)
        p["bk"] = init.tensor((L, cfg.n_kv_heads * dh), zero=True)
        p["bv"] = init.tensor((L, cfg.n_kv_heads * dh), zero=True)
    if cfg.qk_norm:
        p["q_norm"] = init.tensor((L, dh), zero=True)
        p["k_norm"] = init.tensor((L, dh), zero=True)
    return p


def gqa_project_qkv(
    p: Dict,
    x: torch.Tensor,               # [B, T, d]
    positions: torch.Tensor,       # [B, T] (or [B, 3, T] with M-RoPE)
    cfg: ArchConfig,
    rope: bool = True,
    kv_x: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project and (M-)rope q / k / v -> [B, H(q|kv), T, dh]: the bias
    before the head split, the qk-norm before the rope, as ``repro``."""
    _check_gqa(cfg, kv_x)
    B, T, _ = x.shape
    dh = cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, T, cfg.n_heads, dh).transpose(1, 2)
    k = k.reshape(B, T, cfg.n_kv_heads, dh).transpose(1, 2)
    v = v.reshape(B, T, cfg.n_kv_heads, dh).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if rope:
        if cfg.mrope_sections is not None:
            q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        else:
            q = apply_rope(q, positions, cfg.rope_theta, cfg.partial_rotary)
            k = apply_rope(k, positions, cfg.rope_theta, cfg.partial_rotary)
    return q, k, v


def gqa_project_out(p: Dict, o: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """o: [B, Hq, T, dh] -> [B, T, d]."""
    B, H, T, dh = o.shape
    return o.transpose(1, 2).reshape(B, T, H * dh) @ p["wo"]


def write_cache(cache: torch.Tensor, new: torch.Tensor, start: int) -> None:
    """Write ``new`` [B, H, T, dh] into ``cache`` [B, H, S, dh] at slot
    ``start``, in place."""
    T = new.shape[2]
    if not 0 <= start <= cache.shape[2] - T:
        raise ValueError(f"{T} cache entries at {start} do not fit a cache "
                         f"of {cache.shape[2]}")
    cache[:, :, start:start + T] = new.to(cache.dtype)


def gqa_attention(
    p: Dict,                       # single-layer slice of init_gqa params
    x: torch.Tensor,               # [B, T, d]
    positions: torch.Tensor,       # [B, T] (or [B, 3, T] with M-RoPE)
    cfg: ArchConfig,
    window: int = 0,
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # [B,Hkv,S,dh]
    kv_len: Optional[int] = None,  # filled entries
    kv_x: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    _check_gqa(cfg, kv_x)
    T = x.shape[1]
    q, k, v = gqa_project_qkv(p, x, positions, cfg)
    new_cache = None
    if cache is not None:
        ck, cv = cache
        start = int(kv_len) if kv_len is not None else 0
        write_cache(ck, k, start)
        write_cache(cv, v, start)
        new_cache = (ck, cv)
        out = flash(q, ck, cv, causal=True, window=window, kv_len=start + T,
                    q_offset=start)
    else:
        out = flash(q, k, v, causal=True, window=window, kv_len=T,
                    q_offset=0)
    return gqa_project_out(p, out, cfg), new_cache


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


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
