"""Transformer blocks: the gated MLP (DeepSeek's leading dense layer and its
shared experts, the hybrid's shared blocks) and the dense block of the
``dense`` and ``vlm`` families (ported from ``repro.models.blocks``:
``init_mlp``, ``mlp``, ``init_dense_block``, ``dense_block``; the
cross-attention of the audio family's decoder is not ported yet)."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from .attention import gqa_attention, init_gqa
from .common import ArchConfig, Initializer, activation, rms_norm


def init_mlp(init: Initializer, d: int, f: int, L: int,
             gated: bool = True) -> Dict:
    p = {
        "w_up": init.tensor((L, d, f), fan_in=d),
        "w_down": init.tensor((L, f, d), fan_in=f),
    }
    if gated:
        p["w_gate"] = init.tensor((L, d, f), fan_in=d)
    return p


def mlp(p: Dict, x: torch.Tensor, act: str) -> torch.Tensor:
    fn = activation(act)
    if "w_gate" in p:
        return (fn(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    return fn(x @ p["w_up"]) @ p["w_down"]


def init_dense_block(init: Initializer, cfg: ArchConfig, L: int) -> Dict:
    p = {
        "ln1": init.tensor((L, cfg.d_model), zero=True),
        "ln2": init.tensor((L, cfg.d_model), zero=True),
        "attn": init_gqa(init, cfg, L),
        "mlp": init_mlp(init, cfg.d_model, cfg.d_ff, L,
                        gated=cfg.gated_mlp),
    }
    if cfg.sandwich_norm:
        p["ln1_post"] = init.tensor((L, cfg.d_model), zero=True)
        p["ln2_post"] = init.tensor((L, cfg.d_model), zero=True)
    return p


def dense_block(
    p: Dict,                       # single-layer slice
    x: torch.Tensor,               # [B, T, d]
    positions,
    cfg: ArchConfig,
    window: int = 0,
    attn: Callable = gqa_attention,
    **attn_kw,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Pre-norm attention and MLP, each output normed again under
    ``sandwich_norm`` (gemma3) before its residual add.  ``attn`` is called
    as ``attn(p["attn"], h, positions, cfg, window=window, **attn_kw)``:
    ``gqa_attention`` in the forward, the serving prefill / decode calls
    (``positions`` then as they take it) in ``models.serving``.  Returns
    (x, the attention's cache)."""
    h = rms_norm(x, p["ln1"])
    a, new_cache = attn(p["attn"], h, positions, cfg, window=window,
                        **attn_kw)
    if cfg.sandwich_norm:
        a = rms_norm(a, p["ln1_post"])
    x = x + a
    m = mlp(p["mlp"], rms_norm(x, p["ln2"]), cfg.act)
    if cfg.sandwich_norm:
        m = rms_norm(m, p["ln2_post"])
    return x + m, new_cache
