"""Shared model substrate: config, lane mesh, norms, rotary embeddings, init.

Ported from ``repro.models.common``.  :class:`ArchConfig` keeps the
reference's fields and defaults (``dtype`` defaults to bfloat16).
Parameters are plain dicts of tensors, per-layer parameters stacked on a
leading layer dim, as in ``repro``.  ``count_params_analytic`` and
``apply_mrope`` (Qwen2-VL's sectioned RoPE) are ``repro``'s.

:class:`Mesh` stands in for a JAX device mesh: the port runs every device
of the mesh as a lane stacked on one card, so a mesh is only its axis names
and sizes.  :class:`Initializer` draws from its own seeded
``torch.Generator`` on the target device with the reference's fan-in
scales; its numbers differ from ``repro``'s, and parity tests carry the
reference's weights over instead (:mod:`repro_torch.models.convert`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as tf

from .. import resolve_device


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | ssm | moe | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None          # default d_model // n_heads
    qkv_bias: bool = False
    act: str = "silu"                     # silu | gelu | relu2
    gated_mlp: bool = True                # False: plain act(xW_up)W_down
    rope_theta: float = 10000.0
    partial_rotary: float = 1.0
    qk_norm: bool = False
    sandwich_norm: bool = False
    tie_embeddings: bool = False
    window: int = 0                       # sliding window; 0 = full
    local_global_period: int = 0
    mrope_sections: Optional[Tuple[int, int, int]] = None
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0           # deepseek: first k layers dense
    router_aux_coef: float = 0.001
    # MLA (deepseek)
    mla: bool = False
    kv_lora: int = 0
    q_lora: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    d_conv: int = 4
    # hybrid (zamba2)
    shared_attn_period: int = 0
    n_shared_attn_blocks: int = 0
    # encoder-decoder (seamless)
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    frontend_stub: bool = False
    max_seq: int = 131072
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_is_global(self, i: int) -> bool:
        """gemma3-style 5 local : 1 global pattern."""
        if self.local_global_period <= 0:
            return True
        return (i + 1) % self.local_global_period == 0

    def param_count(self) -> int:
        """Analytic parameter count."""
        return count_params_analytic(self)


def count_params_analytic(c: ArchConfig) -> int:
    """``repro``'s analytic count, term for term, for the families the port
    builds (the audio family and the moe family without MLA raise)."""
    dh = c.head_dim
    n = 0
    n += c.vocab * c.d_model                      # embed
    if not c.tie_embeddings:
        n += c.vocab * c.d_model                  # lm head
    mlp_mats = 3 if c.gated_mlp else 2
    if c.family in ("dense", "vlm"):
        per = (
            c.d_model * (c.n_heads * dh)          # q
            + 2 * c.d_model * (c.n_kv_heads * dh)  # k, v
            + (c.n_heads * dh) * c.d_model        # o
            + mlp_mats * c.d_model * c.d_ff       # (gate/)up/down
            + 2 * c.d_model                       # norms
        )
        n += c.n_layers * per
    elif c.family == "moe":
        if not c.mla:
            raise NotImplementedError(
                f"{c.name}: the moe family without MLA is not ported yet")
        att = (
            c.d_model * (c.n_heads * (c.qk_nope_dim + c.qk_rope_dim))
            + c.d_model * (c.kv_lora + c.qk_rope_dim)
            + c.kv_lora * (c.n_heads * (c.qk_nope_dim + c.v_head_dim))
            + (c.n_heads * c.v_head_dim) * c.d_model
        )
        ffe = 3 * c.d_model * c.d_ff_expert
        dense_ff = 3 * c.d_model * c.d_ff if c.d_ff else 0
        moe_layers = c.n_layers - c.first_dense_layers
        n += c.n_layers * (att + 2 * c.d_model)
        n += c.first_dense_layers * dense_ff
        n += moe_layers * (
            c.n_experts * ffe
            + c.n_shared_experts * ffe
            + c.d_model * c.n_experts
        )
    elif c.family in ("ssm", "hybrid"):
        di = c.d_inner
        H = c.n_ssm_heads
        per = (
            c.d_model * (2 * di + 2 * c.ssm_groups * c.ssm_state + H)  # in
            + c.d_conv * (di + 2 * c.ssm_groups * c.ssm_state)         # conv
            + 3 * H                                         # A, D, dt_bias
            + di * c.d_model                                           # out
            + 2 * c.d_model
        )
        n += c.n_layers * per
        if c.family == "hybrid":
            n += c.n_shared_attn_blocks * (
                (2 * c.d_model) * (c.n_heads * dh)    # q from concat(2d)
                + 2 * (2 * c.d_model) * (c.n_kv_heads * dh)
                + (c.n_heads * dh) * c.d_model
                + 3 * c.d_model * c.d_ff
                + 2 * c.d_model
            )
    else:
        raise NotImplementedError(
            f"{c.name}: the {c.family} family is not ported yet")
    return n


@dataclass(frozen=True)
class Mesh:
    """A device mesh as axis names and sizes; its devices are lanes stacked
    on one card.  Axes come from ``("pod", "data", "model")`` in that order,
    and ``"model"`` (the lanes a batch shard's tokens are split over) is
    always there, so a device's flat index is its batch shard's times the
    model size plus its lane."""

    axis_names: Tuple[str, ...] = ("data", "model")
    shape: Tuple[int, ...] = (1, 1)

    def __post_init__(self):
        names = tuple(self.axis_names)
        order = [a for a in ("pod", "data", "model") if a in names]
        if (names != tuple(order) or "model" not in names
                or len(self.shape) != len(names)
                or any(int(s) < 1 for s in self.shape)):
            raise ValueError(
                f"mesh {names} {tuple(self.shape)}: expected axes from "
                "('pod', 'data', 'model') in that order, 'model' among them, "
                "one positive size each"
            )

    @property
    def axes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, (int(s) for s in self.shape)))

    @property
    def size(self) -> int:
        return math.prod(int(s) for s in self.shape)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """Numerics floor: bf16 computes in f32, a wider input keeps its own
    precision."""
    return torch.promote_types(dtype, torch.float32)


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    cdt = compute_dtype(x.dtype)
    xf = x.to(cdt)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + w.to(cdt))).to(x.dtype)


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(torch.relu(x))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return tf.gelu(x, approximate="tanh")    # jax.nn.gelu's default


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return tf.silu
    if name == "gelu":
        return _gelu_tanh
    if name == "relu2":  # nemotron squared ReLU
        return _relu2
    raise ValueError(name)


def rope_freqs(dh_rot: int, theta: float, dtype=torch.float32,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dh_rot, 2, dtype=dtype,
                                         device=device) / dh_rot))


def apply_rope(
    x: torch.Tensor,            # [B, H, T, dh]
    positions: torch.Tensor,    # [B, T] int
    theta: float,
    partial: float = 1.0,
) -> torch.Tensor:
    dh = x.shape[-1]
    dh_rot = int(dh * partial)
    dh_rot -= dh_rot % 2
    cdt = compute_dtype(x.dtype)
    freqs = rope_freqs(dh_rot, theta, dtype=cdt, device=x.device)
    ang = positions[:, None, :, None].to(cdt) * freqs     # [B,1,T,dr/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xr = x[..., :dh_rot].to(cdt)
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    rot = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    rot = rot.reshape(xr.shape).to(x.dtype)
    if dh_rot < dh:
        return torch.cat([rot, x[..., dh_rot:]], dim=-1)
    return rot


def apply_mrope(
    x: torch.Tensor,            # [B, H, T, dh]
    positions3: torch.Tensor,   # [B, 3, T] (t, h, w) position ids
    theta: float,
    sections: Tuple[int, int, int],
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the frequency pairs split into (t, h, w)
    sections, each rotated by its own row of ``positions3``."""
    dh = x.shape[-1]
    cdt = compute_dtype(x.dtype)
    freqs = rope_freqs(dh, theta, dtype=cdt, device=x.device)   # [dh/2]
    sec = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                     for i, s in enumerate(sections)])          # [dh/2]
    pos = positions3.to(cdt).index_select(1, sec)               # [B,dh/2,T]
    ang = pos.transpose(1, 2)[:, None] * freqs                  # [B,1,T,dh/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.to(cdt)
    x1, x2 = xf[..., ::2], xf[..., 1::2]
    rot = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rot.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

_INIT_CHUNK = 1 << 26        # elements drawn in float32 at a time


class Initializer:
    """Seeded truncated-normal initializer on one device.

    Each tensor is drawn from the initializer's ``torch.Generator`` as a
    standard normal truncated to [-2, 2], scaled by ``1/sqrt(fan_in)`` (the
    reference's scales), in float32 chunks of at most ``_INIT_CHUNK``
    elements that are cast into the target dtype, so a 15.7 B-parameter
    model is drawn directly on the card in its own dtype."""

    def __init__(self, seed: int, dtype: torch.dtype, device=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))

    def tensor(self, shape, fan_in: Optional[int] = None, zero: bool = False,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        out = torch.empty(tuple(shape), dtype=dtype or self.dtype,
                          device=self.device)
        if zero:
            return out.zero_()
        fan = fan_in if fan_in else (shape[-2] if len(shape) >= 2
                                     else shape[-1])
        scale = 1.0 / math.sqrt(max(fan, 1))
        flat = out.view(-1)
        for lo in range(0, flat.numel(), _INIT_CHUNK):
            part = flat[lo:lo + _INIT_CHUNK]
            draw = torch.empty(part.shape, dtype=torch.float32,
                               device=self.device)
            torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0,
                                        generator=self.gen)
            part.copy_(draw.mul_(scale))
        return out
