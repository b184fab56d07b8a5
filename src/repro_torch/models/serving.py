"""Serving: prefill and single-token decode for the ``moe`` family with MLA.

Ported from ``repro.models.serving`` (``moe_tokens_per_lane``,
``moe_plan_for_model``, ``prefill``, ``decode_step``; ``_moe_ffn`` is
:meth:`repro_torch.models.lm.Model.moe_block`, shared with the training
forward); the other families and ``moe_exchange_probe`` are still to port
(ROADMAP Queue 1 item 11).  The forward is a Python loop over layers; the
plan is looked up once per call, not once per layer.

Cache invariants (MLA): each layer keeps a compressed cache
``[B, max_len, kv_lora + rope]``; slots ``[0, cur_len)`` hold the tokens so
far, K's rope part stored post-RoPE at its true position.  Attention masks
with ``kv_len = cur_len + T`` and ``q_offset = cur_len``.  ``decode_step``
writes the new token's entry into the caches it is given, in place, and
returns them.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .common import rms_norm
from .lm import Model, _stack_slice
from .moe import moe_plan_for


def moe_tokens_per_lane(model: Model, n_tokens: int) -> int:
    """Per-lane token count a forward of ``n_tokens`` global tokens
    dispatches: the one shape-derivation site of prefill, decode and the
    engine's pre-warmed plans."""
    axes = model.mesh.axes
    n_dev = max(1, math.prod(axes[a] for a in model.batch_axes))
    return max(1, n_tokens // n_dev // axes["model"])


def moe_plan_for_model(model: Model, n_tokens: int, cache=None):
    """The dispatch plan a ``model`` forward uses for ``n_tokens`` global
    tokens (cached: equal token counts re-plan nothing)."""
    return moe_plan_for(
        model.cfg, model.mesh, moe_tokens_per_lane(model, n_tokens),
        mode=model.moe_mode, ep_over_pods=model.ep_over_pods,
        cap_factor=model.moe_cap_factor, params=model.machine_params,
        cache=cache,
    )


def _empty_cache(model: Model, B: int, max_len: int) -> torch.Tensor:
    cfg = model.cfg
    return torch.zeros((B, max_len, cfg.kv_lora + cfg.qk_rope_dim),
                       dtype=cfg.dtype, device=model.device)


def prefill(model: Model, params: Dict, inputs: Dict, max_len: int,
            moe_plan=None):
    """Fill caches from a prompt.  Returns (last_logits [B, V], caches).

    ``moe_plan`` pins the MoE dispatch plan instead of the per-(B*T) cached
    one: ``serve.engine`` plans prefill dispatch once for the worst case
    (B * max_len tokens)."""
    x = model._embed_in(params, inputs)
    B, T = x.shape[:2]
    pos = model._positions(inputs, T, B)
    caches = []
    for i in range(model.cfg.first_dense_layers):
        x, ckv = model.dense_layer(_stack_slice(params["dense0"], i), x, pos,
                                   cache=_empty_cache(model, B, max_len),
                                   kv_len=0)
        caches.append({"ckv": ckv})
    plan = moe_plan if moe_plan is not None \
        else moe_plan_for_model(model, B * T)
    for i in range(model.cfg.n_layers - model.cfg.first_dense_layers):
        x, ckv, _ = model.moe_block(_stack_slice(params["blocks"], i), x,
                                    pos, plan,
                                    cache=_empty_cache(model, B, max_len),
                                    kv_len=0)
        caches.append({"ckv": ckv})
    logits = model._logits(params, rms_norm(x[:, -1:], params["final_norm"]))
    return logits[:, 0], tuple(caches)


def decode_step(model: Model, params: Dict, inputs: Dict,
                caches: Tuple, cur_len: int):
    """One-token step.  ``inputs``: {"tokens": [B, 1]}; ``cur_len``: tokens
    already in the caches.  Returns (logits [B, V], caches)."""
    cfg = model.cfg
    cur = int(cur_len)
    x = model._embed_in(params, inputs)
    B = x.shape[0]
    pos = torch.full((B, 1), cur, dtype=torch.int32, device=x.device)
    new_caches = []
    n0 = cfg.first_dense_layers
    for i in range(n0):
        x, ckv = model.dense_layer(_stack_slice(params["dense0"], i), x, pos,
                                   cache=caches[i]["ckv"], kv_len=cur)
        new_caches.append({"ckv": ckv})
    plan = moe_plan_for_model(model, B)
    for i in range(cfg.n_layers - n0):
        x, ckv, _ = model.moe_block(_stack_slice(params["blocks"], i), x,
                                    pos, plan, cache=caches[n0 + i]["ckv"],
                                    kv_len=cur)
        new_caches.append({"ckv": ckv})
    logits = model._logits(params, rms_norm(x, params["final_norm"]))
    return logits[:, 0], tuple(new_caches)
