"""Serving: prefill and single-token decode for the ``dense``, ``vlm``,
``ssm`` and ``hybrid`` families and the ``moe`` family with MLA.

Ported from ``repro.models.serving`` (``_prefill_attn``, ``_decode_attn``,
``moe_tokens_per_lane``, ``moe_plan_for_model``, ``moe_exchange_probe``,
``prefill``, ``decode_step`` with its pinned ``moe_plan`` and
``return_moe_stats``; ``_moe_ffn`` is
:meth:`repro_torch.models.lm.Model.moe_block`, shared with the training
forward); the audio family is still to port (ROADMAP Queue 1).  The
forward is a Python loop over layers, so per-layer caches may differ:
gemma3's sliding-window layers hold ``window`` slots, its global layers
``max_len``.  The MoE plan is looked up once per call, not once per layer.
Prefill projects only the last position to logits.

Cache invariants.  MLA: each layer keeps a compressed cache
``[B, max_len, kv_lora + rope]``; slots ``[0, cur_len)`` hold the tokens so
far, K's rope part stored post-RoPE at its true position; attention masks
with ``kv_len = cur_len + T`` and ``q_offset = cur_len``.  GQA (dense and
vlm layers, the hybrid's shared blocks): ``{"k", "v"}`` of
``[B, Hkv, Lc, dh]``, ``Lc`` the window or ``max_len``; slots
``[0, filled)`` hold the most recent ``filled = min(cur_len, Lc)`` tokens
in order, K post-RoPE at its true position;
attention masks with ``kv_len = filled`` and ``q_offset = filled - 1``.
Mamba-2 layers keep ``{"conv", "ssm"}`` (:func:`~.ssm.init_mamba_state`).
``decode_step`` writes the new token's attention entries into the caches it
is given, in place, and returns them with the new SSM states.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import attention
from .attention import gqa_project_out, gqa_project_qkv, write_cache
from .blocks import dense_block, mlp
from .common import ArchConfig, rms_norm
from .lm import Model, _stack_slice
from .moe import moe_plan_for
from .ssm import mamba_block


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


def moe_exchange_probe(model: Model, plan, n_tokens: int, cache=None,
                       iters: int = 5, warmup: int = 1):
    """Time ``plan``'s dispatch pattern as a pure exchange: (CommPlan,
    seconds per exchange), or None when there is nothing to probe (dense
    mode, or no plan).

    The online-calibration feed of ``ServeEngine(observe=True)``: a decode
    step's dispatch includes expert compute, so the engine now and then
    runs the same routing pattern as a bare neighborhood exchange on the
    rank-stacked executor (``cache.executor`` on the model's device), whose
    samples are fit-grade.  The collective and its executor go through
    ``cache``, so repeated probes re-plan and re-bind nothing.  The payload
    is float32 with ``d_model * itemsize / 4`` columns, the plan's modeled
    wire bytes a value; each call waits for the device
    (``core.collectives.time_calls``)."""
    from ..core.cache import default_plan_cache
    from ..core.collectives import time_calls
    from .moe import STRATEGY_OF_MODE, dispatch_pattern, dispatch_topology

    if plan is None or plan.mode not in STRATEGY_OF_MODE:
        return None
    cache = cache if cache is not None else default_plan_cache()
    pattern, _stats, _fp = dispatch_pattern(
        plan, moe_tokens_per_lane(model, n_tokens))
    topo = dispatch_topology(plan)
    value_bytes = model.cfg.d_model * model.cfg.dtype.itemsize
    strategy = STRATEGY_OF_MODE[plan.mode]
    coll = cache.collective(pattern, topo, strategy, value_bytes)
    fn = cache.executor(pattern, topo, model.device, strategy=strategy,
                        value_bytes=value_bytes)
    d = max(1, value_bytes // 4)
    n_pad = int(pattern.n_local.max())
    x = torch.as_tensor(
        np.random.default_rng(0).normal(size=(topo.n_procs, n_pad, d))
        .astype(np.float32), device=model.device)
    return coll.plan, time_calls(fn, x, iters, warmup)


# ---------------------------------------------------------------------------
# GQA cache ops
# ---------------------------------------------------------------------------


def _prefill_attn(p_l: Dict, x: torch.Tensor, pos: torch.Tensor, cfg,
                  window: int, max_len: int):
    """Full-sequence attention; returns (out, {"k", "v"} caches of
    ``Lc = window or max_len`` slots holding the last min(T, Lc) tokens)."""
    T = x.shape[1]
    q, k, v = gqa_project_qkv(p_l, x, pos, cfg)
    o = attention.flash(q, k, v, causal=True, window=window)
    out = gqa_project_out(p_l, o, cfg)
    Lc = window if window > 0 else max_len
    if T >= Lc:
        return out, {"k": k[:, :, T - Lc:].contiguous(),
                     "v": v[:, :, T - Lc:].contiguous()}
    B, Hkv, _, dh = k.shape
    cache = {}
    for name, new in (("k", k), ("v", v)):
        cache[name] = torch.zeros((B, Hkv, Lc, dh), dtype=new.dtype,
                                  device=new.device)
        write_cache(cache[name], new, 0)
    return out, cache


def _decode_positions(cfg: ArchConfig, B: int, cur: int,
                      device) -> torch.Tensor:
    """The new token's position ``cur``: [B, 1], or [B, 3, 1] under
    M-RoPE (the same in all three rows)."""
    pos = torch.full((B, 1), cur, dtype=torch.int32, device=device)
    if cfg.mrope_sections is not None:
        return pos[:, None, :].expand(B, 3, 1)
    return pos


def _decode_attn(p_l: Dict, x: torch.Tensor, cur: int, cfg, window: int,
                 cache: Dict):
    """One-token attention against a rolling cache: the new entry is
    appended at slot ``cur`` or, once the cache is full (``cur >= Lc``),
    the cache rolls one slot left and takes it in its last slot; both in
    place."""
    pos = _decode_positions(cfg, x.shape[0], cur, x.device)
    q, k, v = gqa_project_qkv(p_l, x, pos, cfg)   # k roped at its true pos
    ck, cv = cache["k"], cache["v"]
    Lc = ck.shape[2]
    for c, new in ((ck, k), (cv, v)):
        if cur >= Lc:
            c[:, :, :-1] = c[:, :, 1:].clone()
            write_cache(c, new, Lc - 1)
        else:
            write_cache(c, new, cur)
    filled = min(cur + 1, Lc)
    o = attention.flash(q, ck, cv, causal=True, kv_len=filled,
                        q_offset=filled - 1)
    return gqa_project_out(p_l, o, cfg), {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def _empty_mla_cache(model: Model, B: int, max_len: int) -> torch.Tensor:
    cfg = model.cfg
    return torch.zeros((B, max_len, cfg.kv_lora + cfg.qk_rope_dim),
                       dtype=cfg.dtype, device=model.device)


def _prefill_dense(model: Model, params: Dict, x, pos,
                   max_len: int) -> Tuple[torch.Tensor, List]:
    caches = []
    for i, w in enumerate(model.windows):
        x, c = dense_block(_stack_slice(params["blocks"], i), x, pos,
                           model.cfg, w, _prefill_attn, max_len=max_len)
        caches.append(c)
    return x, caches


def _prefill_moe(model: Model, params: Dict, x, pos, max_len: int,
                 moe_plan) -> Tuple[torch.Tensor, List]:
    B, T = x.shape[:2]
    caches = []
    for i in range(model.cfg.first_dense_layers):
        x, ckv = model.dense_layer(_stack_slice(params["dense0"], i), x, pos,
                                   cache=_empty_mla_cache(model, B, max_len),
                                   kv_len=0)
        caches.append({"ckv": ckv})
    plan = moe_plan if moe_plan is not None \
        else moe_plan_for_model(model, B * T)
    for i in range(model.cfg.n_layers - model.cfg.first_dense_layers):
        x, ckv, _ = model.moe_block(_stack_slice(params["blocks"], i), x,
                                    pos, plan,
                                    cache=_empty_mla_cache(model, B, max_len),
                                    kv_len=0)
        caches.append({"ckv": ckv})
    return x, caches


def _prefill_hybrid(model: Model, params: Dict, x, pos,
                    max_len: int) -> Tuple[torch.Tensor, List]:
    cfg = model.cfg
    per = cfg.shared_attn_period
    n_seg = cfg.n_layers // per
    x0 = x
    caches = []
    for seg in range(n_seg):
        for j in range(per):
            x, st = mamba_block(
                _stack_slice(params["mamba_main"], seg * per + j), x, cfg,
                return_state=True)
            caches.append(st)
        sb = model.shared_block(params, seg)
        h = rms_norm(torch.cat([x, x0], dim=-1), sb["ln1"])
        a, c = _prefill_attn(sb["attn"], h, pos, cfg, 0, max_len)
        x = x + a
        x = x + mlp(sb["mlp"], rms_norm(x, sb["ln2"]), cfg.act)
        caches.append(c)
    for j in range(cfg.n_layers - n_seg * per):
        x, st = mamba_block(_stack_slice(params["mamba_tail"], j), x, cfg,
                            return_state=True)
        caches.append(st)
    return x, caches


def prefill(model: Model, params: Dict, inputs: Dict, max_len: int,
            moe_plan=None):
    """Fill caches from a prompt.  Returns (last_logits [B, V], caches).

    ``moe_plan`` pins the MoE dispatch plan instead of the per-(B*T) cached
    one: ``serve.engine`` plans prefill dispatch once for the worst case
    (B * max_len tokens).  The other families ignore it."""
    cfg = model.cfg
    x = model._embed_in(params, inputs)
    B, T = x.shape[:2]
    pos = model._positions(inputs, T, B)
    if cfg.family in ("dense", "vlm"):
        x, caches = _prefill_dense(model, params, x, pos, max_len)
    elif cfg.family == "moe":
        x, caches = _prefill_moe(model, params, x, pos, max_len, moe_plan)
    elif cfg.family == "ssm":
        caches = []
        for i in range(cfg.n_layers):
            x, st = mamba_block(_stack_slice(params["blocks"], i), x, cfg,
                                return_state=True)
            caches.append(st)
    else:
        x, caches = _prefill_hybrid(model, params, x, pos, max_len)
    logits = model._logits(params, rms_norm(x[:, -1:], params["final_norm"]))
    return logits[:, 0], tuple(caches)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _decode_dense(model: Model, params: Dict, x, cur: int,
                  caches: Tuple) -> Tuple[torch.Tensor, List]:
    new_caches = []
    for i, w in enumerate(model.windows):
        x, c = dense_block(_stack_slice(params["blocks"], i), x, cur,
                           model.cfg, w, _decode_attn, cache=caches[i])
        new_caches.append(c)
    return x, new_caches


def _decode_moe(model: Model, params: Dict, x, cur: int, caches: Tuple,
                moe_plan=None, stats: Optional[List] = None
                ) -> Tuple[torch.Tensor, List]:
    """``moe_plan`` pins the dispatch plan (else the cached per-shape one);
    with ``stats`` (a list) each MoE layer appends its (expert_counts,
    dropped)."""
    cfg = model.cfg
    B = x.shape[0]
    pos = torch.full((B, 1), cur, dtype=torch.int32, device=x.device)
    new_caches = []
    n0 = cfg.first_dense_layers
    for i in range(n0):
        x, ckv = model.dense_layer(_stack_slice(params["dense0"], i), x, pos,
                                   cache=caches[i]["ckv"], kv_len=cur)
        new_caches.append({"ckv": ckv})
    plan = moe_plan if moe_plan is not None else moe_plan_for_model(model, B)
    for i in range(cfg.n_layers - n0):
        out = model.moe_block(_stack_slice(params["blocks"], i), x, pos,
                              plan, cache=caches[n0 + i]["ckv"], kv_len=cur,
                              collect=stats is not None)
        x, ckv = out[0], out[1]
        if stats is not None:
            stats.append(out[3])
        new_caches.append({"ckv": ckv})
    return x, new_caches


def _decode_hybrid(model: Model, params: Dict, x, cur: int,
                   caches: Tuple) -> Tuple[torch.Tensor, List]:
    """``x0``, the input of every shared block's concat, is the new token's
    embedding."""
    cfg = model.cfg
    per = cfg.shared_attn_period
    n_seg = cfg.n_layers // per
    x0 = x
    it = iter(caches)
    new_caches = []
    for seg in range(n_seg):
        for j in range(per):
            x, st = mamba_block(
                _stack_slice(params["mamba_main"], seg * per + j), x, cfg,
                state=next(it))
            new_caches.append(st)
        sb = model.shared_block(params, seg)
        h = rms_norm(torch.cat([x, x0], dim=-1), sb["ln1"])
        a, c = _decode_attn(sb["attn"], h, cur, cfg, 0, next(it))
        x = x + a
        x = x + mlp(sb["mlp"], rms_norm(x, sb["ln2"]), cfg.act)
        new_caches.append(c)
    for j in range(cfg.n_layers - n_seg * per):
        x, st = mamba_block(_stack_slice(params["mamba_tail"], j), x, cfg,
                            state=next(it))
        new_caches.append(st)
    return x, new_caches


def decode_step(model: Model, params: Dict, inputs: Dict,
                caches: Tuple, cur_len: int, moe_plan=None,
                return_moe_stats: bool = False):
    """One-token step.  ``inputs``: {"tokens": [B, 1]} or {"embeds":
    [B, 1, d]}; ``cur_len``: tokens
    already in the caches.  Returns (logits [B, V], caches); with
    ``return_moe_stats=True`` also a stats dict: ``expert_counts``, the
    step's routing histogram summed over the MoE layers ([e_log] f32, the
    adaptive re-planner's observation), and ``dropped``, the mean capacity
    drop fraction over them (zeros for the families without MoE layers).
    ``moe_plan`` pins a dispatch plan (adaptive serving) instead of the
    per-shape cached one."""
    cfg = model.cfg
    cur = int(cur_len)
    x = model._embed_in(params, inputs)
    layer_stats: Optional[List] = [] if return_moe_stats else None
    if cfg.family in ("dense", "vlm"):
        x, new_caches = _decode_dense(model, params, x, cur, caches)
    elif cfg.family == "moe":
        x, new_caches = _decode_moe(model, params, x, cur, caches,
                                    moe_plan=moe_plan, stats=layer_stats)
    elif cfg.family == "ssm":
        new_caches = []
        for i in range(cfg.n_layers):
            x, st = mamba_block(_stack_slice(params["blocks"], i), x, cfg,
                                state=caches[i])
            new_caches.append(st)
    else:
        x, new_caches = _decode_hybrid(model, params, x, cur, caches)
    logits = model._logits(params, rms_norm(x, params["final_norm"]))
    if return_moe_stats:
        if layer_stats:
            counts = torch.stack([c for c, _ in layer_stats]).sum(0)
            dropped = torch.stack([d for _, d in layer_stats]).mean()
        else:
            counts = torch.zeros((max(1, cfg.n_experts),),
                                 dtype=torch.float32, device=x.device)
            dropped = torch.zeros((), dtype=torch.float32, device=x.device)
        return logits[:, 0], tuple(new_caches), {
            "expert_counts": counts, "dropped": dropped}
    return logits[:, 0], tuple(new_caches)
