"""Expert-parallel MoE dispatch with the paper's locality-aware strategies.

Ported from ``repro.models.moe``.  The three transports are the paper's
three collectives mapped onto expert parallelism (EP):

``a2a``        (paper: *standard*) one flat all-to-all over the EP group.
``hier``       (paper: *partially optimized*) first a hop over the fast
               ``model`` axis inside a pod, so that lane m holds everything
               bound for remote lane m, then one message per pod pair over
               the slow ``pod`` axis.
``hier_dedup`` (paper: *fully optimized*) each distinct token crosses to a
               destination region once, with int32 fan-out metadata, and is
               replicated to its expert slots inside the region (K5).
``dense``      no dispatch: every lane computes its expert shard for all
               tokens of its batch shard (the baseline).
``auto``       the Section-5 selector: the batch's routing pattern as a
               ``CommPattern``, the three transports scored with the
               locality-aware max-rate model under explicit
               ``MachineParams``, the cheapest chosen.

Lanes on one card.  ``repro`` runs the dispatch as an SPMD program under
``shard_map`` over a device mesh.  The port runs every device of the mesh as
a lane stacked on a leading dim of one tensor, ``[G, N, D]`` with G the mesh
size in mesh order: routing, capacity packing and the combine are batched
over lanes; K5 packs every lane in one launch (the lanes' row tables
concatenated, each lane's indices offset into its own) and K6 combines
every lane in one launch on the lane-stacked ``[G, R, D]`` table, reading
each lane's rows and its dropped-pair sentinel itself;
a tiled ``all_to_all`` over a set of mesh axes is a permutation that swaps
those axes of the lane dim with the matching chunks of the data dim; the
``psum``/``pmean`` of ``dropped``, ``aux`` and ``expert_counts`` are sums
and means over the lane dim.  Planning is ``repro``'s, unchanged: the same
geometry, routing patterns, fingerprints and selected modes.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.cache import default_plan_cache, pattern_fingerprint
from ..core.costmodel import LASSEN, MachineParams
from ..core.dynexchange import DiscoveryStats, SparseDynamicExchange
from ..core.plan import CommPattern, Topology
from ..core.selection import SelectionReport, select_plan
from ..kernels.moe_pack import combine_lanes as pack_combine_lanes
from ..kernels.moe_pack import pack as pack_gather
from ..obs import default_obs
from .common import ArchConfig, Initializer, Mesh, activation, compute_dtype

_OBS = default_obs()

MODES = ("dense", "a2a", "hier", "hier_dedup")

# paper strategy <-> MoE transport (the Section-5 selector speaks strategy)
STRATEGY_OF_MODE = {"a2a": "standard", "hier": "partial",
                    "hier_dedup": "full"}
MODE_OF_STRATEGY = {v: k for k, v in STRATEGY_OF_MODE.items()}


@dataclasses.dataclass(frozen=True)
class MoEPlan:
    """Static dispatch geometry (the persistent 'init' of the collective)."""

    mode: str
    ep_axes: Tuple[str, ...]     # mesh axes the experts are sharded over
    ep_size: int
    e_log: int                   # logical experts
    e_phys: int                  # after replication
    e_per_dev: int
    top_k: int
    capacity: int                # C: per (src device, physical expert)
    region_axis: str             # slow axis for dedup ('pod' or 'model')
    region_size: int
    devs_per_region: int
    uniq_capacity: int           # Cu: unique tokens per (src lane, region)
    cap_factor: float
    fingerprint: str = ""        # routing-pattern fingerprint (cache identity)

    @property
    def replicas(self) -> int:
        return self.e_phys // self.e_log

    @property
    def ec(self) -> int:         # rows per (src, dst-device) block
        return self.e_per_dev * self.capacity


def make_moe_plan(
    cfg: ArchConfig,
    mesh: Mesh,
    tokens_per_lane: int,
    mode: str = "hier_dedup",
    ep_over_pods: bool = True,
    cap_factor: float = 1.25,
    dedup_factor: Optional[float] = None,
) -> MoEPlan:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    axes = mesh.axes
    has_pod = "pod" in axes and axes["pod"] > 1 and ep_over_pods \
        and mode != "dense"
    ep_axes = ("pod", "model") if has_pod else ("model",)
    ep_size = int(np.prod([axes[a] for a in ep_axes]))
    e_log = cfg.n_experts
    # least replication r >= ceil(ep_size/e_log) with e_log*r divisible by
    # ep_size, so every device hosts the same number of physical experts
    r0 = max(1, math.ceil(ep_size / e_log))
    step = ep_size // math.gcd(e_log, ep_size)
    r = ((r0 + step - 1) // step) * step
    e_phys = e_log * r
    e_per_dev = e_phys // ep_size
    k = cfg.top_k
    N = tokens_per_lane
    cap = max(8, int(math.ceil(k * N / e_phys * cap_factor / 8.0)) * 8)

    region_axis = "pod" if has_pod else "model"
    region_size = axes[region_axis]
    devs_per_region = ep_size // region_size
    pair_bound = devs_per_region * e_per_dev * cap   # exact per-region bound
    if dedup_factor is None:
        # expected distinct tokens hitting a region, with 30% slack
        e_region = devs_per_region * e_per_dev
        frac = 1.0 - (1.0 - e_region / e_phys) ** k
        est = int(math.ceil(N * frac * 1.3))
        uniq = min(pair_bound, min(N, max(8, ((est + 7) // 8) * 8)))
    else:
        uniq = min(pair_bound, max(8, int(pair_bound * dedup_factor)
                                   // 8 * 8))
    return MoEPlan(
        mode=mode, ep_axes=ep_axes, ep_size=ep_size, e_log=e_log,
        e_phys=e_phys, e_per_dev=e_per_dev, top_k=k, capacity=cap,
        region_axis=region_axis, region_size=region_size,
        devs_per_region=devs_per_region, uniq_capacity=uniq,
        cap_factor=cap_factor,
    )


# ---------------------------------------------------------------------------
# planned dispatch: routing pattern -> CommPattern -> Section-5 selection ->
# PlanCache (the persistent 'init' shared with the AMG levels)
# ---------------------------------------------------------------------------


def _pack_routing(
    eids: Sequence[np.ndarray],
    replicas: int,
    e_per_dev: int,
    capacity: int,
    tokens_per_lane: int,
) -> Tuple[CommPattern, DiscoveryStats, str]:
    """Per-lane [N, k] logical-expert assignments -> dispatch CommPattern:
    replicate over physical experts, capacity-pack with the semantics of
    :func:`route` / :func:`capacity_pack` (token-major rank), then discover
    the pattern by the push-side sparse dynamic data exchange."""
    N = tokens_per_lane
    dest: list = []
    local_ids: list = []
    for eid in eids:
        k = eid.shape[1]
        rep = (np.arange(N) % replicas)[:, None]
        phys = (eid * replicas + rep).reshape(-1)
        order = np.argsort(phys, kind="stable")
        sorted_e = phys[order]
        starts = np.r_[0, np.flatnonzero(np.diff(sorted_e)) + 1]
        run_len = np.diff(np.r_[starts, len(phys)])
        rank = np.empty(len(phys), np.int64)
        rank[order] = np.arange(len(phys)) - np.repeat(starts, run_len)
        keep = rank < capacity
        dest.append((phys[keep] // e_per_dev).astype(np.int64))
        local_ids.append((np.repeat(np.arange(N), k)[keep]).astype(np.int64))
    pattern, stats = SparseDynamicExchange.push_pattern(
        dest, local_ids, n_local=[N] * len(eids)
    )
    return pattern, stats, pattern_fingerprint(pattern)


@functools.lru_cache(maxsize=256)
def _routing_pattern(
    ep_size: int,
    e_log: int,
    replicas: int,
    e_per_dev: int,
    capacity: int,
    top_k: int,
    tokens_per_lane: int,
) -> Tuple[CommPattern, DiscoveryStats, str]:
    """Representative dispatch routing of one batch as a ``CommPattern``,
    from a fixed-seed uniform router (deterministic, so the fingerprint is
    stable across calls and processes)."""
    N, k = tokens_per_lane, top_k
    eids = []
    for p in range(ep_size):
        rng = np.random.default_rng(p)
        eids.append(np.argsort(rng.random((N, e_log)), axis=1)[:, :k])
    return _pack_routing(eids, replicas, e_per_dev, capacity, N)


def quantize_histogram(
    hist, e_log: int, quantum: int = 64
) -> Tuple[int, ...]:
    """Normalize an expert histogram to integer counts summing ``quantum``.

    Largest-remainder apportionment, ties to the lower expert id.  Two
    histograms that differ by less than ~1/quantum in every fraction
    quantize identically, so their routing patterns share a fingerprint
    and the adaptive re-planner's lookup hits instead of re-planning."""
    h = np.asarray(hist, dtype=np.float64).reshape(-1)
    if len(h) != e_log:
        raise ValueError(f"histogram has {len(h)} bins, expected {e_log}")
    total = float(h.sum())
    frac = (h / total) if total > 0 else np.full(e_log, 1.0 / e_log)
    raw = frac * quantum
    base = np.floor(raw).astype(np.int64)
    short = quantum - int(base.sum())
    if short > 0:
        order = np.lexsort((np.arange(e_log), -(raw - base)))
        base[order[:short]] += 1
    return tuple(int(x) for x in base)


@functools.lru_cache(maxsize=256)
def _histogram_routing_pattern(
    ep_size: int,
    e_log: int,
    replicas: int,
    e_per_dev: int,
    capacity: int,
    top_k: int,
    tokens_per_lane: int,
    qhist: Tuple[int, ...],
) -> Tuple[CommPattern, DiscoveryStats, str]:
    """Dispatch ``CommPattern`` whose expert marginals follow a measured
    histogram (``qhist``, from :func:`quantize_histogram`) instead of the
    uniform router: each token draws ``top_k`` distinct experts weighted by
    it (Gumbel top-k, lane ``p`` seeded ``100_003 + p``: deterministic
    across calls and processes)."""
    N, k = tokens_per_lane, top_k
    q = np.asarray(qhist, dtype=np.float64)
    frac = q / max(float(q.sum()), 1.0)
    # zero-probability experts stay drawable at ~1e-12, so k distinct
    # experts exist even for a fully collapsed histogram
    logp = np.log(np.maximum(frac, 1e-12))
    eids = []
    for p in range(ep_size):
        rng = np.random.default_rng(100_003 + p)
        g = rng.gumbel(size=(N, e_log))
        eids.append(np.argsort(-(logp[None, :] + g), axis=1)[:, :k])
    return _pack_routing(eids, replicas, e_per_dev, capacity, N)


def dispatch_pattern(
    plan: MoEPlan, tokens_per_lane: int
) -> Tuple[CommPattern, DiscoveryStats, str]:
    """(pattern, discovery stats, fingerprint) of ``plan``'s dispatch."""
    return _routing_pattern(
        plan.ep_size, plan.e_log, plan.replicas,
        plan.e_per_dev, plan.capacity, plan.top_k, tokens_per_lane,
    )


def dispatch_topology(plan: MoEPlan) -> Topology:
    """EP group as a locality topology: regions are pods (or single
    devices when EP does not span pods), pod-major device order."""
    return Topology(plan.ep_size, max(1, plan.devs_per_region))


def _select_mode_over_pattern(
    plan: MoEPlan,
    pattern: CommPattern,
    value_bytes: int,
    params: MachineParams,
) -> Tuple[str, SelectionReport]:
    """Section-5 selection of a transport mode for one routing pattern."""
    _plan, report = select_plan(
        pattern, dispatch_topology(plan), params=params,
        value_bytes=value_bytes,
        candidates=tuple(MODE_OF_STRATEGY),
    )
    return MODE_OF_STRATEGY[report.chosen], report


def select_moe_mode(
    plan: MoEPlan,
    tokens_per_lane: int,
    value_bytes: int,
    params: MachineParams,
) -> Tuple[str, SelectionReport]:
    """Section-5 dynamic selection over a2a / hier / hier_dedup."""
    pattern, _stats, _fp = dispatch_pattern(plan, tokens_per_lane)
    return _select_mode_over_pattern(plan, pattern, value_bytes, params)


def moe_plan_for(
    cfg: ArchConfig,
    mesh: Mesh,
    tokens_per_lane: int,
    mode: str = "auto",
    ep_over_pods: bool = True,
    cap_factor: float = 1.25,
    dedup_factor: Optional[float] = None,
    params: Optional[MachineParams] = None,
    cache=None,
) -> MoEPlan:
    """Cached dispatch planning: the entry point ``lm``, ``serving`` and
    ``serve.engine`` plan through.

    Keyed, as in ``repro``, on (mesh, tokens_per_lane, top_k, mode,
    cap_factor, ...) plus the routing-pattern fingerprint in the
    ``moe_plan`` namespace of ``core.cache.PlanCache``; a repeated call
    re-plans nothing.  ``mode="auto"`` needs ``params``: the port carries
    no machine's figures, so the caller names the model it selects under
    (the paper's ``LASSEN``, for instance)."""
    if mode == "auto" and params is None:
        raise ValueError("moe_plan_for(mode='auto') needs MachineParams: "
                         "pass params= (e.g. core.costmodel.LASSEN)")
    cache = default_plan_cache() if cache is None else cache
    geom = make_moe_plan(
        cfg, mesh, tokens_per_lane,
        mode=("a2a" if mode == "auto" else mode),
        ep_over_pods=ep_over_pods, cap_factor=cap_factor,
        dedup_factor=dedup_factor,
    )
    if geom.mode == "dense":
        return geom
    _pattern, _stats, fp = dispatch_pattern(geom, tokens_per_lane)
    value_bytes = cfg.d_model * cfg.dtype.itemsize
    mesh_key = (tuple(mesh.axis_names), tuple(mesh.shape))
    key = (
        "moe_plan", mesh_key, tokens_per_lane, cfg.n_experts, cfg.top_k,
        mode, ep_over_pods, cap_factor, dedup_factor, value_bytes, params,
        fp,
    )

    def build() -> MoEPlan:
        chosen = mode
        if mode == "auto":
            chosen, _report = select_moe_mode(
                geom, tokens_per_lane, value_bytes, params
            )
        return dataclasses.replace(geom, mode=chosen, fingerprint=fp)

    return cache.moe_plan(key, build)


def moe_plan_from_histogram(
    cfg: ArchConfig,
    mesh: Mesh,
    tokens_per_lane: int,
    hist,
    mode: str = "auto",
    quantum: int = 64,
    ep_over_pods: bool = True,
    cap_factor: float = 1.25,
    dedup_factor: Optional[float] = None,
    params: Optional[MachineParams] = None,
    cache=None,
) -> MoEPlan:
    """Cached dispatch planning over a measured expert histogram: the
    re-planning entry point of ``profile.adapt.AdaptivePlanner``.

    As :func:`moe_plan_for`, but the routing pattern, and so the
    fingerprint keying the ``moe_plan_hist`` entry, is synthesized from the
    quantized ``hist`` (:func:`_histogram_routing_pattern`): an unchanged
    distribution is a cache hit, a drifted one keys (and for ``auto``
    re-selects) a new plan.  ``mode="auto"`` needs ``params``."""
    if mode == "auto" and params is None:
        raise ValueError("moe_plan_from_histogram(mode='auto') needs "
                         "MachineParams: pass params= (e.g. "
                         "core.costmodel.LASSEN)")
    cache = default_plan_cache() if cache is None else cache
    geom = make_moe_plan(
        cfg, mesh, tokens_per_lane,
        mode=("a2a" if mode == "auto" else mode),
        ep_over_pods=ep_over_pods, cap_factor=cap_factor,
        dedup_factor=dedup_factor,
    )
    if geom.mode == "dense":
        return geom
    qhist = quantize_histogram(hist, geom.e_log, quantum)
    pattern, _stats, fp = _histogram_routing_pattern(
        geom.ep_size, geom.e_log, geom.replicas, geom.e_per_dev,
        geom.capacity, geom.top_k, tokens_per_lane, qhist,
    )
    value_bytes = cfg.d_model * cfg.dtype.itemsize
    mesh_key = (tuple(mesh.axis_names), tuple(mesh.shape))
    key = (
        "moe_plan_hist", mesh_key, tokens_per_lane, cfg.n_experts,
        cfg.top_k, mode, ep_over_pods, cap_factor, dedup_factor,
        value_bytes, params, fp,
    )

    def build() -> MoEPlan:
        chosen = mode
        if mode == "auto":
            chosen, _report = _select_mode_over_pattern(
                geom, pattern, value_bytes, params
            )
        return dataclasses.replace(geom, mode=chosen, fingerprint=fp)

    return cache.moe_plan(key, build)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_moe(init: Initializer, cfg: ArchConfig, L: int, e_phys: int) -> Dict:
    d, f = cfg.d_model, cfg.d_ff_expert
    p = {
        "router": init.tensor((L, d, cfg.n_experts), fan_in=d,
                              dtype=torch.float32),
        "w_gate": init.tensor((L, e_phys, d, f), fan_in=d),
        "w_up": init.tensor((L, e_phys, d, f), fan_in=d),
        "w_down": init.tensor((L, e_phys, f, d), fan_in=f),
    }
    if cfg.n_shared_experts:
        fs = cfg.d_ff_expert * cfg.n_shared_experts
        p["ws_gate"] = init.tensor((L, d, fs), fan_in=d)
        p["ws_up"] = init.tensor((L, d, fs), fan_in=d)
        p["ws_down"] = init.tensor((L, fs, d), fan_in=fs)
    return p


EXPERT_WEIGHT_KEYS = ("w_gate", "w_up", "w_down")


def remap_expert_params(moe_params: Dict, e_log: int,
                        r_old: int, r_new: int) -> Dict:
    """Re-replicate expert weights for a changed EP group size.

    The physical expert layout is ``phys = logical * replicas + rep``
    (see ``_pack_routing``), so replica 0 of every logical expert lives at
    stride ``replicas``: slicing ``[:, ::r_old]`` recovers the logical
    weights and ``repeat_interleave(r_new, dim=1)`` re-expands them for
    the new group (``np.repeat`` along axis 1 in ``repro``).  Operates on
    the expert tensors (``w_gate`` / ``w_up`` / ``w_down``, shape
    [L, e_log*r, ...]) where they lie; router and shared weights are
    replication-independent and pass through untouched.  Dtypes are
    preserved.
    """
    out = dict(moe_params)
    for key in EXPERT_WEIGHT_KEYS:
        v = moe_params[key]
        assert v.shape[1] == e_log * r_old, (tuple(v.shape), e_log, r_old)
        base = v[:, ::r_old]                   # replica 0 per logical expert
        out[key] = base.repeat_interleave(r_new, dim=1)
    return out


def _expert_rows(plan: MoEPlan) -> Tuple[Tuple[int, int], ...]:
    """Each EP lane's ``(lo, hi)`` range of physical experts, in EP-rank
    order."""
    e = plan.e_per_dev
    return tuple((g * e, (g + 1) * e) for g in range(plan.ep_size))


def moe_param_specs(cfg: ArchConfig, plan: MoEPlan) -> Dict:
    """Which EP lane owns which rows of the expert tensors under ``plan``.

    ``repro`` returns ``PartitionSpec`` s that shard the physical-expert
    dim over the EP axes; the port keeps every tensor whole on one card,
    so its counterpart is the ownership map itself: for ``w_gate`` /
    ``w_up`` / ``w_down`` one ``(lo, hi)`` range of physical experts
    (dim 1) per EP lane, in EP-rank order (pod-major); ``None`` for the
    router and the shared experts, which every lane reads whole."""
    p: Dict = {"router": None}
    p.update(dict.fromkeys(EXPERT_WEIGHT_KEYS, _expert_rows(plan)))
    if cfg.n_shared_experts:
        p.update(dict.fromkeys(("ws_gate", "ws_up", "ws_down")))
    return p


def gather_expert_weights(
    moe_params: Dict,
    plan: MoEPlan,
    mesh: Mesh,
    method: str = "auto",
    cache=None,
    params: MachineParams = LASSEN,
):
    """Replicate the EP-owned expert weights with a plan-based dense
    allgatherv: ``(gathered_params, DenseSelection)``.

    Each EP lane's rows of the expert tensors (``w_gate`` / ``w_up`` /
    ``w_down``, the ranges :func:`moe_param_specs` names) are flattened
    into one segment and gathered in a single dense collective over
    :func:`dispatch_topology` (so region structure matches the dispatch
    transport), selected by the Section-5 cost model under ``params``
    (``method="auto"``) or pinned (``"hier"`` / ``"ring"``), and run by
    the rank-stacked executor (``core.dense.bind_dense``) on the tensors'
    device.  Every lane then holds every segment; lane 0's copy folds back
    into the ``[L, e_phys, ...]`` tensors.  Router and shared-expert
    weights pass through untouched.  The returned
    :class:`~repro_torch.core.dense.DenseSelection` is the recorded
    choice."""
    from ..core.dense import bind_dense

    if len(plan.ep_axes) != 1:
        raise ValueError(
            f"gather_expert_weights needs a single EP mesh axis, got "
            f"{plan.ep_axes!r}"
        )
    if mesh.axes[plan.ep_axes[0]] != plan.ep_size:
        raise ValueError(f"mesh {mesh.axes} does not carry plan's EP group "
                         f"of {plan.ep_size} on {plan.ep_axes[0]!r}")
    ep, e_per_dev = plan.ep_size, plan.e_per_dev
    gshapes = {k: tuple(moe_params[k].shape) for k in EXPERT_WEIGHT_KEYS}
    lshapes = {k: (s[0], e_per_dev) + s[2:] for k, s in gshapes.items()}
    sizes = {k: math.prod(s) for k, s in lshapes.items()}
    chunk = sum(sizes.values())

    cache = cache if cache is not None else default_plan_cache()
    topo = dispatch_topology(plan)
    with _OBS.span("moe/expert_gather_plan", method=method, ep=ep,
                            chunk=chunk) as sp:
        dplan, sel = cache.dense_collective(
            "allgatherv", np.full(ep, chunk, dtype=np.int64), topo,
            variant=method, params=params,
        )
        sp.set(chosen=sel.chosen)
    w0 = moe_params[EXPERT_WEIGHT_KEYS[0]]
    run = bind_dense(dplan, w0.device)
    own = torch.stack([
        torch.cat([moe_params[k][:, lo:hi].reshape(-1)
                   for k in EXPERT_WEIGHT_KEYS])
        for lo, hi in _expert_rows(plan)
    ])                                        # [ep, chunk] own segments
    full = run(own)[0]                        # lane 0's [ep, chunk] copy
    out = dict(moe_params)
    off = 0
    for k in EXPERT_WEIGHT_KEYS:
        part = full[:, off:off + sizes[k]].reshape((ep,) + lshapes[k])
        # [ep, L, e_per_dev, ...] -> [L, ep*e_per_dev, ...]: lanes hold
        # contiguous expert blocks in rank order
        out[k] = part.movedim(0, 1).reshape(gshapes[k])
        off += sizes[k]
    return out, sel


# ---------------------------------------------------------------------------
# routing + capacity packing (batched over any leading lane dims)
# ---------------------------------------------------------------------------


def _rank_within(ids: torch.Tensor) -> torch.Tensor:
    """Stable rank of each element among equal values along the last dim."""
    n = ids.shape[-1]
    _sorted, order = torch.sort(ids, dim=-1, stable=True)
    idx = torch.arange(n, device=ids.device).expand_as(ids)
    is_start = torch.ones_like(ids, dtype=torch.bool)
    is_start[..., 1:] = _sorted[..., 1:] != _sorted[..., :-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=-1).values
    ranks = torch.empty(ids.shape, dtype=torch.long, device=ids.device)
    return ranks.scatter_(-1, order, idx - seg_start)


def route(
    x: torch.Tensor,             # [..., N, D] each lane's tokens
    router_w: torch.Tensor,      # [D, E_log] (f32)
    plan: MoEPlan,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing -> (phys expert ids [..., N, k] int32, weights
    [..., N, k], aux loss [...]).

    Ties among the router's probabilities go to the lower expert id, as
    ``jax.lax.top_k`` orders them: a stable descending sort of the
    experts, cut at k."""
    N = x.shape[-2]
    cdt = compute_dtype(x.dtype)
    logits = x.to(cdt) @ router_w.to(cdt)                   # [..., N, E]
    probs = torch.softmax(logits, dim=-1)
    sw, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, eid = sw[..., :plan.top_k], order[..., :plan.top_k]
    w = w / torch.sum(w, dim=-1, keepdim=True)
    # load-balance aux (Switch-style): E * sum_e f_e * P_e
    lead = eid.shape[:-2]
    f = torch.zeros(lead + (plan.e_log,), dtype=torch.float32,
                    device=x.device)
    f.scatter_add_(-1, eid.reshape(lead + (-1,)),
                   torch.full(lead + (eid.shape[-2] * eid.shape[-1],),
                              1.0 / (N * plan.top_k), device=x.device))
    aux = plan.e_log * torch.sum(f * torch.mean(probs, dim=-2), dim=-1)
    if plan.replicas > 1:  # spread over replicas by token index
        rep = (torch.arange(N, device=x.device) % plan.replicas)[:, None]
        eid = eid * plan.replicas + rep
    return eid.to(torch.int32), w, aux


def capacity_pack(
    phys: torch.Tensor,          # [..., N, k]
    plan: MoEPlan,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Assign each (token, k) a slot in the [E_phys * C] send layout.

    Pairs claim expert slots in token-major order (flat index
    ``token * k + j``): when an expert overflows its capacity the late
    tokens are dropped.  Returns (slot [..., N, k], sentinel E_phys*C when
    dropped; keep [..., N, k]; slot_token [..., E_phys*C], source token per
    slot, sentinel N when empty)."""
    N, k = phys.shape[-2:]
    lead = phys.shape[:-2]
    C, EC = plan.capacity, plan.e_phys * plan.capacity
    flat_e = phys.reshape(lead + (N * k,)).long()
    rank = _rank_within(flat_e)
    keep = rank < C
    slot = torch.where(keep, flat_e * C + rank, EC)
    token_of_pair = torch.arange(N, device=phys.device).repeat_interleave(k)
    slot_token = torch.full(lead + (EC + 1,), N, dtype=torch.long,
                            device=phys.device)
    slot_token.scatter_(-1, slot, token_of_pair.expand_as(slot))
    return (slot.reshape(phys.shape), keep.reshape(phys.shape),
            slot_token[..., :EC])


# ---------------------------------------------------------------------------
# transport (the paper's strategies) on lane-stacked [G, ...] tensors
# ---------------------------------------------------------------------------


def _a2a(t: torch.Tensor, mesh: Mesh, axes: Sequence[str],
         dim: int) -> torch.Tensor:
    """Tiled ``all_to_all`` over the mesh ``axes`` (one group, flattened in
    the order given) of every lane's block, split and concatenated along
    the block's ``dim``: lane g's chunk j goes to lane j's chunk g.  On
    lanes stacked in ``t`` ([G, *block]) it swaps each of those mesh axes
    with the matching sub-dim of the chunk index."""
    names, shape = mesh.axis_names, tuple(mesh.shape)
    sizes = [mesh.axes[a] for a in axes]
    block = t.shape[1:]
    x = t.reshape(shape + block)
    d = len(shape) + dim
    x = x.reshape(x.shape[:d] + tuple(sizes) + (-1,) + x.shape[d + 1:])
    perm = list(range(x.dim()))
    for i, a in enumerate(axes):
        m = names.index(a)
        perm[m], perm[d + i] = perm[d + i], perm[m]
    return x.permute(perm).reshape(t.shape)


def ep_exchange(send: torch.Tensor, plan: MoEPlan, mesh: Mesh) -> torch.Tensor:
    """send: [G, ep*eC, D] ordered by destination device (pod-major);
    returns [G, ep*eC, D] ordered by source device."""
    if len(plan.ep_axes) == 1 or plan.mode == "a2a":
        return _a2a(send, mesh, plan.ep_axes, 0)
    # hierarchical: fast-axis hop to the leader lane, then one slow-axis
    # message per pod pair (paper's 3-step aggregation, s then g)
    G, _, D = send.shape
    Pp, Pm = plan.region_size, plan.devs_per_region
    b = send.reshape(G, Pp, Pm, -1, D)       # [dst pod, dst lane, eC]
    b = _a2a(b, mesh, ("model",), 1)         # -> [dst pod, src lane, eC]
    b = _a2a(b, mesh, ("pod",), 0)           # -> [src pod, src lane, eC]
    return b.reshape(send.shape)


def ep_exchange_back(recv: torch.Tensor, plan: MoEPlan,
                     mesh: Mesh) -> torch.Tensor:
    """Inverse transport: rows ordered by source device -> back to sources,
    arriving ordered by destination (computing) device = send layout."""
    if len(plan.ep_axes) == 1 or plan.mode == "a2a":
        return _a2a(recv, mesh, plan.ep_axes, 0)
    G, _, D = recv.shape
    Pp, Pm = plan.region_size, plan.devs_per_region
    b = recv.reshape(G, Pp, Pm, -1, D)       # [src pod, src lane, eC]
    b = _a2a(b, mesh, ("pod",), 0)           # -> [cmp pod, src lane, eC]
    b = _a2a(b, mesh, ("model",), 1)         # -> [cmp pod, cmp lane, eC]
    return b.reshape(recv.shape)


def _gather_lanes(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K5 over every lane in one launch: ``out[g, i] = table[g, idx[g, i]]``
    (table [G, R, D], idx [G, M])."""
    G, R, D = table.shape
    off = torch.arange(G, device=idx.device, dtype=idx.dtype)[:, None] * R
    flat = (idx + off).reshape(-1).to(torch.int32)
    return pack_gather(table.reshape(G * R, D), flat).reshape(G, -1, D)


def _pad_row(t: torch.Tensor) -> torch.Tensor:
    """[G, R, D] -> [G, R + 1, D] with a zero row appended to each lane."""
    out = t.new_zeros((t.shape[0], t.shape[1] + 1, t.shape[2]))
    out[:, :-1] = t
    return out


# ---------------------------------------------------------------------------
# the layer body
# ---------------------------------------------------------------------------


def _expert_ffn(wg, wu, wd, act_fn, xb):
    """xb: [E, T, D]; w*: [E, D, f] / [E, f, D]."""
    xf = xb.to(wg.dtype)
    h = act_fn(torch.bmm(xf, wg)) * torch.bmm(xf, wu)
    return torch.bmm(h, wd)


def _expert_lanes(xb: torch.Tensor, params: Dict, plan: MoEPlan,
                  mesh: Mesh, act_fn: Callable) -> torch.Tensor:
    """Every lane's local experts on its expert batches: xb [G, e_per_dev,
    T, D] -> [G, e_per_dev, T, D].  Lanes outside the EP axes hold replicas
    of the same experts, so their batches are stacked along T and every
    expert runs as one batched product over the whole group."""
    names, shape = mesh.axis_names, tuple(mesh.shape)
    nm = len(names)
    e_per, T, D = xb.shape[1:]
    ep_dims = [names.index(a) for a in plan.ep_axes]
    other = [i for i in range(nm) if i not in ep_dims]
    perm = ep_dims + [nm] + other + [nm + 1, nm + 2]
    x = xb.reshape(shape + (e_per, T, D)).permute(perm)
    grouped = x.shape
    yo = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"],
                     act_fn, x.reshape(plan.e_phys, -1, D))
    inv = [perm.index(i) for i in range(len(perm))]
    return yo.reshape(grouped).permute(inv).reshape(xb.shape)


def moe_dispatch_lane(
    x_lane: torch.Tensor,        # [G, N, D] every lane's tokens
    params: Dict,                # per-layer slices, expert weights all lanes'
    plan: MoEPlan,
    cfg: ArchConfig,
    mesh: Mesh,
    valid: Optional[torch.Tensor] = None,   # [G, N] bool; False rows are pads
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns per lane (y [G, N, D], aux [G], dropped_fraction [G],
    expert_counts [G, e_log] f32), the non-dense transports.

    ``dropped_fraction`` is the fraction of a lane's valid (token, k) pairs
    that lost their expert slot (or, in ``hier_dedup``, their unique slot);
    pads are routed but not counted.  ``expert_counts`` is the lane's
    measured routing histogram: valid pairs per logical expert,
    pre-capacity."""
    G, N, D = x_lane.shape
    k = plan.top_k
    act_fn = activation(cfg.act)
    if valid is None:
        valid = torch.ones((G, N), dtype=torch.bool, device=x_lane.device)
    phys, w, aux = route(x_lane, params["router"], plan)
    counts = torch.zeros((G, plan.e_log), dtype=torch.float32,
                         device=x_lane.device)
    counts.scatter_add_(
        1, (phys.long() // plan.replicas).reshape(G, -1),
        valid[:, :, None].expand(G, N, k).reshape(G, -1).float())

    slot, keep, slot_token = capacity_pack(phys, plan)
    w = w * keep.to(w.dtype)
    x_pad = _pad_row(x_lane)

    delivered = keep
    if plan.mode == "hier_dedup" and plan.top_k > 1:
        yb, pair_ok = _dedup_outbound(x_pad, slot, keep, phys, params, plan,
                                      act_fn, mesh)
        delivered = keep & pair_ok.reshape(G, N, k)
    else:
        send = _gather_lanes(x_pad, torch.clamp(slot_token, max=N))
        recv = ep_exchange(send, plan, mesh)          # by source device
        ep, e_per, C = plan.ep_size, plan.e_per_dev, plan.capacity
        xb = recv.reshape(G, ep, e_per, C, D).transpose(1, 2)
        yo = _expert_lanes(xb.reshape(G, e_per, ep * C, D), params, plan,
                           mesh, act_fn)
        yb = yo.reshape(G, e_per, ep, C, D).transpose(1, 2).reshape(
            G, ep * e_per * C, D)
    y_recv = ep_exchange_back(yb.to(x_lane.dtype), plan, mesh)

    kept_real = torch.sum((delivered & valid[:, :, None]).float(),
                          dim=(1, 2))
    n_real = torch.sum(valid.float(), dim=1) * k
    dropped = 1.0 - kept_real / torch.clamp(n_real, min=1.0)

    # y_recv holds a lane's EC = e_phys * capacity slots, and a dropped
    # pair's slot is the sentinel EC, which K6 reads as zero: no pad row
    y = pack_combine_lanes(y_recv, slot, w)
    return y.to(x_lane.dtype), aux, dropped, counts


def _dense_lanes(xf: torch.Tensor, params: Dict, plan: MoEPlan,
                 cfg: ArchConfig, Pm: int):
    """``dense`` on every batch shard (xf [S, n, D]): each of the shard's
    ``Pm`` lanes runs its expert shard on all the shard's tokens, masked by
    router weights, and the lanes' outputs are summed (the ``psum`` over
    ``model``).  Returns per shard (y [S, n, D], aux [S], counts [S, e_log]
    of one lane)."""
    S, n, D = xf.shape
    act_fn = activation(cfg.act)
    phys, w, aux = route(xf, params["router"], plan)
    counts = torch.zeros((S, plan.e_log), dtype=torch.float32,
                         device=xf.device)
    counts.scatter_add_(1, (phys.long() // plan.replicas).reshape(S, -1),
                        torch.ones((S, phys[0].numel()), device=xf.device))
    e_per = plan.e_phys // Pm
    xb = xf.reshape(1, S * n, D).expand(plan.e_phys, S * n, D)
    y_all = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"],
                        act_fn, xb).reshape(Pm, e_per, S, n, D)
    cdt = compute_dtype(xf.dtype)
    e_ids = torch.arange(plan.e_phys, device=xf.device).reshape(Pm, e_per)
    match = phys[None, None] == e_ids[:, :, None, None, None]
    wk = torch.sum(match * w[None, None].to(cdt), dim=-1)   # [Pm,e_per,S,n]
    y_lanes = torch.einsum("mesn,mesnd->msnd", wk, y_all.to(cdt))
    return torch.sum(y_lanes, dim=0).to(xf.dtype), aux, counts


def moe_layer(
    x: torch.Tensor,             # [B, S, D]
    params: Dict,                # per-layer slices (no leading L dim)
    plan: MoEPlan,
    cfg: ArchConfig,
    mesh: Mesh,
    batch_axes: Tuple[str, ...],
    cache=None,
    return_expert_counts: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Shard the batch over ``batch_axes`` and each shard's tokens over the
    ``model`` lanes, dispatch, and gather the lane outputs back.  Returns
    (y [B, S, D], aux scalar, dropped_fraction scalar weighted by each
    lane's real pairs); with ``return_expert_counts=True`` also the batch's
    routing histogram ([e_log] f32, summed over every lane, so replicated
    lanes multiply it uniformly).

    With ``cache`` the dispatch executor is memoized in its
    ``moe_executor`` namespace under ``repro``'s key: geometry and mode
    without the routing fingerprint, the mesh, the batch sharding, the
    parameter names, the activation and the output arity."""
    if tuple(batch_axes) != tuple(a for a in mesh.axis_names
                                  if a != "model"):
        raise ValueError(f"batch axes {batch_axes}: expected every mesh "
                         f"axis but 'model' of {mesh.axis_names}")
    n_bdev = mesh.size // mesh.axes["model"]
    sharded = bool(batch_axes) and x.shape[0] % n_bdev == 0
    names = tuple(sorted(k for k in params
                         if k in ("router", "w_gate", "w_up", "w_down")))

    def build() -> Callable:
        return functools.partial(_moe_executor, plan=plan, cfg=cfg,
                                 mesh=mesh, sharded=sharded,
                                 return_expert_counts=return_expert_counts)

    if cache is not None:
        geom_key = dataclasses.replace(plan, fingerprint="")
        x_spec = tuple(batch_axes) if sharded else ()
        key = ("moe_exec", geom_key, mesh, x_spec, names, cfg.act,
               return_expert_counts)
        fn = cache.moe_executor(key, build)
    else:
        fn = build()
    return fn(x, {k: params[k] for k in names})


def _moe_executor(x: torch.Tensor, params: Dict, *, plan: MoEPlan,
                  cfg: ArchConfig, mesh: Mesh, sharded: bool,
                  return_expert_counts: bool) -> Tuple[torch.Tensor, ...]:
    """The lane-stacked body of :func:`moe_layer` (``repro``'s shard_map
    body, every device at once)."""
    Pm = mesh.axes["model"]
    G = mesh.size
    n_bdev = G // Pm
    B, S, D = x.shape
    if sharded:
        xs = x.reshape(n_bdev, B // n_bdev, S, D)
    else:      # tokens replicate over the batch devices
        xs = x.unsqueeze(0).expand(n_bdev, B, S, D)
    b_loc = xs.shape[1]
    n_all = b_loc * S
    xf = xs.reshape(n_bdev, n_all, D)

    if plan.mode == "dense":
        y, aux, counts = _dense_lanes(xf, params, plan, cfg, Pm)
        y = y.reshape(n_bdev, b_loc, S, D)
        out = (y.reshape(B, S, D) if sharded else y[0], torch.mean(aux),
               torch.zeros((), dtype=torch.float32, device=x.device))
        if return_expert_counts:
            out += (torch.sum(counts, dim=0) * Pm,)
        return out

    n_pad = n_all + ((-n_all) % Pm)
    if n_pad != n_all:
        xf = torch.cat([xf, xf.new_zeros((n_bdev, n_pad - n_all, D))], 1)
    n_lane = n_pad // Pm
    x_lane = xf.reshape(G, n_lane, D)
    # pad rows are routed but masked out of the capacity-health metric
    pos = torch.arange(n_pad, device=x.device).reshape(1, Pm, n_lane)
    valid = (pos < n_all).expand(n_bdev, Pm, n_lane).reshape(G, n_lane)
    y_lane, aux, drop, counts = moe_dispatch_lane(x_lane, params, plan, cfg,
                                                  mesh, valid=valid)
    y = y_lane.reshape(n_bdev, n_pad, D)[:, :n_all].reshape(
        n_bdev, b_loc, S, D)
    nv = torch.sum(valid.float(), dim=1)
    drop = torch.sum(drop * nv) / torch.clamp(torch.sum(nv), min=1.0)
    out = (y.reshape(B, S, D) if sharded else y[0], torch.mean(aux), drop)
    if return_expert_counts:
        out += (torch.sum(counts, dim=0),)
    return out


def _dedup_outbound(x_pad, slot, keep, phys, params, plan, act_fn, mesh):
    """Paper's fully-optimized outbound on every lane: one copy per (token,
    dst region) plus int32 metadata; fan out to expert slots inside the
    region (K5).

    x_pad: [G, N + 1, D] (zero row last).  Returns (expert outputs
    [G, ep * eC, D] by source device, pod-major; pair_ok [G, N * k]: pairs
    whose token won a unique slot and will come back)."""
    G, N1, D = x_pad.shape
    N = N1 - 1
    k, C = plan.top_k, plan.capacity
    Rg, Dg, eC = plan.region_size, plan.devs_per_region, plan.ec
    Cu = plan.uniq_capacity
    Cp = Dg * eC                              # exact pair bound per region
    dev_ = x_pad.device
    n_pairs = N * k

    keep_f = keep.reshape(G, n_pairs)
    dst = (phys.long() // plan.e_per_dev).reshape(G, n_pairs)
    region = torch.where(keep_f, dst // Dg, Rg)          # pod-major order
    pair_token = torch.arange(N, device=dev_).repeat_interleave(k)

    # ---- lane-local dedup: first pair of each (region, token) key --------
    key = region * (N + 1) + pair_token
    key_s, order = torch.sort(key, dim=1, stable=True)
    is_first = torch.ones_like(key_s, dtype=torch.bool)
    is_first[:, 1:] = key_s[:, 1:] != key_s[:, :-1]
    region_s = torch.gather(region, 1, order)
    reg_start = torch.ones_like(is_first)
    reg_start[:, 1:] = region_s[:, 1:] != region_s[:, :-1]
    firsts = is_first.long()
    cum = torch.cumsum(firsts, dim=1)
    reg_base = torch.cummax(torch.where(reg_start, cum - firsts, 0),
                            dim=1).values
    ur = cum - firsts - reg_base                          # 0-based, sorted
    uniq_ok_s = is_first & (ur < Cu) & (region_s < Rg)
    uslot_s = torch.where(uniq_ok_s, region_s * Cu + ur, Rg * Cu)

    # forward-fill each key's uslot to its non-first pairs via segment ids
    seg_id = cum - 1
    seg_uslot = torch.full((G, n_pairs + 1), Rg * Cu, dtype=torch.long,
                           device=dev_)
    seg_uslot.scatter_(1, torch.where(is_first, seg_id, n_pairs), uslot_s)
    pair_uslot_s = torch.gather(seg_uslot, 1, seg_id)
    pair_uslot = torch.empty_like(pair_uslot_s).scatter_(1, order,
                                                         pair_uslot_s)

    # uniq value buffer [Rg*Cu] -> source token
    uniq_token = torch.full((G, Rg * Cu + 1), N, dtype=torch.long,
                            device=dev_)
    uniq_token.scatter_(1, uslot_s, pair_token[order])
    uniq_token = uniq_token[:, :Rg * Cu]

    # ---- metadata: meta[region, dst_in_region] = uslot-within-region ------
    slot_f = slot.reshape(G, n_pairs)
    dst_in_region = torch.where(keep_f, (dst % Dg) * eC + slot_f % eC, Cp)
    pair_ok = keep_f & (pair_uslot < Rg * Cu)
    mpos = torch.where(pair_ok, region * Cp + dst_in_region, Rg * Cp)
    meta = torch.full((G, Rg * Cp + 1), -1, dtype=torch.long, device=dev_)
    meta.scatter_(1, mpos, pair_uslot % Cu)
    meta = meta[:, :Rg * Cp]

    # ---- ship uniques + metadata across the slow axis ---------------------
    uniq_vals = _gather_lanes(x_pad, torch.clamp(uniq_token, max=N))
    uniq_rcv = _a2a(uniq_vals.reshape(G, Rg, Cu, D), mesh,
                    (plan.region_axis,), 0)
    meta_rcv = _a2a(meta.reshape(G, Rg, Cp), mesh, (plan.region_axis,), 0)

    # ---- fan out inside the region (paper step r) --------------------------
    u_pad = _pad_row(uniq_rcv.reshape(G, Rg * Cu, D))
    m_flat = meta_rcv.reshape(G, Rg * Cp)                 # uslot or -1
    src_reg = torch.arange(Rg, device=dev_).repeat_interleave(Cp)
    gidx = torch.where(m_flat >= 0, src_reg * Cu + m_flat, Rg * Cu)
    vals = _gather_lanes(u_pad, gidx)                     # [G, Rg*Cp, D]
    # [src_reg, dst_dev_in_region, eC] -> [dst_dev, src_reg, eC]
    fan = vals.reshape(G, Rg, Dg, eC, D).transpose(1, 2).reshape(
        G, Dg, Rg * eC, D)
    if Dg > 1:
        fan = _a2a(fan, mesh, ("model",), 0)              # dim0 -> src lane
    # expert batches with source device pod-major: g0 = src_reg * Dg + lane
    xb = fan.reshape(G, Dg, Rg, plan.e_per_dev, C, D).permute(0, 3, 2, 1, 4, 5)
    yo = _expert_lanes(xb.reshape(G, plan.e_per_dev, Rg * Dg * C, D), params,
                       plan, mesh, act_fn)
    yb = yo.reshape(G, plan.e_per_dev, Rg, Dg, C, D).permute(0, 2, 3, 1, 4, 5)
    return yb.reshape(G, plan.ep_size * eC, D), pair_ok
