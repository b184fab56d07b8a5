"""Plan-based dense collectives: allreduce / allgatherv / reduce_scatter.

The paper's locality-aware aggregation is not specific to sparse
neighborhoods: Traff et al. (1606.07676) show message-combining for
isomorphic sparse collectives, and Jocksch et al. (2006.13112) show the
same hierarchical intra-/inter-node decomposition winning for the dense
collectives distributed training runs on.  This module brings those dense
collectives onto the planning stack: every collective is an explicit,
host-built **round schedule**, scored by the same Section-5 cost model that
picks the sparse transports and cached in a ``PlanCache`` namespace under a
content fingerprint.

Data model
----------
The global vector is split into ``P`` *segments*, one per rank
(``counts[p]`` values each; ragged counts are first-class, which is what
makes allgather*v* a v).  A :class:`DenseRound` moves whole segments
between ranks; segment identity is preserved on the wire (segment ``s``
always lands in slot ``s``), so a schedule is fully described by
``(pairs, segments, reduce?)`` per round.  :meth:`DensePlan.execute_numpy`
interprets it on the host; :func:`dense_round_runner` runs it on a
rank-stacked ``[P, n_seg, cmax]`` tensor on one device, each round one
gather, one permutation along the rank dim and one set or add.

Variants
--------
* ``ring``: single-level ring: reduce_scatter / allgather pipelines over
  all ``P`` ranks (``P-1`` rounds each; allreduce = RS + AG).
* ``rd``: recursive doubling allreduce (``log2 P`` rounds, full-vector
  exchanges; power-of-two rank counts only).
* ``hier``: the locality-aware decomposition: intra-region ring
  reduce_scatter, inter-region exchange among per-chunk leaders (the
  same-local-rank groups; for allgatherv the region leaders proper plus a
  doubling intra-region broadcast), intra-region ring allgather.  Fewer,
  larger inter-region messages: the paper's aggregation trade.

``select_dense`` mirrors ``core.selection.select_plan``: build the
candidate schedules, score each with ``costmodel.stats_time`` under the
given ``MachineParams``, pick the cheapest, and report the table in a
:class:`DenseSelection`.  Ported from ``repro.core.dense``, with
:func:`measure_dense_seconds`, the dense collectives' calibration feed.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from .. import resolve_device
from ..obs import default_obs, now as _now
from .collectives import time_calls
from .costmodel import LASSEN, MachineParams, stats_time
from .plan import Message, PlanStats, StepStats, Topology

_OBS = default_obs()

DENSE_COLLECTIVES = ("allreduce", "allgatherv", "reduce_scatter")


# ---------------------------------------------------------------------------
# plan structures
# ---------------------------------------------------------------------------


@dataclass
class DenseRound:
    """One round: disjoint (src, dst) pairs moving whole segments.

    ``segs[i]`` are the segment ids pair ``i`` moves; ``reduce`` selects
    add-into vs overwrite at the destination (segment identity is
    preserved, so destination slots equal source segment ids).
    """

    pairs: List[Tuple[int, int]]
    segs: List[np.ndarray]
    reduce: bool
    phase: str = ""

    def width_segments(self) -> int:
        return max((len(s) for s in self.segs), default=0)


@dataclass
class DensePlan:
    """A fully-resolved dense collective schedule (the persistent init).

    Exposes the surface a ``CommPlan`` has (``strategy`` / ``topo`` /
    ``stats`` / ``steps``); each round is one stats step, composed serially
    by ``costmodel.stats_time``.
    """

    collective: str
    variant: str
    topo: Topology
    counts: np.ndarray            # [P] per-segment value counts
    rounds: List[DenseRound]
    value_bytes: int = 8
    fingerprint: str = ""
    _stats: Optional[PlanStats] = field(default=None, repr=False)

    def __post_init__(self):
        self.counts = np.asarray(self.counts, dtype=np.int64)
        if len(self.counts) != self.topo.n_procs:
            raise ValueError(
                f"dense plans carry one segment per device: "
                f"{len(self.counts)} counts vs {self.topo.n_procs} procs"
            )
        if not self.fingerprint:
            self.fingerprint = dense_fingerprint(
                self.collective, self.counts, self.topo, self.variant,
                self.value_bytes,
            )

    # ------------------------------------------------------------ derived
    @property
    def n(self) -> int:
        """Total logical values."""
        return int(self.counts.sum())

    @property
    def cmax(self) -> int:
        """Padded on-device segment width."""
        return int(self.counts.max()) if len(self.counts) else 0

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)

    @property
    def strategy(self) -> str:
        return f"{self.collective}/{self.variant}"

    @property
    def stats(self) -> PlanStats:
        """Exact per-round traffic, one ``StepStats`` per round (round
        names are ``d0..dk``: ``costmodel.stats_time`` composes unknown
        step names serially, which is exactly a round schedule)."""
        if self._stats is None:
            steps = [
                _round_stats(r, self.counts, self.topo, f"d{i}")
                for i, r in enumerate(self.rounds)
            ]
            self._stats = PlanStats(steps, self.value_bytes)
        return self._stats

    @property
    def steps(self):
        """One message per pair, at *segment* granularity (sizes come from
        :attr:`stats`; these messages only carry pairing / round
        structure)."""
        return [
            SimpleNamespace(
                name=f"d{i}",
                messages=[
                    Message(src, dst, segs, segs)
                    for (src, dst), segs in zip(r.pairs, r.segs)
                ],
            )
            for i, r in enumerate(self.rounds)
        ]

    def modeled_time(self, params: MachineParams) -> float:
        return dense_time(self, params)

    def describe(self) -> str:
        t = self.stats.totals()
        return (
            f"DensePlan({self.strategy}, procs={self.topo.n_procs}, "
            f"regions={self.topo.n_regions}, n={self.n}, "
            f"rounds={self.n_rounds}, totals={t})"
        )

    # ------------------------------------------------------------- oracle
    def execute_numpy(
        self, local_vals: Sequence[np.ndarray]
    ) -> List[np.ndarray]:
        """Host-side reference execution of the *schedule* (not the
        mathematical collective): interprets the rounds exactly as the
        device executor does, so device == oracle == schedule.

        Inputs per collective: ``allreduce`` / ``reduce_scatter`` take the
        per-device full contribution vector ``[n]``; ``allgatherv`` takes
        the per-device owned segment ``[counts[p]]``.  Outputs: allreduce
        -> per-device ``[n]`` (all equal), reduce_scatter -> per-device
        ``[counts[p]]``, allgatherv -> per-device ``[n]``.
        """
        P = self.topo.n_procs
        bounds = np.cumsum(self.counts)[:-1]
        if self.collective == "allgatherv":
            state = [
                [
                    np.array(local_vals[p], copy=True)
                    if s == p
                    else np.zeros(int(self.counts[s]),
                                  dtype=local_vals[p].dtype)
                    for s in range(P)
                ]
                for p in range(P)
            ]
        else:
            state = [
                [seg.copy() for seg in np.split(
                    np.asarray(local_vals[p]), bounds)]
                for p in range(P)
            ]
        for rnd in self.rounds:
            payloads = [
                (dst, segs, [state[src][int(s)].copy() for s in segs])
                for (src, dst), segs in zip(rnd.pairs, rnd.segs)
            ]
            for dst, segs, pay in payloads:
                for s, v in zip(segs, pay):
                    if rnd.reduce:
                        state[dst][int(s)] = state[dst][int(s)] + v
                    else:
                        state[dst][int(s)] = v
        if self.collective == "reduce_scatter":
            return [state[p][p] for p in range(P)]
        return [np.concatenate(state[p]) for p in range(P)]


def _round_stats(
    rnd: DenseRound, counts: np.ndarray, topo: Topology, name: str
) -> StepStats:
    P = topo.n_procs
    im = np.zeros(P, dtype=np.int64)
    xm = np.zeros(P, dtype=np.int64)
    iv = np.zeros(P, dtype=np.int64)
    xv = np.zeros(P, dtype=np.int64)
    for (src, dst), segs in zip(rnd.pairs, rnd.segs):
        size = int(counts[segs].sum())
        if src == dst or size == 0:
            continue
        if topo.same_region(src, dst):
            im[src] += 1
            iv[src] += size
        else:
            xm[src] += 1
            xv[src] += size
    return StepStats(name, im, xm, iv, xv)


def dense_time(plan: DensePlan, params: MachineParams) -> float:
    """Modeled time: rounds are bulk-synchronous and serial, so the round
    schedule composes as a plain sum of :func:`costmodel.step_time` —
    which is what ``stats_time`` does for non-sparse step names."""
    return stats_time(plan.stats, plan.topo, params)


# ---------------------------------------------------------------------------
# fingerprints / cache keys
# ---------------------------------------------------------------------------


def dense_fingerprint(
    collective: str,
    counts: np.ndarray,
    topo: Topology,
    variant: str,
    value_bytes: int,
) -> str:
    """Content hash of a dense plan's identity — same framing discipline
    as ``cache.pattern_fingerprint`` (name/dtype/shape-framed arrays, no
    ``PYTHONHASHSEED`` dependence anywhere)."""
    from .cache import _hash_array

    h = hashlib.blake2b(digest_size=16)
    h.update(f"dense:{collective}:{variant}".encode())
    h.update(b"\x00")
    _hash_array(h, "counts", np.asarray(counts, dtype=np.int64))
    h.update(
        np.asarray(
            [topo.n_procs, topo.procs_per_region, value_bytes],
            dtype=np.int64,
        ).tobytes()
    )
    return h.hexdigest()


def dense_cache_key(
    collective: str,
    counts: np.ndarray,
    topo: Topology,
    variant: str,
    value_bytes: int,
    params: MachineParams,
) -> Tuple:
    """Everything ``select_dense`` depends on (params included: ``auto``
    selects per machine model, exactly like the sparse plan key)."""
    return (
        dense_fingerprint(collective, counts, topo, variant, value_bytes),
        variant,
        params,
    )


def even_counts(n: int, n_procs: int) -> np.ndarray:
    """Uniform segment counts covering >= n values (the padded chunking
    the inline executors use: ``P * ceil(n / P)`` total)."""
    c = -(-int(n) // int(n_procs)) if n > 0 else 0
    return np.full(n_procs, max(c, 1), dtype=np.int64)


# ---------------------------------------------------------------------------
# round schedules
# ---------------------------------------------------------------------------

Group = Tuple[List[int], List[np.ndarray]]   # (ring members, target segments)


def _ring_rs_rounds(groups: Sequence[Group], phase: str) -> List[DenseRound]:
    """Pipelined ring reduce-scatter over each group: after ``m-1`` rounds
    member ``i`` holds the group-wide sum of its target segments.  At step
    ``t`` member ``i`` forwards the accumulated partial of member
    ``(i-t-1) mod m``'s segments to ``i+1``, which adds it in."""
    if not groups:
        return []
    m = len(groups[0][0])
    out = []
    for t in range(m - 1):
        pairs: List[Tuple[int, int]] = []
        segs: List[np.ndarray] = []
        for members, seglists in groups:
            for i, src in enumerate(members):
                pairs.append((src, members[(i + 1) % m]))
                segs.append(seglists[(i - t - 1) % m])
        out.append(DenseRound(pairs, segs, True, phase))
    return out


def _ring_ag_rounds(groups: Sequence[Group], phase: str) -> List[DenseRound]:
    """Pipelined ring allgather: member ``i`` starts holding its target
    segments; after ``m-1`` rounds every member holds every group
    segment.  At step ``t`` member ``i`` forwards member ``(i-t) mod m``'s
    segments to ``i+1``, which overwrites its (empty) slots."""
    if not groups:
        return []
    m = len(groups[0][0])
    out = []
    for t in range(m - 1):
        pairs: List[Tuple[int, int]] = []
        segs: List[np.ndarray] = []
        for members, seglists in groups:
            for i, src in enumerate(members):
                pairs.append((src, members[(i + 1) % m]))
                segs.append(seglists[(i - t) % m])
        out.append(DenseRound(pairs, segs, False, phase))
    return out


def _seg(p: int) -> np.ndarray:
    return np.asarray([p], dtype=np.int64)


def _hier_groups(topo: Topology) -> Tuple[List[Group], List[Group]]:
    """(intra-region groups at chunk-group granularity, inter-region
    same-local-rank groups at single-segment granularity)."""
    ppr, R = topo.procs_per_region, topo.n_regions
    intra: List[Group] = []
    for reg in range(R):
        members = list(topo.procs_in_region(reg))
        seglists = [
            np.asarray([rp * ppr + r for rp in range(R)], dtype=np.int64)
            for r in range(ppr)
        ]
        intra.append((members, seglists))
    inter: List[Group] = []
    for r in range(ppr):
        members = [reg * ppr + r for reg in range(R)]
        inter.append((members, [_seg(m) for m in members]))
    return intra, inter


def build_dense_rounds(
    collective: str, topo: Topology, variant: str
) -> List[DenseRound]:
    """Emit the round schedule for one (collective, variant)."""
    P = topo.n_procs
    ppr, R = topo.procs_per_region, topo.n_regions
    if collective not in DENSE_COLLECTIVES:
        raise ValueError(f"unknown dense collective {collective!r}")

    if variant == "ring":
        flat: List[Group] = [(list(range(P)), [_seg(p) for p in range(P)])]
        if collective == "allgatherv":
            return _ring_ag_rounds(flat, "ring_ag")
        rounds = _ring_rs_rounds(flat, "ring_rs")
        if collective == "allreduce":
            rounds += _ring_ag_rounds(flat, "ring_ag")
        return rounds

    if variant == "rd":
        if collective != "allreduce":
            raise ValueError("recursive doubling is an allreduce variant")
        if P & (P - 1):
            raise ValueError(f"recursive doubling needs 2^k procs, got {P}")
        allsegs = np.arange(P, dtype=np.int64)
        rounds = []
        j = 1
        while j < P:
            pairs = [(p, p ^ j) for p in range(P)]
            rounds.append(DenseRound(pairs, [allsegs] * P, True, "rd"))
            j <<= 1
        return rounds

    if variant != "hier":
        raise ValueError(f"unknown dense variant {variant!r}")

    if collective in ("allreduce", "reduce_scatter"):
        # intra-region ring RS over chunk groups -> inter-region ring RS
        # among same-local-rank devices (the per-chunk leaders); allreduce
        # runs the mirror-image allgather back out.
        intra, inter = _hier_groups(topo)
        rounds = _ring_rs_rounds(intra, "intra_rs")
        rounds += _ring_rs_rounds(inter, "inter_rs")
        if collective == "allreduce":
            rounds += _ring_ag_rounds(inter, "inter_ag")
            rounds += _ring_ag_rounds(intra, "intra_ag")
        return rounds

    # hier allgatherv: intra-region ring allgather, one inter-region ring
    # over the region *leaders* (whole region blocks per message), then a
    # doubling broadcast down each region.
    intra_ag: List[Group] = []
    for reg in range(R):
        members = list(topo.procs_in_region(reg))
        intra_ag.append((members, [_seg(m) for m in members]))
    leaders = [reg * ppr for reg in range(R)]
    leader_group: List[Group] = [(
        leaders,
        [np.arange(reg * ppr, (reg + 1) * ppr, dtype=np.int64)
         for reg in range(R)],
    )]
    rounds = _ring_ag_rounds(intra_ag, "intra_ag")
    rounds += _ring_ag_rounds(leader_group, "leader_ag")
    j = 1
    while j < ppr:
        pairs: List[Tuple[int, int]] = []
        segs: List[np.ndarray] = []
        for reg in range(R):
            others = np.concatenate([
                np.arange(0, reg * ppr, dtype=np.int64),
                np.arange((reg + 1) * ppr, P, dtype=np.int64),
            ])
            if not len(others):
                continue
            for s in range(j):
                if s + j < ppr:
                    base = reg * ppr
                    pairs.append((base + s, base + s + j))
                    segs.append(others)
        if pairs:
            rounds.append(DenseRound(pairs, segs, False, "bcast"))
        j <<= 1
    return rounds


def build_dense_plan(
    collective: str,
    counts: np.ndarray,
    topo: Topology,
    variant: str,
    value_bytes: int = 8,
) -> DensePlan:
    counts = np.asarray(counts, dtype=np.int64)
    return DensePlan(
        collective=collective,
        variant=variant,
        topo=topo,
        counts=counts,
        rounds=build_dense_rounds(collective, topo, variant),
        value_bytes=value_bytes,
    )


# ---------------------------------------------------------------------------
# Section-5 selection
# ---------------------------------------------------------------------------


@dataclass
class DenseSelection:
    """The dense analogue of ``SelectionReport`` — attached by every
    consumer next to its other choices (``DistOp``-style)."""

    collective: str
    chosen: str
    modeled_times: Dict[str, float]
    planning_seconds: Dict[str, float]

    def __str__(self) -> str:
        rows = ", ".join(
            f"{k}={v * 1e6:.1f}us"
            for k, v in sorted(self.modeled_times.items())
        )
        return f"dense/{self.collective}: selected={self.chosen} ({rows})"


def dense_variants(collective: str, topo: Topology) -> List[str]:
    """The variants worth scoring for this geometry."""
    out = ["ring"]
    if collective == "allreduce" and topo.n_procs & (topo.n_procs - 1) == 0:
        out.append("rd")
    if topo.procs_per_region > 1 and topo.n_regions > 1:
        out.append("hier")
    return out


def select_dense(
    collective: str,
    counts: np.ndarray,
    topo: Topology,
    variant: str = "auto",
    value_bytes: int = 8,
    params: MachineParams = LASSEN,
) -> Tuple[DensePlan, DenseSelection]:
    """Build candidate schedules, score them with the cost model under
    ``params``, pick the cheapest (``variant="auto"``) or pin one."""
    candidates = (
        dense_variants(collective, topo) if variant == "auto" else [variant]
    )
    plans: Dict[str, DensePlan] = {}
    times: Dict[str, float] = {}
    walls: Dict[str, float] = {}
    with _OBS.span("dense/select", collective=collective,
                   n_procs=topo.n_procs, variant=variant) as sp:
        for cand in candidates:
            t0 = _now()
            plan = build_dense_plan(collective, counts, topo, cand,
                                    value_bytes)
            walls[cand] = _now() - t0
            plans[cand] = plan
            times[cand] = dense_time(plan, params)
        chosen = min(times, key=lambda k: times[k])
        sp.set(chosen=chosen)
    return plans[chosen], DenseSelection(collective, chosen, times, walls)


# ---------------------------------------------------------------------------
# device execution: a rank-stacked round interpreter
# ---------------------------------------------------------------------------


def _pack_device_rounds(plan: DensePlan):
    """Freeze rounds into [P, w] gather/scatter segment-id arrays (pad =
    the sentinel row ``n_seg``) + the permutation, in round order."""
    P = plan.topo.n_procs
    sentinel = len(plan.counts)
    packed = []
    for rnd in plan.rounds:
        w = rnd.width_segments()
        g = np.full((P, w), sentinel, dtype=np.int32)
        s = np.full((P, w), sentinel, dtype=np.int32)
        for (src, dst), segs in zip(rnd.pairs, rnd.segs):
            g[src, : len(segs)] = segs
            s[dst, : len(segs)] = segs
        packed.append((tuple(rnd.pairs), g, s, rnd.reduce))
    return packed


def dense_round_runner(plan: DensePlan, device=None) -> Callable:
    """``run(buf) -> buf`` over the rank-stacked segment buffer ``buf``
    ``[P, n_seg, cmax]`` (zero padding beyond ``counts[s]``) on ``device``
    (default ``cuda``).

    Each plan round is one gather of every rank's outgoing segment rows,
    one permutation along the rank dim (a rank that receives nothing gets
    the zero row ``P``) and one set or add into the receivers' rows.  The
    whole round is gathered before any rank writes, since in a ring round
    a rank both sends and receives, and :meth:`DensePlan.execute_numpy`
    copies every payload of a round before it writes one.  Within a round
    each real ``(rank, segment)`` slot is written once, so the adds are
    the ones :meth:`DensePlan.execute_numpy` does, in the same order; only
    the sentinel row ``n_seg``, which no real slot reads, takes
    duplicates.
    """
    device = resolve_device(device)
    P = plan.topo.n_procs
    ranks = torch.arange(P, device=device)[:, None]
    rounds = []
    for pairs, g, s, red in _pack_device_rounds(plan):
        src_of = np.full(P, P, dtype=np.int64)    # P: the zero row
        for src, dst in pairs:
            src_of[dst] = src
        rounds.append((
            torch.as_tensor(src_of, device=device),
            torch.as_tensor(g, dtype=torch.int64, device=device),
            torch.as_tensor(s, dtype=torch.int64, device=device),
            red,
        ))

    def run(buf: torch.Tensor) -> torch.Tensor:
        sentinel = buf.new_zeros((P, 1) + buf.shape[2:])
        buf = torch.cat([buf, sentinel], dim=1)
        for src_of, g, s, red in rounds:
            send = buf[ranks, g]                  # [P, w, cmax], a copy
            send = torch.cat([send, send.new_zeros((1,) + send.shape[1:])])
            recv = send[src_of]
            if red:
                buf[ranks, s] = buf[ranks, s] + recv
            else:
                buf[ranks, s] = recv
        return buf[:, :-1]

    return run


def bind_dense(plan: DensePlan, device=None) -> Callable:
    """The standalone executor of ``plan`` on ``device`` (default ``cuda``).

    Rank-stacked shapes (rank ``p`` is row ``p``):

    * allreduce:       ``[P, n_seg, cmax] -> [P, n_seg, cmax]`` (all rows
      hold the full sums)
    * reduce_scatter:  ``[P, n_seg, cmax] -> [P, cmax]`` (rank p's row is
      its summed segment, zero-padded past ``counts[p]``)
    * allgatherv:      ``[P, cmax] -> [P, n_seg, cmax]`` (own segment in,
      every segment out)

    Use :func:`pack_dense_input` / :func:`unpack_dense_output` to move
    between per-rank vectors and the padded segment layout.
    """
    device = resolve_device(device)
    run = dense_round_runner(plan, device)
    P, n_seg, cmax = plan.topo.n_procs, len(plan.counts), plan.cmax
    diag = torch.arange(P, device=device)

    if plan.collective == "allgatherv":

        def fn(x: torch.Tensor) -> torch.Tensor:     # [P, cmax]
            buf = x.new_zeros((P, n_seg, cmax))
            buf[diag, diag] = x
            return run(buf)

    elif plan.collective == "reduce_scatter":

        def fn(x: torch.Tensor) -> torch.Tensor:     # [P, n_seg, cmax]
            return run(x)[diag, diag]

    else:                                            # allreduce

        def fn(x: torch.Tensor) -> torch.Tensor:
            return run(x)

    return fn


def pack_dense_input(plan: DensePlan, vals: Sequence[np.ndarray]) -> np.ndarray:
    """Per-rank inputs -> the executor's padded rank-stacked array.

    allreduce / reduce_scatter: ``vals[p]`` is the rank's full ``[n]``
    contribution -> ``[P, n_seg, cmax]``; allgatherv: ``vals[p]`` is the
    owned segment ``[counts[p]]`` -> ``[P, cmax]``.
    """
    P = plan.topo.n_procs
    cmax = plan.cmax
    if plan.collective == "allgatherv":
        out = np.zeros((P, cmax), dtype=vals[0].dtype)
        for p in range(P):
            out[p, : int(plan.counts[p])] = vals[p]
        return out
    bounds = np.cumsum(plan.counts)[:-1]
    out = np.zeros((P, len(plan.counts), cmax), dtype=vals[0].dtype)
    for p in range(P):
        for s, seg in enumerate(np.split(np.asarray(vals[p]), bounds)):
            out[p, s, : len(seg)] = seg
    return out


def unpack_dense_output(plan: DensePlan, out) -> List[np.ndarray]:
    """Executor output (a numpy array or a tensor on any device) ->
    per-rank logical results (unpadded)."""
    P = plan.topo.n_procs
    if isinstance(out, torch.Tensor):
        out = out.cpu().numpy()
    out = np.asarray(out)
    if plan.collective == "reduce_scatter":
        return [out[p, : int(plan.counts[p])] for p in range(P)]
    return [
        np.concatenate(
            [out[p, s, : int(plan.counts[s])] for s in range(len(plan.counts))]
        )
        for p in range(P)
    ]


# ---------------------------------------------------------------------------
# measurement (the calibration feed)
# ---------------------------------------------------------------------------


def measure_dense_seconds(
    plan: DensePlan,
    device=None,
    dtype=np.float64,
    iters: int = 20,
    warmup: int = 3,
    seed: int = 0,
    tracer=None,
    executor: Optional[Callable] = None,
) -> float:
    """Measured wall seconds per collective execution on ``device``
    (default ``cuda``): the protocol of
    ``core.collectives.time_executor`` over :func:`bind_dense` (or the
    given ``executor``) on a seeded input of the plan's layout.

    With ``tracer`` (a ``profile.TraceRecorder``) the timing is recorded
    against the plan as a ``pure_exchange`` sample under the plan's dense
    fingerprint; without one, the obs span bridge forwards the same sample
    to any tracer attached to the enabled obs layer, so dense exchanges
    feed the rate fit like the sparse transports.
    """
    device = resolve_device(device)
    P = plan.topo.n_procs
    n_seg, cmax = len(plan.counts), plan.cmax
    if plan.collective == "allgatherv":
        shape = (P, cmax)
    else:
        shape = (P, n_seg, cmax)
    fn = executor if executor is not None else bind_dense(plan, device)
    x = torch.as_tensor(
        np.random.default_rng(seed).normal(size=shape).astype(dtype),
        device=device,
    )
    with _OBS.span("dense/measure", collective=plan.collective,
                   variant=plan.variant, n_procs=P) as sp:
        secs = time_calls(fn, x, iters, warmup)
        if tracer is not None:
            tracer.record_plan(plan, secs, label=f"dense/{plan.strategy}",
                               pure_exchange=True,
                               fingerprint=plan.fingerprint)
        else:
            sp.set(plan=plan, pure_exchange=True, seconds=secs,
                   fingerprint=plan.fingerprint)
    return secs
