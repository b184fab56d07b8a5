"""Locality-aware aggregation planners (paper Sections 3.1-3.3).

Three strategies build a :class:`~repro_torch.core.plan.CommPlan` from a
:class:`~repro_torch.core.plan.CommPattern`:

``standard``
    Algorithm 1-3: every (src, dst) pair exchanges one direct message,
    regardless of locality.  This is what wrapping point-to-point
    communication in a neighborhood collective gives you.

``partial`` (locality-aware aggregation, Section 3.2)
    Three-step aggregation.  Traffic between processes of the *same* region
    stays direct (step ``l``).  Inter-region traffic is (s) redistributed
    inside the source region so that one designated process per destination
    region holds everything bound for it, (g) sent as a single message per
    (region, region) pair, and (r) redistributed inside the destination
    region.  Which local rank serves which remote region is load-balanced.
    Duplicate values (one value needed by several processes of a remote
    region) still cross the wire multiple times — the standard API carries
    no value identity.

``full`` (duplicate removal, Section 3.3)
    Same three-step path, but the planner exploits global value indices (the
    paper's proposed API extension) to move each distinct value at most once
    per hop: once from its owner to the source-region leader, once across
    regions, and fan out to all final destinations only inside the
    destination region.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .plan import (
    CommPattern,
    CommPlan,
    CommStep,
    Message,
    PlanStats,
    StepStats,
    Topology,
)

STRATEGIES = ("standard", "partial", "full")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _group_needs_by_owner(
    pattern: CommPattern,
) -> List[List[Tuple[int, np.ndarray, np.ndarray]]]:
    """For each dst proc q: list of (src proc, global idx, ghost slots)."""
    out = []
    for q in range(pattern.n_procs):
        need = pattern.needs[q]
        entries: List[Tuple[int, np.ndarray, np.ndarray]] = []
        if len(need):
            owners = pattern.owner_proc[need]
            order = np.argsort(owners, kind="stable")
            sorted_owners = owners[order]
            bounds = np.flatnonzero(np.diff(sorted_owners)) + 1
            for chunk in np.split(order, bounds):
                src = int(owners[chunk[0]])
                entries.append((src, need[chunk], chunk))
        out.append(entries)
    return out


def balance_assignments(
    weights: Dict[int, int], n_workers: int
) -> Dict[int, int]:
    """LPT greedy: assign each key (a remote region) to the least-loaded
    worker (a local rank), heaviest first.  This is the paper's load
    balancing of inter-region responsibility across a region's processes:
    'a minimal portion of messages for small data sizes, or an equal portion
    of data when sizes are large'."""
    loads = np.zeros(n_workers, dtype=np.int64)
    counts = np.zeros(n_workers, dtype=np.int64)
    assign: Dict[int, int] = {}
    # heaviest first; deterministic tie-break on key
    for key in sorted(weights, key=lambda k: (-weights[k], k)):
        w = int(np.lexsort((counts, loads))[0])
        assign[key] = w
        loads[w] += weights[key]
        counts[w] += 1
    return assign


# ---------------------------------------------------------------------------
# standard (Section 3.1)
# ---------------------------------------------------------------------------


def plan_standard(
    pattern: CommPattern, topo: Topology, value_bytes: int = 8
) -> CommPlan:
    msgs: List[Message] = []
    by_owner = _group_needs_by_owner(pattern)
    for q in range(pattern.n_procs):
        for src, gidx, ghost_slots in by_owner[q]:
            msgs.append(
                Message(
                    src=src,
                    dst=q,
                    src_idx=pattern.owner_slot[gidx],
                    dst_idx=ghost_slots,
                )
            )
    ghost_sizes = np.array([len(n) for n in pattern.needs], dtype=np.int64)
    step = CommStep(
        name="p2p",
        messages=msgs,
        in_sizes=pattern.n_local.copy(),
        out_sizes=ghost_sizes,
        reads_local=True,
        writes_ghost=True,
    )
    stats = PlanStats([StepStats.from_messages("p2p", msgs, topo)], value_bytes)
    return CommPlan("standard", topo, pattern, [step], stats)


# ---------------------------------------------------------------------------
# three-step aggregation (Sections 3.2 / 3.3) — shared machinery
# ---------------------------------------------------------------------------


def _plan_aggregated(
    pattern: CommPattern,
    topo: Topology,
    dedup: bool,
    value_bytes: int = 8,
) -> CommPlan:
    P = topo.n_procs
    by_owner = _group_needs_by_owner(pattern)

    # ---- step l: fully-local traffic (direct, incl. self-copies) ----------
    l_msgs: List[Message] = []
    # inter-region demand:
    #   per (src_region R, dst_region S):  entries to cross the wire.
    # dedup=False: one entry per (owner proc p, value g, final dst proc q)
    # dedup=True : one entry per (owner proc p, value g)
    # Collected as: demand[R][S][p] = list of (g, [(q, ghost_slot), ...])
    demand: Dict[int, Dict[int, Dict[int, Dict[int, List[Tuple[int, int]]]]]] = (
        defaultdict(lambda: defaultdict(lambda: defaultdict(dict)))
    )
    for q in range(P):
        S = topo.region(q)
        for src, gidx, ghost_slots in by_owner[q]:
            R = topo.region(src)
            if R == S:
                l_msgs.append(
                    Message(
                        src=src,
                        dst=q,
                        src_idx=pattern.owner_slot[gidx],
                        dst_idx=ghost_slots,
                    )
                )
            else:
                dd = demand[R][S][src]
                for g, slot in zip(gidx.tolist(), ghost_slots.tolist()):
                    dd.setdefault(g, []).append((q, slot))

    ghost_sizes = np.array([len(n) for n in pattern.needs], dtype=np.int64)
    n_local = pattern.n_local

    # ---- leader election + load balancing ---------------------------------
    # send side: region R assigns each destination region S to a local rank
    # recv side: region S assigns each source region R to a local rank
    send_leader: Dict[Tuple[int, int], int] = {}
    recv_leader: Dict[Tuple[int, int], int] = {}

    def wire_entries(R: int, S: int) -> int:
        total = 0
        for p, dd in demand[R][S].items():
            for g, dests in dd.items():
                total += 1 if dedup else len(dests)
        return total

    for R in list(demand.keys()):
        weights = {S: wire_entries(R, S) for S in demand[R]}
        assign = balance_assignments(weights, topo.procs_per_region)
        for S, lr in assign.items():
            send_leader[(R, S)] = R * topo.procs_per_region + lr
    recv_weights: Dict[int, Dict[int, int]] = defaultdict(dict)
    for R in demand:
        for S in demand[R]:
            recv_weights[S][R] = wire_entries(R, S)
    for S, weights in recv_weights.items():
        assign = balance_assignments(weights, topo.procs_per_region)
        for R, lr in assign.items():
            recv_leader[(S, R)] = S * topo.procs_per_region + lr

    # ---- build step s (initial local redistribution) ----------------------
    # stage_s buffer on each send leader: contiguous segments per (S, p, g[,q])
    s_offsets = np.zeros(P, dtype=np.int64)  # running size of stage_s per proc
    s_msgs_acc: Dict[Tuple[int, int], Tuple[List[int], List[int]]] = defaultdict(
        lambda: ([], [])
    )
    # position of each wire entry in the leader's stage_s buffer:
    #   key (R, S) -> list over entries in wire order of
    #   (stage_pos_on_leader, g, [(q, slot), ...])
    wire_layout: Dict[Tuple[int, int], List[Tuple[int, int, List[Tuple[int, int]]]]] = {}

    for R in sorted(demand.keys()):
        for S in sorted(demand[R].keys()):
            ldr = send_leader[(R, S)]
            layout: List[Tuple[int, int, List[Tuple[int, int]]]] = []
            for p in sorted(demand[R][S].keys()):
                dd = demand[R][S][p]
                src_slots: List[int] = []
                stage_pos: List[int] = []
                for g in sorted(dd.keys()):
                    dests = dd[g]
                    owner_slot = int(pattern.owner_slot[g])
                    if dedup:
                        pos = int(s_offsets[ldr]) + len(stage_pos)
                        src_slots.append(owner_slot)
                        stage_pos.append(pos)
                        layout.append((pos, g, dests))
                    else:
                        for (q, slot) in dests:
                            pos = int(s_offsets[ldr]) + len(stage_pos)
                            src_slots.append(owner_slot)
                            stage_pos.append(pos)
                            layout.append((pos, g, [(q, slot)]))
                if src_slots:
                    acc = s_msgs_acc[(p, ldr)]
                    acc[0].extend(src_slots)
                    acc[1].extend(stage_pos)
                    s_offsets[ldr] += len(src_slots)
            wire_layout[(R, S)] = layout

    s_msgs = [
        Message(src=p, dst=ldr, src_idx=np.array(si), dst_idx=np.array(di))
        for (p, ldr), (si, di) in s_msgs_acc.items()
    ]

    # ---- build step g (inter-region) ---------------------------------------
    g_offsets = np.zeros(P, dtype=np.int64)  # stage_g size per proc
    g_msgs: List[Message] = []
    # recv-side layout: key (S, R) -> list of (stage_g_pos_on_recv_leader, g, dests)
    recv_layout: Dict[Tuple[int, int], List[Tuple[int, int, List[Tuple[int, int]]]]] = {}
    for (R, S), layout in sorted(wire_layout.items()):
        if not layout:
            continue
        ldr = send_leader[(R, S)]
        rcv = recv_leader[(S, R)]
        src_idx = np.array([pos for pos, _, _ in layout], dtype=np.int64)
        base = int(g_offsets[rcv])
        dst_idx = base + np.arange(len(layout), dtype=np.int64)
        g_offsets[rcv] += len(layout)
        g_msgs.append(Message(src=ldr, dst=rcv, src_idx=src_idx, dst_idx=dst_idx))
        recv_layout[(S, R)] = [
            (base + i, g, dests) for i, (_, g, dests) in enumerate(layout)
        ]

    # ---- build step r (final local redistribution, with fan-out) ----------
    r_msgs_acc: Dict[Tuple[int, int], Tuple[List[int], List[int]]] = defaultdict(
        lambda: ([], [])
    )
    for (S, R), layout in sorted(recv_layout.items()):
        rcv = recv_leader[(S, R)]
        for pos, g, dests in layout:
            for (q, slot) in dests:
                acc = r_msgs_acc[(rcv, q)]
                acc[0].append(pos)
                acc[1].append(slot)
    r_msgs = [
        Message(src=rcv, dst=q, src_idx=np.array(si), dst_idx=np.array(di))
        for (rcv, q), (si, di) in r_msgs_acc.items()
    ]

    stage_s_sizes = s_offsets
    stage_g_sizes = g_offsets

    steps = [
        CommStep(
            name="l",
            messages=l_msgs,
            in_sizes=n_local.copy(),
            out_sizes=ghost_sizes,
            reads_local=True,
            writes_ghost=True,
        ),
        CommStep(
            name="s",
            messages=s_msgs,
            in_sizes=n_local.copy(),
            out_sizes=stage_s_sizes,
            reads_local=True,
        ),
        CommStep(
            name="g",
            messages=g_msgs,
            in_sizes=stage_s_sizes,
            out_sizes=stage_g_sizes,
        ),
        CommStep(
            name="r",
            messages=r_msgs,
            in_sizes=stage_g_sizes,
            out_sizes=ghost_sizes,
            writes_ghost=True,
        ),
    ]
    stats = PlanStats(
        [StepStats.from_messages(s.name, s.messages, topo) for s in steps],
        value_bytes,
    )
    return CommPlan("full" if dedup else "partial", topo, pattern, steps, stats)


def plan_partial(
    pattern: CommPattern, topo: Topology, value_bytes: int = 8
) -> CommPlan:
    return _plan_aggregated(pattern, topo, dedup=False, value_bytes=value_bytes)


def plan_full(pattern: CommPattern, topo: Topology, value_bytes: int = 8) -> CommPlan:
    return _plan_aggregated(pattern, topo, dedup=True, value_bytes=value_bytes)


PLANNERS = {
    "standard": plan_standard,
    "partial": plan_partial,
    "full": plan_full,
}


def build_plan(
    pattern: CommPattern,
    topo: Topology,
    strategy: str,
    value_bytes: int = 8,
) -> CommPlan:
    if strategy not in PLANNERS:
        raise ValueError(f"unknown strategy {strategy!r}; choose from {STRATEGIES}")
    return PLANNERS[strategy](pattern, topo, value_bytes=value_bytes)
