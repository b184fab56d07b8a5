"""Locality-aware communication cost model (paper refs [2,6,16,32]).

The locality-aware max-rate model of Bienz/Gropp/Olson: postal model
``alpha + bytes/beta`` with distinct parameters per locality class, plus a
per-region injection-bandwidth cap shared by the region's active senders.

One parameter set ships: ``LASSEN``, constants representative of the
paper's system (Power9 + EDR InfiniBand; on-node via shared memory).  The
compute-side terms (:func:`spmv_compute_time`,
:func:`overlap_split_overhead`) take the device's memory rate, arithmetic
rate and launch cost as explicit arguments: no device's figures are built
in.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .plan import CommPlan, PlanStats, Topology


@dataclass(frozen=True)
class MachineParams:
    name: str
    # postal parameters per locality class
    alpha_intra: float  # latency, s
    beta_intra: float   # per-proc bandwidth, B/s
    alpha_inter: float
    beta_inter: float
    # max-rate: total injection bandwidth out of a region, B/s (shared)
    region_injection_bw: float
    # short-message eager cutoff: below this, latency dominates & msgs pipeline
    eager_bytes: int = 8192


LASSEN = MachineParams(
    name="lassen-smp",
    alpha_intra=5.0e-7,
    beta_intra=30.0e9,
    alpha_inter=2.2e-6,
    beta_inter=11.0e9,
    region_injection_bw=22.0e9,
)


def step_time(
    stats_step, topo: Topology, params: MachineParams, value_bytes: int
) -> float:
    """Max-rate time of one plan step (bulk-synchronous: max over procs)."""
    intra_b = stats_step.intra_vals * value_bytes
    inter_b = stats_step.inter_vals * value_bytes
    t_proc = (
        stats_step.intra_msgs * params.alpha_intra
        + intra_b / params.beta_intra
        + stats_step.inter_msgs * params.alpha_inter
        + inter_b / params.beta_inter
    )
    # max-rate injection constraint: a region's combined inter-region bytes
    # cannot exceed its injection bandwidth.
    R = topo.n_regions
    per_region = inter_b.reshape(R, topo.procs_per_region).sum(axis=1)
    t_inject = per_region / params.region_injection_bw
    t_region = (
        t_proc.reshape(R, topo.procs_per_region).max(axis=1)
    )
    return float(np.maximum(t_region, t_inject).max())


def stats_time(stats: PlanStats, topo: Topology, params: MachineParams) -> float:
    """Modeled per-iteration time from plan *stats* alone.

    Steps are dependency-ordered (s -> g -> r) except step ``l`` which
    overlaps the global path (the paper starts ``l`` and ``g`` together and
    waits at the end): total = max(l, s + g + r).
    """
    vb = stats.value_bytes
    by_name = {s.name: step_time(s, topo, params, vb) for s in stats.steps}
    if set(by_name) == {"p2p"}:
        return by_name["p2p"]
    if not set(by_name) <= {"p2p", "l", "s", "g", "r"}:
        # generic round schedules are bulk-synchronous and
        # dependency-ordered -> plain serial sum.
        return float(sum(by_name.values()))
    serial = by_name.get("s", 0.0) + by_name.get("g", 0.0) + by_name.get("r", 0.0)
    return max(by_name.get("l", 0.0), serial)


def plan_time(plan: CommPlan, params: MachineParams) -> float:
    """Modeled per-iteration time of a plan (see :func:`stats_time`)."""
    return stats_time(plan.stats, plan.topo, params)


# ---------------------------------------------------------------------------
# Exchange/compute overlap terms.
#
# The split SpMV schedule (sparse.device.make_distributed_spmv(overlap=True))
# runs the local-bucket matvec while the exchange is in flight, so of a
# modeled exchange time tx only max(0, tx - tl) stays exposed, where tl is
# the local compute time: a memory-bound sparse stream against the device's
# arithmetic rate, both given by the caller.
# ---------------------------------------------------------------------------

_IDX_BYTES = 4  # int32 column indices


def spmv_compute_time(
    nnz: int,
    rows: int,
    x_len: int,
    *,
    hbm_bw: float,
    vpu_flops: float,
    value_bytes: int = 8,
) -> float:
    """Roofline compute time of one per-rank ELL matvec phase: stream
    nnz (cols + vals) + x + y through device memory at ``hbm_bw`` B/s,
    2 flops per nonzero at ``vpu_flops`` flop/s."""
    bytes_moved = (
        nnz * (_IDX_BYTES + value_bytes)
        + x_len * value_bytes
        + rows * value_bytes
    )
    flops = 2.0 * nnz
    return max(bytes_moved / hbm_bw, flops / vpu_flops)


def overlap_split_overhead(
    rows: int,
    *,
    hbm_bw: float,
    launch_s: float,
    value_bytes: int = 8,
) -> float:
    """Cost of splitting the SpMV into local + ghost phases: the carried
    partial output makes one extra device-memory round trip (write then
    read of ``rows`` values), plus one extra kernel launch of ``launch_s``
    seconds."""
    return launch_s + 2.0 * rows * value_bytes / hbm_bw


def exposed_exchange_seconds(exchange_s: float, local_s: float) -> float:
    """Exchange time left exposed when local compute runs concurrently."""
    return max(0.0, float(exchange_s) - float(local_s))


def hidden_fraction(exchange_s: float, local_s: float) -> float:
    """Fraction of the exchange hidden behind local compute (0 when there
    is no exchange)."""
    tx = float(exchange_s)
    if tx <= 0.0:
        return 0.0
    return min(tx, float(local_s)) / tx
