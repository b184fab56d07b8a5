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

The fit (:func:`fit_machine_params`) turns measured exchange timings
(:class:`RateSample`) back into a :class:`MachineParams`; its arithmetic is
``repro.core.costmodel``'s line for line, so the two packages fit the same
samples to the same rates.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

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


def init_time(plan: CommPlan, params: MachineParams,
              measured_wall: float = 0.0) -> float:
    """Modeled network cost of the persistent init (graph creation +
    aggregation setup), comparable with the modeled per-iteration cost:

    * one handshake round-trip per neighbor (topology/graph creation),
    * two index-exchange sweeps over the plan's own message structure
      (int32 indices instead of f64 values — the load-balancing and
      path-setup traffic of aggregated strategies).

    ``measured_wall`` (host planning time) is reported separately by the
    benchmarks — it is C-library work in the paper's MPI Advance, so the
    python wall time is not added into the modeled crossover."""
    st = plan.stats
    handshakes = int(st.inter_msgs.max() + st.intra_msgs.max())
    index_sweeps = 2 * plan_time(plan, params) * (4.0 / plan.stats.value_bytes)
    return handshakes * params.alpha_inter * 2 + index_sweeps


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


def modeled_fine_exchange_time(
    n_neighbors: int,
    ghost_values: int,
    value_bytes: int = 8,
    params: MachineParams = LASSEN,
) -> float:
    """Postal-model exchange time of an analytic paper-scale fine level
    (``n_neighbors`` inter-region messages carrying ``ghost_values`` values
    in total) — for benchmark rows where the matrix is never materialized
    and no plan exists to run :func:`plan_time` on."""
    return (
        n_neighbors * params.alpha_inter
        + ghost_values * value_bytes / params.beta_inter
    )


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


# ---------------------------------------------------------------------------
# Fit-from-samples: turn measured exchange timings into a MachineParams.
#
# The max-rate model is piecewise linear in
#   theta = (alpha_intra, 1/beta_intra, alpha_inter, 1/beta_inter,
#            1/region_injection_bw)
# with the active piece determined by which process (or which region's
# injection cap) is the bottleneck of each step.  Fitting therefore
# alternates (a) selecting each sample's bottleneck rows under the current
# theta with (b) a nonnegative least-squares solve over the resulting
# linear features — a majorize-style loop that recovers the generating
# params exactly when samples were synthesized from this very model (the
# round-trip property that ``profile.calibrate.synthesize_trace`` checks).
# ``eager_bytes`` is not a rate and is held fixed at the reference value.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RateSample:
    """One fitting observation: exact plan traffic + a measured time."""

    stats: PlanStats
    topo: Topology
    seconds: float
    label: str = ""


THETA_FIELDS = (
    "alpha_intra", "inv_beta_intra", "alpha_inter", "inv_beta_inter",
    "inv_injection_bw",
)


def _theta_of(params: MachineParams) -> np.ndarray:
    return np.array([
        params.alpha_intra,
        1.0 / params.beta_intra,
        params.alpha_inter,
        1.0 / params.beta_inter,
        1.0 / params.region_injection_bw,
    ])


def _params_of(theta: np.ndarray, name: str, ref: MachineParams,
               excited: np.ndarray) -> MachineParams:
    """theta -> MachineParams; columns the samples never excited (or that
    fit to zero rate) fall back to the reference so the result is always a
    finite, usable parameter set."""
    t = np.where(excited, theta, _theta_of(ref))

    def inv(x: float, fallback: float) -> float:
        return 1.0 / x if x > 0 else fallback

    return MachineParams(
        name=name,
        alpha_intra=float(max(t[0], 0.0)),
        beta_intra=inv(float(t[1]), ref.beta_intra),
        alpha_inter=float(max(t[2], 0.0)),
        beta_inter=inv(float(t[3]), ref.beta_inter),
        region_injection_bw=inv(float(t[4]), ref.region_injection_bw),
        eager_bytes=ref.eager_bytes,  # not a rate: held fixed
    )


def _nnls(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Lawson-Hanson nonnegative least squares (tiny: n <= 5 here)."""
    m, n = A.shape
    x = np.zeros(n)
    passive = np.zeros(n, dtype=bool)
    w = A.T @ (b - A @ x)
    tol = 1e-12 * (float(np.abs(A).sum()) + 1.0)
    budget = 10 * (n + 1)
    while budget > 0 and (~passive).any() and \
            float(np.max(np.where(~passive, w, -np.inf))) > tol:
        budget -= 1
        j = int(np.argmax(np.where(~passive, w, -np.inf)))
        passive[j] = True
        while True:
            s = np.zeros(n)
            s[passive] = np.linalg.lstsq(A[:, passive], b, rcond=None)[0]
            if not passive.any() or float(s[passive].min()) > tol:
                break
            neg = passive & (s <= tol)
            denom = x[neg] - s[neg]
            ratios = np.where(denom > 0, x[neg] / np.maximum(denom, 1e-300),
                              0.0)
            alpha = float(ratios.min()) if len(ratios) else 0.0
            x = x + alpha * (s - x)
            passive &= x > tol
            budget -= 1
            if budget <= 0:
                break
        x = s
        w = A.T @ (b - A @ x)
    return np.maximum(x, 0.0)


def _step_feature(step, topo: Topology, value_bytes: int,
                  theta: np.ndarray) -> np.ndarray:
    """Bottleneck feature row of one step under ``theta``.

    Candidates are each process's (msgs, bytes) row and each region's
    injection row — exactly the max() arms of :func:`step_time`."""
    P = topo.n_procs
    intra_b = step.intra_vals * value_bytes
    inter_b = step.inter_vals * value_bytes
    proc_rows = np.stack([
        step.intra_msgs, intra_b, step.inter_msgs, inter_b,
        np.zeros(P),
    ], axis=1).astype(float)
    R = topo.n_regions
    per_region = inter_b.reshape(R, topo.procs_per_region).sum(axis=1)
    inj_rows = np.zeros((R, 5))
    inj_rows[:, 4] = per_region
    rows = np.concatenate([proc_rows, inj_rows], axis=0)
    return rows[int(np.argmax(rows @ theta))]


def _sample_feature(sample: RateSample, theta: np.ndarray) -> np.ndarray:
    """Feature row of a whole sample: mirrors :func:`stats_time`'s
    max(l, s + g + r) composition under the current ``theta``."""
    vb = sample.stats.value_bytes
    by_name = {
        s.name: _step_feature(s, sample.topo, vb, theta)
        for s in sample.stats.steps
    }
    if set(by_name) == {"p2p"}:
        return by_name["p2p"]
    if not set(by_name) <= {"p2p", "l", "s", "g", "r"}:
        # generic round schedules (dense d0..dk): serial sum, mirroring
        # stats_time's composition so the fit sees the same arithmetic.
        return np.sum(list(by_name.values()), axis=0)
    zero = np.zeros(5)
    serial = (by_name.get("s", zero) + by_name.get("g", zero)
              + by_name.get("r", zero))
    overlap = by_name.get("l", zero)
    return overlap if overlap @ theta >= serial @ theta else serial


def fit_machine_params(
    samples: Sequence[RateSample],
    name: str = "fitted",
    ref: MachineParams = LASSEN,
    max_outer: int = 50,
    rel_tol: float = 1e-9,
) -> Tuple[MachineParams, Dict[str, float]]:
    """Least-squares fit of MachineParams from measured exchange samples.

    Returns ``(params, gof)`` where ``gof`` carries ``residual`` (l2 of
    seconds), ``rel_rmse`` (rms of per-sample relative error over nonzero
    samples), ``r2``, ``n_samples``, ``outer_iters`` and ``converged``
    (1.0/0.0).  ``ref`` seeds the bottleneck selection and backfills any
    rate the samples do not excite.
    """
    samples = [s for s in samples if s.seconds > 0.0]
    if not samples:
        raise ValueError("fit_machine_params needs at least one sample "
                         "with seconds > 0")
    t = np.array([s.seconds for s in samples])
    theta = _theta_of(ref)
    converged = False
    outer = 0
    best = (np.inf, theta, np.zeros((len(samples), 5)))
    stale = 0
    for outer in range(1, max_outer + 1):
        F = np.stack([_sample_feature(s, theta) for s in samples])
        col = np.linalg.norm(F, axis=0)
        excited = col > 0
        theta_new = _theta_of(ref).copy()
        if excited.any():
            scale = np.where(excited, col, 1.0)
            theta_new[excited] = (
                _nnls(F[:, excited] / scale[excited], t) / scale[excited]
            )
        denom = np.maximum(np.abs(theta), 1e-300)
        delta = float(np.max(np.abs(theta_new - theta) / denom))
        theta = theta_new
        resid_now = float(np.linalg.norm(F @ theta - t))
        if resid_now < best[0] * (1.0 - 1e-6) - 1e-300:
            best = (resid_now, theta.copy(), F.copy())
            stale = 0
        else:
            stale += 1
        if delta < rel_tol:
            converged = True
            break
        if stale >= 2:
            # objective plateaued: noisy measurements can cycle between
            # near-tied bottleneck selections — accept the best iterate
            converged = True
            break
    if np.isfinite(best[0]):
        theta, F = best[1], best[2]
    pred = F @ theta
    resid = pred - t
    nz = t > 0
    ss_tot = float(np.sum((t - t.mean()) ** 2))
    gof = {
        "residual": float(np.linalg.norm(resid)),
        "rel_rmse": float(np.sqrt(np.mean((resid[nz] / t[nz]) ** 2))),
        "r2": (1.0 - float(np.sum(resid ** 2)) / ss_tot) if ss_tot > 0
        else 1.0,
        "n_samples": float(len(samples)),
        "outer_iters": float(outer),
        "converged": 1.0 if converged else 0.0,
    }
    excited = np.linalg.norm(F, axis=0) > 0
    return _params_of(theta, name, ref, excited), gof
