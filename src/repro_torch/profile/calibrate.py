"""Measured-rate calibration: fit MachineParams from a trace, report fit
quality, and compare Section-5 selections under fitted vs shipped rates.

Ported from ``repro.profile.calibrate``; the fit's reference defaults to
the paper's ``LASSEN``, the only parameter set the port ships.

The numeric fit lives in ``core.costmodel.fit_machine_params`` (the
piecewise-linear max-rate model alternated with nonnegative least squares);
this module is the orchestration around it: trace -> fit ->
:class:`CalibrationResult` (params + goodness-of-fit + shipped-vs-fitted
table), plus :func:`synthesize_trace` (the round-trip oracle: samples
generated *from* the cost model must fit back to the generating params)
and :func:`rate_probe_patterns` (a pattern set that
excites every fitted rate: intra latency/bandwidth, inter
latency/bandwidth, and the region injection cap).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.costmodel import (
    MachineParams,
    RateSample,
    LASSEN,
    fit_machine_params,
    plan_time,
)
from ..core.locality import build_plan
from ..core.plan import CommPattern, CommPlan, Topology
from .trace import TraceRecorder

PARAM_FIELDS = ("alpha_intra", "beta_intra", "alpha_inter", "beta_inter",
                "region_injection_bw", "eager_bytes")


@dataclass
class CalibrationResult:
    """A fitted MachineParams plus how well it explains the trace."""

    params: MachineParams
    ref: MachineParams          # the shipped constants the fit started from
    gof: Dict[str, float]
    n_samples: int

    @property
    def converged(self) -> bool:
        return bool(self.gof.get("converged", 0.0)) and all(
            np.isfinite(getattr(self.params, f)) for f in PARAM_FIELDS
        )

    def table(self) -> str:
        """Fitted-vs-shipped MachineParams table: one row per rate, with
        the fitted/shipped ratio."""
        rows = [f"{'param':>20s} {'shipped':>12s} {'fitted':>12s} "
                f"{'ratio':>8s}"]
        for f in PARAM_FIELDS:
            a = float(getattr(self.ref, f))
            b = float(getattr(self.params, f))
            ratio = b / a if a else float("inf")
            rows.append(f"{f:>20s} {a:12.4g} {b:12.4g} {ratio:8.3f}")
        g = self.gof
        rows.append(
            f"fit: n={self.n_samples} rel_rmse={g['rel_rmse']:.3f} "
            f"r2={g['r2']:.3f} iters={int(g['outer_iters'])} "
            f"converged={bool(g['converged'])}"
        )
        return "\n".join(rows)

    def to_json(self) -> Dict:
        return {
            "fitted": dataclasses.asdict(self.params),
            "shipped": dataclasses.asdict(self.ref),
            "gof": self.gof,
            "n_samples": self.n_samples,
        }

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)


def fit_trace(
    trace: TraceRecorder | Sequence[RateSample],
    name: str = "fitted",
    ref: MachineParams = LASSEN,
    pure_only: bool = True,
) -> CalibrationResult:
    """Fit MachineParams from a trace (or raw RateSamples).

    Only ``pure_exchange`` samples enter the fit by default: MoE dispatch
    wall times include expert compute and would bias the wire rates.
    Raises ``ValueError`` when the trace holds no usable samples.
    """
    if isinstance(trace, TraceRecorder):
        samples = trace.merged_rate_samples(pure_only=pure_only)
    else:
        samples = list(trace)
    params, gof = fit_machine_params(samples, name=name, ref=ref)
    return CalibrationResult(params=params, ref=ref, gof=gof,
                             n_samples=len(samples))


def synthesize_trace(
    plans: Sequence[CommPlan],
    params: MachineParams,
    label_prefix: str = "synthetic",
) -> TraceRecorder:
    """Trace whose seconds are the cost model's own predictions under
    ``params`` — the round-trip oracle: ``fit_trace`` on this trace must
    recover ``params`` (rates the plan set excites) to high precision."""
    tr = TraceRecorder()
    for i, plan in enumerate(plans):
        tr.record_plan(plan, plan_time(plan, params),
                       label=f"{label_prefix}/{i}", pure_exchange=True)
    return tr


def rate_probe_patterns(
    topo: Topology, n_per: int = 64
) -> List[Tuple[str, CommPattern]]:
    """Patterns that jointly excite all five fitted rates on ``topo``.

    * ``intra_latency``  — many 1-value messages inside one region
    * ``intra_band``     — one large message inside one region
    * ``inter_latency``  — many 1-value messages between two procs of
      different regions
    * ``inter_band``     — one large inter-region message from a single
      sender (per-proc bandwidth binds, not the shared injection cap)
    * ``injection``      — every proc of region 0 streams large messages
      out of the region (the summed bytes hit the injection cap)

    Requires at least two regions with at least two procs each for the
    full set; degenerate topologies get the subset that exists.
    """
    P = topo.n_procs
    ppr = topo.procs_per_region
    offsets = np.arange(P + 1) * n_per

    def empty_needs() -> List[np.ndarray]:
        return [np.empty(0, dtype=np.int64) for _ in range(P)]

    probes: List[Tuple[str, CommPattern]] = []

    if ppr > 1:
        # intra latency: proc 1..ppr-1 each need 1 value of proc 0
        needs = empty_needs()
        for q in range(1, ppr):
            needs[q] = np.array([0], dtype=np.int64)
        probes.append(
            ("intra_latency", CommPattern.from_block_partition(needs, offsets))
        )
        # intra bandwidth: proc 1 needs all of proc 0
        needs = empty_needs()
        needs[1] = np.arange(n_per, dtype=np.int64)
        probes.append(
            ("intra_band", CommPattern.from_block_partition(needs, offsets))
        )
    if topo.n_regions > 1:
        far = ppr  # first proc of region 1
        # inter latency: one value of each proc of region 0 -> proc `far`
        needs = empty_needs()
        needs[far] = np.array([p * n_per for p in range(ppr)], dtype=np.int64)
        probes.append(
            ("inter_latency", CommPattern.from_block_partition(needs, offsets))
        )
        # inter bandwidth: proc `far` needs all of proc 0 (single sender:
        # per-proc beta_inter binds before the region injection cap)
        needs = empty_needs()
        needs[far] = np.arange(n_per, dtype=np.int64)
        probes.append(
            ("inter_band", CommPattern.from_block_partition(needs, offsets))
        )
        # injection: every proc of region 0 sends its whole block to its
        # counterpart in region 1 -> region-0 summed egress binds the cap
        needs = empty_needs()
        for lr in range(ppr):
            needs[far + lr] = lr * n_per + np.arange(n_per, dtype=np.int64)
        probes.append(
            ("injection", CommPattern.from_block_partition(needs, offsets))
        )
    return probes


def probe_plans(
    topo: Topology,
    value_bytes: int = 8,
    strategies: Sequence[str] = ("standard",),
    n_per: int = 64,
) -> List[CommPlan]:
    """Built plans over :func:`rate_probe_patterns` (fit input helper)."""
    out = []
    for _label, pattern in rate_probe_patterns(topo, n_per=n_per):
        for strat in strategies:
            out.append(build_plan(pattern, topo, strat,
                                  value_bytes=value_bytes))
    return out


def selection_flips(
    labeled_patterns: Sequence[Tuple[str, CommPattern]],
    topo: Topology,
    shipped: MachineParams,
    fitted: MachineParams,
    value_bytes: int = 8,
    candidates: Optional[Sequence[str]] = None,
) -> List[Dict[str, str]]:
    """Section-5 selection under shipped vs fitted rates, side by side.

    Returns one row per pattern: label, the strategy each parameter set
    selects, and whether the choice flipped: the actionable output of the
    calibrate flow.
    """
    from ..core.selection import select_plan

    kw = {"value_bytes": value_bytes}
    if candidates is not None:
        kw["candidates"] = tuple(candidates)
    rows = []
    for label, pattern in labeled_patterns:
        _p, rep_s = select_plan(pattern, topo, shipped, **kw)
        _p, rep_f = select_plan(pattern, topo, fitted, **kw)
        rows.append({
            "label": label,
            "shipped": rep_s.chosen,
            "fitted": rep_f.chosen,
            "flip": "yes" if rep_s.chosen != rep_f.chosen else "no",
        })
    return rows
