"""Dynamic strategy selection (paper Section 5, future work — implemented).

The paper notes locality-aware aggregation *hurts* on communication-light
patterns (fine AMG levels) and that "a simple performance measure is needed
within the neighborhood collective to dynamically select the optimal
communication strategy".  This module is that selector: build candidate
plans, score them with the locality-aware max-rate model, pick the cheapest.

``select_plan`` is what ``NeighborAlltoallV.init(strategy="auto")`` calls.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..obs import now as _now
from .costmodel import LASSEN, MachineParams, plan_time
from .locality import STRATEGIES, build_plan
from .plan import CommPattern, CommPlan, Topology


@dataclass
class SelectionReport:
    chosen: str
    modeled_times: Dict[str, float]
    planning_seconds: Dict[str, float]

    def __str__(self) -> str:
        rows = ", ".join(
            f"{k}={v * 1e6:.1f}us" for k, v in sorted(self.modeled_times.items())
        )
        return f"selected={self.chosen} ({rows})"


def select_plan(
    pattern: CommPattern,
    topo: Topology,
    params: MachineParams = LASSEN,
    value_bytes: int = 8,
    candidates: Sequence[str] = STRATEGIES,
    amortization_iters: Optional[int] = None,
) -> Tuple[CommPlan, SelectionReport]:
    """Pick the cheapest strategy under the cost model.

    If ``amortization_iters`` is given, planning wall time is amortized over
    that many iterations and added to the per-iteration score — this encodes
    the paper's crossover analysis (Fig 7): aggregation only pays off past
    its crossover iteration count.
    """
    plans: Dict[str, CommPlan] = {}
    times: Dict[str, float] = {}
    walls: Dict[str, float] = {}
    for strat in candidates:
        t0 = _now()
        plan = build_plan(pattern, topo, strat, value_bytes=value_bytes)
        walls[strat] = _now() - t0
        score = plan_time(plan, params)
        if amortization_iters:
            score += walls[strat] / amortization_iters
        plans[strat] = plan
        times[strat] = score
    chosen = min(times, key=lambda k: times[k])
    return plans[chosen], SelectionReport(chosen, times, walls)


def per_pattern_best(
    patterns: Sequence[CommPattern],
    topo: Topology,
    params: MachineParams = LASSEN,
    value_bytes: int = 8,
) -> List[Tuple[CommPlan, SelectionReport]]:
    """Paper's scaling-study methodology: per level, take the cheapest of
    standard vs each optimized collective ("summing up the least expensive
    of standard communication and the given optimized neighbor collective")."""
    return [
        select_plan(p, topo, params, value_bytes=value_bytes) for p in patterns
    ]
