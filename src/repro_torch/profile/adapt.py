"""Adaptive MoE re-planning from measured routing histograms.

Ported from ``repro.profile.adapt``.  The dispatch plan a serve engine runs
was fingerprinted from a synthesized *uniform* routing.  Real decode
traffic drifts (a domain shift concentrates tokens on few experts), and the
transport that was cheapest for uniform routing may no longer be.
:class:`AdaptivePlanner` is the feedback loop: it takes the measured
per-batch expert histograms (``models.moe.moe_layer(...,
return_expert_counts=True)``), detects drift against the histogram the
current plan was planned for, and re-fingerprints and re-selects through
``models.moe.moe_plan_from_histogram`` when the drift crosses a threshold.

Noise handling: observations are summed over a sliding ``window`` of recent
batches and compared as normalized distributions (total-variation
distance) against a reference formed from the ``warmup`` observations
after the last (re-)plan.  One noisy decode batch moves the windowed
distribution by at most its share of the window, while a persistent shift
fills the window and crosses the threshold exactly once; the planner then
re-warms on the drifted regime, so continued drifted traffic does not
re-trigger.  Quantized fingerprints (``models.moe.quantize_histogram``)
make re-planning under an effectively unchanged distribution a plan-cache
hit.

The port carries no machine's figures: ``mode="auto"`` re-selects under
``params``, which the caller names (``serve.engine`` passes the model's
``machine_params``, then the online refit's).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..core.costmodel import MachineParams
from ..models.moe import MoEPlan, moe_plan_from_histogram


@dataclass
class ReplanEvent:
    """One histogram-drift re-selection."""

    step: int                 # observation index that triggered the re-plan
    drift: float              # total-variation distance vs the reference
    old_mode: str
    new_mode: str
    old_fingerprint: str
    new_fingerprint: str

    def __str__(self) -> str:
        flip = "" if self.old_mode == self.new_mode else "  (mode flip)"
        return (f"replan@obs{self.step}: drift={self.drift:.3f} "
                f"mode {self.old_mode} -> {self.new_mode}{flip} "
                f"fp {self.old_fingerprint[:8]} -> "
                f"{self.new_fingerprint[:8]}")


@dataclass
class AdaptivePlanner:
    """Observe measured expert histograms; re-plan on drift.

    ``observe(counts)`` is the single entry point: pass the per-batch
    logical-expert pair counts and get back a :class:`ReplanEvent` when
    that observation pushed the accumulated distribution past
    ``threshold``, else ``None``.  ``plan`` always holds the current
    (possibly re-selected) :class:`MoEPlan`.  ``mode="auto"`` needs
    ``params``.
    """

    cfg: object                       # ArchConfig (n_experts, top_k, ...)
    mesh: object
    tokens_per_lane: int
    plan: MoEPlan
    threshold: float = 0.3            # total-variation trigger
    quantum: int = 64                 # histogram fingerprint resolution
    warmup: int = 2                   # observations forming the reference
    window: int = 8                   # sliding observation window
    mode: str = "auto"                # re-selection policy
    ep_over_pods: bool = True
    cap_factor: float = 1.25
    dedup_factor: Optional[float] = None
    params: Optional[MachineParams] = None
    cache: Optional[object] = None    # PlanCache (default process-wide)
    tracer: Optional[object] = None   # TraceRecorder for histogram logging
    events: List[ReplanEvent] = field(default_factory=list)
    _recent: List[np.ndarray] = field(default_factory=list)  # window
    _ref: Optional[np.ndarray] = None
    _obs: int = 0                     # total observations
    _since: int = 0                   # observations since the last re-plan

    def __post_init__(self):
        if self.mode == "auto" and self.params is None:
            raise ValueError("AdaptivePlanner(mode='auto') needs "
                             "MachineParams: pass params= (e.g. "
                             "core.costmodel.LASSEN)")

    @staticmethod
    def tv_distance(a: np.ndarray, b: np.ndarray) -> float:
        """Total variation between two histograms (normalized first)."""
        a = np.asarray(a, dtype=np.float64).reshape(-1)
        b = np.asarray(b, dtype=np.float64).reshape(-1)
        sa, sb = float(a.sum()), float(b.sum())
        if sa <= 0 or sb <= 0:
            return 0.0
        return 0.5 * float(np.abs(a / sa - b / sb).sum())

    def observe(self, counts) -> Optional[ReplanEvent]:
        c = np.asarray(counts, dtype=np.float64).reshape(-1)
        if len(c) != self.cfg.n_experts:
            raise ValueError(
                f"histogram has {len(c)} bins, expected {self.cfg.n_experts}"
            )
        self._obs += 1
        self._since += 1
        if self.tracer is not None:
            self.tracer.record_histogram("moe/observed", c, step=self._obs)
        self._recent.append(c)
        if len(self._recent) > max(1, self.window):
            self._recent.pop(0)
        acc = np.sum(self._recent, axis=0)
        if self._since <= self.warmup or float(acc.sum()) <= 0:
            # reference = everything seen during (re-)warmup
            self._ref = acc.copy()
            return None
        if self._ref is None:
            self._ref = acc.copy()
            return None
        drift = self.tv_distance(acc, self._ref)
        if drift <= self.threshold:
            return None
        old = self.plan
        # the trigger-moment window straddles the transition; plan for the
        # new regime: the newest `warmup` observations, undiluted by the
        # pre-drift mass
        tail = np.sum(self._recent[-max(1, self.warmup):], axis=0)
        new = moe_plan_from_histogram(
            self.cfg, self.mesh, self.tokens_per_lane, tail,
            mode=self.mode, quantum=self.quantum,
            ep_over_pods=self.ep_over_pods, cap_factor=self.cap_factor,
            dedup_factor=self.dedup_factor, params=self.params,
            cache=self.cache,
        )
        event = ReplanEvent(
            step=self._obs,
            drift=drift,
            old_mode=old.mode,
            new_mode=new.mode,
            old_fingerprint=old.fingerprint,
            new_fingerprint=new.fingerprint,
        )
        self.plan = new
        self.events.append(event)
        # re-warm on the new regime: the window clears and the next
        # `warmup` observations form the next reference
        self._recent.clear()
        self._ref = None
        self._since = 0
        return event

    @property
    def observed(self) -> int:
        return self._obs

    def reference_fractions(self) -> Optional[np.ndarray]:
        if self._ref is None or self._ref.sum() <= 0:
            return None
        return self._ref / self._ref.sum()
