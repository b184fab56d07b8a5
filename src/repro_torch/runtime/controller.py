"""Elastic/straggler control loop — wires ``runtime`` into the planners.

Ported from ``repro.runtime.controller``: one object owning the
:class:`~repro_torch.runtime.elastic.HeartbeatMonitor`, the
:class:`~repro_torch.runtime.straggler.StragglerDetector`, the (shared)
``core.cache.PlanCache`` and an optional ``repro_torch.profile.TraceRecorder``,
so device-set changes and persistent stragglers turn into *re-planning*
instead of cold restarts:

* **Device-set change** (heartbeat timeout, or an explicit resize
  request): the surviving count goes through
  ``elastic.choose_mesh_shape`` / ``make_mesh_from_devices``; the caller
  rebuilds via ``DistributedHierarchy.repartition`` or
  ``ServeEngine.resize``, both of which re-plan every pattern through the
  shared plan cache — warm-starting from surviving entries, so growing
  back to a previously seen geometry re-plans nothing.  Each rebuild is
  recorded as a :class:`ResizeEvent` carrying the re-plan wall time and
  the plan-cache miss/hit delta (cold vs warm is *observable*).
* **Straggler**: per-host step seconds (launcher wall clocks, or
  ``TraceRecorder.per_proc_step_seconds``) feed :meth:`observe_step_times`.
  When the detector flags a host for ``patience`` consecutive steps,
  :meth:`mitigate_hierarchy` applies ``straggler.rebalance_shards`` to the
  row-block partition and re-fits ``MachineParams`` from the trace
  (``profile.calibrate.fit_trace``, referenced to the hierarchy's own
  params) so Section-5 transport selection reflects the degraded rates —
  one :class:`RebalanceEvent`, then detector reset + cooldown so a handled
  episode cannot storm.

Units: step times are **seconds per host per step**; heartbeat steps and
cooldown are dimensionless observation counts.  The obs instant events
``runtime/resize`` and ``runtime/rebalance`` mark each rebuild and
mitigation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..obs import default_obs
from .elastic import HeartbeatMonitor, MeshRequirements, choose_mesh_shape
from .straggler import StragglerConfig, StragglerDetector

_OBS = default_obs()


@dataclasses.dataclass
class ResizeEvent:
    """One device-set change, with its re-planning cost made observable."""

    reason: str                # "heartbeat" | "requested" | "rebalance"
    old_n: int                 # procs/devices before
    new_n: int                 # procs/devices after
    replan_seconds: float      # wall time of the rebuild (plans + binds)
    plan_misses: int           # plans built fresh during the rebuild
    plan_hits: int             # plans warm-started from the cache
    exec_misses: int = 0       # executors bound fresh
    exec_hits: int = 0         # executors reused

    @property
    def warm(self) -> bool:
        """True when the rebuild re-planned nothing (pure cache warm
        start — the grow-back-to-seen-geometry contract)."""
        return self.plan_misses == 0

    def __str__(self) -> str:
        w = "warm" if self.warm else "cold"
        return (f"resize[{self.reason}] {self.old_n}->{self.new_n} procs: "
                f"{w}, {self.replan_seconds * 1e3:.1f}ms, "
                f"plan misses={self.plan_misses} hits={self.plan_hits}, "
                f"exec misses={self.exec_misses} hits={self.exec_hits}")


@dataclasses.dataclass
class RebalanceEvent:
    """One straggler mitigation: row-block rebalance (+ optional refit)."""

    hosts: List[int]           # flagged hosts
    step: int                  # observation index that triggered it
    weights: np.ndarray        # EWMA step seconds fed to rebalance_shards
    refit: bool                # MachineParams were re-fitted from the trace
    params_name: str = ""      # fitted params name ("" when refit=False)
    rel_rmse: float = float("nan")   # fit goodness (nan when refit=False)
    resize: Optional[ResizeEvent] = None  # the rebuild this triggered

    def __str__(self) -> str:
        fit = (f", refit params='{self.params_name}' "
               f"rel_rmse={self.rel_rmse:.3f}" if self.refit else "")
        return (f"rebalance@obs{self.step}: hosts={self.hosts} "
                f"weights={np.round(self.weights, 4).tolist()}{fit}")


@dataclasses.dataclass
class RefitEvent:
    """One online re-calibration: ``MachineParams`` re-fitted from
    pure-exchange samples of production steps (``ServeEngine(observe=True)``
    every ``refit_every`` decode steps), next to the rebalance-triggered
    refits above."""

    step: int                  # decode step / observation that triggered it
    params_name: str           # name of the fitted MachineParams
    rel_rmse: float            # fit goodness
    n_samples: int             # merged rate samples that entered the fit

    def __str__(self) -> str:
        return (f"refit@step{self.step}: params='{self.params_name}' "
                f"rel_rmse={self.rel_rmse:.3f} n={self.n_samples}")


class ElasticController:
    """Liveness + straggler bookkeeping, feeding the re-planning stack.

    The controller never touches devices itself: it decides *when* to act
    and *what geometry/weights* to act with; the rebuilds are carried out
    by ``DistributedHierarchy.repartition`` / ``ServeEngine.resize``,
    which share its plan cache and report back their :class:`ResizeEvent`.
    """

    def __init__(
        self,
        n_hosts: int,
        cache=None,
        tracer=None,
        timeout_steps: int = 3,
        straggler_cfg: Optional[StragglerConfig] = None,
        cooldown: int = 8,
    ):
        self.cache = cache
        self.tracer = tracer
        self.monitor = HeartbeatMonitor(n_hosts, timeout_steps)
        self.detector = StragglerDetector(n_hosts, straggler_cfg)
        self.cooldown = int(cooldown)
        self._cooldown_left = 0
        self._obs = 0
        self.resize_events: List[ResizeEvent] = []
        self.rebalance_events: List[RebalanceEvent] = []

    # ------------------------------------------------------------ liveness
    def beat(self, host: int) -> None:
        """Record a heartbeat from ``host`` at the current step."""
        self.monitor.beat(host)

    def advance(self) -> List[int]:
        """Advance one heartbeat step; returns hosts presumed dead (silent
        for more than ``timeout_steps`` consecutive advances)."""
        return self.monitor.advance()

    # ----------------------------------------------------------- straggler
    def observe_step_times(self, step_times) -> List[int]:
        """Feed per-host step *seconds*; returns hosts due for mitigation.

        Empty during the post-mitigation cooldown window (hysteresis: a
        freshly rebalanced fleet gets ``cooldown`` observations to settle
        before the detector may trigger again)."""
        self._obs += 1
        flagged = self.detector.update(np.asarray(step_times, dtype=float))
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            return []
        return flagged

    def mitigate_hierarchy(
        self,
        dh,
        hosts: List[int],
        refit: bool = True,
        refit_ref=None,
    ) -> Tuple[object, RebalanceEvent]:
        """Apply the straggler mitigation to a ``DistributedHierarchy``.

        Rebalances every level's row blocks inversely to the detector's
        EWMA step seconds (``straggler.rebalance_shards``) and — when a
        tracer with pure exchange samples is attached — re-fits
        ``MachineParams`` from the recorded per-partner rates (referenced
        to ``refit_ref``, default the hierarchy's own params) so the
        rebuilt hierarchy's Section-5 selection runs under the *measured*
        (degraded) rates.  Returns ``(new_hierarchy, event)``; the
        detector is reset and a cooldown started, so one slow episode
        yields exactly one event."""
        weights = self.detector.times.copy()
        fitted = None
        name = ""
        rel_rmse = float("nan")
        if refit and self.tracer is not None:
            try:
                from ..profile.calibrate import fit_trace

                result = fit_trace(self.tracer, name="straggler-refit",
                                   ref=refit_ref if refit_ref is not None
                                   else dh.params)
                fitted = result.params
                name = fitted.name
                rel_rmse = result.gof.get("rel_rmse", float("nan"))
            except ValueError:
                fitted = None   # no pure samples recorded yet: skip refit
        new_dh = dh.repartition(row_weights=weights, params=fitted,
                                reason="rebalance")
        event = RebalanceEvent(
            hosts=[int(h) for h in hosts],
            step=self._obs,
            weights=weights,
            refit=fitted is not None,
            params_name=name,
            rel_rmse=rel_rmse,
            resize=new_dh.last_resize,
        )
        self.rebalance_events.append(event)
        _OBS.event("runtime/rebalance", step=event.step,
                   hosts=[int(h) for h in hosts], refit=event.refit,
                   params_name=name)
        if new_dh.last_resize is not None:
            self.resize_events.append(new_dh.last_resize)
        # hysteresis: the rebalance changed the work distribution, so the
        # old EWMA is stale — reseed it and make the episode re-accumulate
        self.detector.reset(reseed_times=True)
        self._cooldown_left = self.cooldown
        return new_dh, event

    # -------------------------------------------------------------- resize
    def plan_mesh(
        self,
        n_devices: int,
        req: MeshRequirements,
        multi_pod_size: int = 256,
    ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
        """Mesh factorization for a surviving device count (thin wrapper
        over ``elastic.choose_mesh_shape`` so callers go through one
        controller surface)."""
        return choose_mesh_shape(n_devices, req, multi_pod_size)

    def note_resize(self, event: ResizeEvent) -> None:
        """Record a rebuild performed by a planner on our behalf."""
        self.resize_events.append(event)

    # ------------------------------------------------------------- summary
    def summary(self) -> Dict[str, int]:
        return {
            "observations": self._obs,
            "resize_events": len(self.resize_events),
            "rebalance_events": len(self.rebalance_events),
            "cooldown_left": self._cooldown_left,
        }


def cache_delta_event(
    cache, before: Dict[str, int], reason: str,
    old_n: int, new_n: int, seconds: float,
) -> ResizeEvent:
    """Build a :class:`ResizeEvent` from a plan-cache counter snapshot
    (``PlanCache.counters()``) taken before the rebuild.  The one choke
    point every resize flows through, so it also emits the
    ``runtime/resize`` obs instant event."""
    after = cache.counters()
    event = ResizeEvent(
        reason=reason,
        old_n=int(old_n),
        new_n=int(new_n),
        replan_seconds=float(seconds),
        plan_misses=after["misses"] - before["misses"],
        plan_hits=after["hits"] - before["hits"],
        exec_misses=after["exec_misses"] - before["exec_misses"],
        exec_hits=after["exec_hits"] - before["exec_hits"],
    )
    _OBS.event("runtime/resize", reason=event.reason, old_n=event.old_n,
               new_n=event.new_n, warm=event.warm,
               plan_misses=event.plan_misses, plan_hits=event.plan_hits)
    return event
