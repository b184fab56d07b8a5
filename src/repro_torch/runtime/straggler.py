"""Straggler detection + mitigation.

Ported from ``repro.runtime.straggler`` line for line (host numpy): every
flag list, EWMA vector and row count is bit-equal to ``repro``'s.

Units and contracts:

* :meth:`StragglerDetector.update` takes per-host step **seconds** (one
  wall-clock step time per host, ``np.ndarray [n_hosts]``) and returns the
  list of host indices that have been flagged slow for
  ``StragglerConfig.patience`` *consecutive* updates.  A host is "slow"
  when its EWMA step time exceeds ``threshold`` x the fleet median EWMA.
  The detector never returns the whole fleet: if every host trips the
  threshold simultaneously (possible only for even fleets with an exact
  half split) the update returns ``[]`` — a uniformly slow fleet is a
  machine-rate problem for ``repro_torch.profile.calibrate``, not an
  eviction.
* :func:`rebalance_shards` takes per-host **weights in step-seconds**
  (typically ``StragglerDetector.times``, the EWMA) and a row total, and
  returns integer per-host row counts summing exactly to ``total_rows``,
  inversely proportional to the weights — a 2x-slower host gets half the
  rows.  Feed the result to ``DistributedHierarchy.repartition(...,
  row_weights=)`` (which calls this internally) to apply the mitigation.

Three mechanisms, composable:

1. **Plan-level balancing** (always on): the locality planner's LPT
   assignment (core.locality.balance_assignments) equalizes per-rank
   inter-region responsibility, removing the structural stragglers the
   paper's load balancing targets.
2. **Step-time outlier detection** (this module): EWMA per-host step times;
   hosts persistently slower than ``threshold`` x the fleet median are
   flagged.  The measured feed comes either from launcher wall clocks or
   from ``repro_torch.profile.TraceRecorder.per_proc_step_seconds``
   (per-partner exchange samples attributed to hosts by their traffic
   share).
3. **Mitigation** (driven by ``runtime.controller.ElasticController``):
   (a) shrink the straggler's row shard via :func:`rebalance_shards` and
   re-fit ``MachineParams`` from the recorded trace so Section-5 transport
   selection reflects the degraded rates; (b) if it persists, evict the
   host and trigger the elastic re-mesh (runtime.elastic) — backup-step
   execution is intentionally NOT used: with synchronous SPMD collectives
   a backup replica cannot overlap a straggling collective participant
   (documented trade-off).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

import numpy as np


@dataclasses.dataclass
class StragglerConfig:
    """Detector knobs.  ``ewma`` is the smoothing factor on step seconds
    (1.0 = trust only the newest sample); ``threshold`` is the slow cutoff
    as a multiple of the fleet median EWMA; ``patience`` is how many
    consecutive flagged updates a host survives before mitigation."""

    ewma: float = 0.3
    threshold: float = 1.5       # x fleet median
    patience: int = 5            # consecutive flagged steps before action


class StragglerDetector:
    """EWMA step-time outlier detector (see module docstring for units).

    ``times`` holds the per-host EWMA step seconds — the weight vector
    :func:`rebalance_shards` consumes at mitigation time.  ``flags`` holds
    consecutive-slow counters; :meth:`reset` clears them (and optionally
    re-seeds the EWMA) after a mitigation so the already-handled episode
    cannot re-trigger on stale state.
    """

    def __init__(self, n_hosts: int,
                 cfg: Optional[StragglerConfig] = None):
        # per-instance config: a shared default instance would alias
        # mutations (e.g. one detector tuning `patience`) across detectors
        self.cfg = cfg if cfg is not None else StragglerConfig()
        self.times = np.zeros(n_hosts)
        self.flags = np.zeros(n_hosts, dtype=int)
        self.initialized = False

    @property
    def n_hosts(self) -> int:
        return len(self.times)

    def update(self, step_times: np.ndarray) -> List[int]:
        """Feed per-host step *seconds*; returns hosts needing mitigation
        (flagged ``patience`` consecutive updates; never the whole fleet).
        """
        step_times = np.asarray(step_times, dtype=float).reshape(-1)
        if len(step_times) != self.n_hosts:
            raise ValueError(
                f"got {len(step_times)} step times for {self.n_hosts} hosts"
            )
        a = self.cfg.ewma
        if not self.initialized:
            self.times = step_times.astype(float).copy()
            self.initialized = True
        else:
            self.times = (1 - a) * self.times + a * step_times
        med = np.median(self.times)
        slow = self.times > self.cfg.threshold * med
        self.flags = np.where(slow, self.flags + 1, 0)
        flagged = [int(h) for h in np.flatnonzero(
            self.flags >= self.cfg.patience
        )]
        if len(flagged) >= self.n_hosts:
            # a "fleet" of stragglers has no one to migrate work to —
            # uniformly degraded rates are a calibration problem instead
            return []
        return flagged

    def reset(self, hosts: Optional[Iterable[int]] = None,
              reseed_times: bool = False) -> None:
        """Clear consecutive-slow counters after a mitigation (hysteresis:
        the handled episode must re-accumulate ``patience`` updates before
        it can trigger again).  ``hosts=None`` clears every host;
        ``reseed_times=True`` also resets the EWMA to the fleet median —
        use it when the mitigation changed the per-host work distribution,
        which invalidates the old step-time estimates."""
        if hosts is None:
            self.flags[:] = 0
        else:
            for h in hosts:
                self.flags[int(h)] = 0
        if reseed_times and self.initialized:
            self.times[:] = np.median(self.times)


def rebalance_shards(
    weights: np.ndarray, total_rows: int
) -> np.ndarray:
    """Per-host row counts inversely proportional to EWMA step seconds.

    ``weights`` are step-time weights in seconds (a slow host gets less
    data); the returned integer counts sum exactly to ``total_rows``, with
    the rounding remainder distributed to the fastest hosts.  A single
    host degenerates to the identity rebalance ``[total_rows]``."""
    weights = np.asarray(weights, dtype=float).reshape(-1)
    speed = 1.0 / np.maximum(weights, 1e-9)
    frac = speed / speed.sum()
    counts = np.floor(frac * total_rows).astype(int)
    # distribute the remainder to the fastest hosts
    rem = total_rows - counts.sum()
    order = np.argsort(-speed)
    for i in range(rem):
        counts[order[i % len(order)]] += 1
    return counts
