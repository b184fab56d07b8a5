"""Persistent neighborhood collective facade (the MPI_Neighbor_alltoallv_init
analogue).

    coll = NeighborAlltoallV.init(pattern, topo, strategy="auto")
    ghosts = coll(x)            # start+wait, host (numpy) path
    exec_fn = coll.bind("cuda")
    ghosts = exec_fn(x_stacked)  # device path, ranks stacked on one device

``init`` is the expensive once-per-pattern step (plan construction, load
balancing, dedup); calls are the cheap per-iteration start/wait.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..obs import now as _now
from .collectives import DevicePlan, build_device_plan, make_executor
from .costmodel import LASSEN, MachineParams, plan_time
from .locality import build_plan
from .plan import CommPattern, CommPlan, Topology
from .selection import SelectionReport, select_plan


@dataclass
class NeighborAlltoallV:
    plan: CommPlan
    device_plan: DevicePlan
    init_seconds: float
    selection: Optional[SelectionReport] = None

    @classmethod
    def init(
        cls,
        pattern: CommPattern,
        topo: Topology,
        strategy: str = "auto",
        value_bytes: int = 8,
        params: MachineParams = LASSEN,
    ) -> "NeighborAlltoallV":
        t0 = _now()
        report = None
        if strategy == "auto":
            plan, report = select_plan(
                pattern, topo, params=params, value_bytes=value_bytes
            )
        else:
            plan = build_plan(pattern, topo, strategy, value_bytes=value_bytes)
        dplan = build_device_plan(plan)
        return cls(plan, dplan, _now() - t0, report)

    # host-side start/wait (oracle + small-scale use)
    def __call__(self, local_vals: Sequence[np.ndarray]) -> List[np.ndarray]:
        return self.plan.execute_numpy(local_vals)

    # device-side start/wait
    def bind(self, device) -> Callable:
        """The rank-stacked executor with its index arrays on ``device``."""
        return make_executor(self.device_plan, device)

    def modeled_time(self, params: MachineParams = LASSEN) -> float:
        return plan_time(self.plan, params)

    @property
    def strategy(self) -> str:
        return self.plan.strategy
