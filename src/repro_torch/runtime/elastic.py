"""Elastic scaling: mesh (re)selection after device loss + state placement.

Ported from ``repro.runtime.elastic``.  :class:`MeshRequirements`,
:func:`choose_mesh_shape` and :class:`HeartbeatMonitor` are pure Python
and equal to ``repro``'s.  The port runs every device of a mesh as a lane
stacked on one card, so :func:`make_mesh_from_devices` returns the lane
:class:`~repro_torch.models.common.Mesh` (axis names and sizes only) and
:func:`reshard_state` is a placement on the model's device.

Units and contracts:

* :meth:`HeartbeatMonitor.beat` records liveness for one host at the
  *current* step; :meth:`HeartbeatMonitor.advance` advances the step
  counter by one and returns the hosts that have now been silent for
  MORE than ``timeout_steps`` consecutive advances (a host that beat on
  step ``s`` is declared dead on the first advance where
  ``step - s > timeout_steps``).  Steps are dimensionless engine/solver
  iterations, not seconds — the caller owns the cadence.
* :func:`choose_mesh_shape` takes a surviving *device count* and returns
  ``(shape, axis_names)`` whose product is exactly that count;
  :func:`make_mesh_from_devices` materializes it as a lane mesh (note the
  order: ``Mesh`` takes ``(axis_names, shape)``).
* :func:`reshard_state` takes a tree (dicts, lists, tuples) of tensors or
  numpy arrays and returns the same tree with every leaf on ``device`` —
  dtypes and shapes are preserved exactly (placement only, never a cast or
  reshape); a tensor already there is returned as it is, not copied.

Recovery protocol:

1. A heartbeat/membership layer (the launcher, or
   ``runtime.controller.ElasticController`` in-process) detects failed
   hosts and reports the surviving device count.
2. ``choose_mesh_shape`` picks the largest valid (pod, data, model)
   factorization that still divides the model's TP requirements —
   preferring to keep 'model' fixed (TP degree is baked into layouts) and
   shrinking 'data' first (pure throughput loss, no re-layout).
3. The persistent collectives are re-planned through the surviving
   ``core.cache.PlanCache`` entries (plans are cheap relative to lost
   work — the paper's init-vs-iteration amortization argument — and a
   grow-back to a previously seen geometry re-plans *nothing*), via
   ``amg.distributed.DistributedHierarchy.repartition`` and
   ``serve.engine.ServeEngine.resize``; solver/model state moves with
   :func:`reshard_state` or the last checkpoint restored into the *new*
   template (``runtime.checkpoint``).

Straggler mitigation lives in ``straggler.py``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models.common import Mesh
from .checkpoint import _rebuild


@dataclasses.dataclass(frozen=True)
class MeshRequirements:
    model_divisors: int            # TP degree must divide this (heads, ...)
    prefer_model: int = 16
    min_model: int = 1


def choose_mesh_shape(
    n_devices: int, req: MeshRequirements, multi_pod_size: int = 256
) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest usable mesh from surviving devices.

    Keeps TP ('model') at the largest power-of-two <= prefer_model that
    divides the model; uses whole pods when n_devices spans several."""
    model = req.prefer_model
    while model > req.min_model and (
        req.model_divisors % model != 0 or n_devices % model != 0
    ):
        model //= 2
    model = max(model, 1)
    rest = n_devices // model
    if rest >= 2 and n_devices > multi_pod_size:
        pods = max(1, n_devices // multi_pod_size)
        while rest % pods != 0:
            pods -= 1
        return (pods, rest // pods, model), ("pod", "data", "model")
    return (rest, model), ("data", "model")


def make_mesh_from_devices(shape: Tuple[int, ...],
                           axes: Tuple[str, ...]) -> Mesh:
    """The lane mesh of ``shape`` over ``axes`` (the lanes are stacked on
    one card, so there is no device list to lay out)."""
    return Mesh(tuple(axes), tuple(int(s) for s in shape))


def reshard_state(state, device=None):
    """Place a tree of tensors or numpy arrays on ``device`` (default
    ``cuda``): placement only, never a cast or a reshape."""
    device = resolve_device(device)

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return _rebuild(x, [put(v) for v in x])
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return x

    return put(state)


class HeartbeatMonitor:
    """Launcher-side liveness bookkeeping (host simulation).

    Real deployment: every host POSTs a heartbeat each step; the
    coordinator declares hosts dead after ``timeout_steps`` silent steps
    and triggers the elastic restart above."""

    def __init__(self, n_hosts: int, timeout_steps: int = 3):
        self.last_seen = {h: 0 for h in range(n_hosts)}
        self.timeout = timeout_steps
        self.step = 0

    def beat(self, host: int):
        self.last_seen[host] = self.step

    def advance(self) -> List[int]:
        """Advance one step; return hosts presumed dead."""
        self.step += 1
        return [
            h for h, s in self.last_seen.items()
            if self.step - s > self.timeout
        ]
