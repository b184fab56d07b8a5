"""Low-overhead execution trace recorder: the measurement half of the
measured-vs-modeled feedback loop.

Ported from ``repro.profile.trace``; ``SCHEMA_VERSION`` is the same, so a
trace written by either package loads in the other.  Every Section-5
decision is made by ``core.costmodel`` on given MachineParams while the
measured paths time real exchanges; this module is where the two meet.  A
:class:`TraceRecorder` accumulates :class:`ExchangeSample` s — per-pattern
timing + the pattern's exact per-step/per-process traffic split by locality
class — keyed by the same content fingerprints ``core.cache.PlanCache``
uses, so a trace row is directly attributable to a cached plan.  Traces
export/import as JSON and convert to ``core.costmodel.RateSample`` s for
:func:`repro_torch.profile.calibrate.fit_trace`.

Hook points (all optional, zero overhead when no tracer is passed):

* ``amg.distributed.DistributedHierarchy.measure_exchange_seconds(tracer=)``
  and ``measure_spmv_seconds(tracer=)`` (SpMV wall time includes the
  kernels, so those samples are recorded with ``pure_exchange=False`` and
  excluded from rate fitting by default)
* ``core.dense.measure_dense_seconds(tracer=)``
* the obs span bridge (``repro_torch.obs.Obs.enable(tracer=)``)
* :meth:`TraceRecorder.wrap_executor` for ad-hoc executors.
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.cache import pattern_fingerprint
from ..core.costmodel import RateSample
from ..core.plan import CommPlan, PlanStats, StepStats, Topology, color_rounds
from ..obs import now

SCHEMA_VERSION = 1


def _sync_outputs(out) -> None:
    """Wait for the CUDA device of every tensor in ``out`` (a tensor, or
    tuples, lists and dicts of them); CPU tensors are finished."""
    devices = set()
    stack = [out]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.device.type == "cuda":
                devices.add(v.device)
        elif isinstance(v, (tuple, list)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())
    for d in sorted(devices, key=str):
        torch.cuda.synchronize(d)


@dataclass
class StepSample:
    """Exact per-process traffic of one plan step (see ``plan.StepStats``),
    plus the on-wire round count of its ppermute schedule."""

    name: str
    intra_msgs: List[int]
    inter_msgs: List[int]
    intra_vals: List[int]
    inter_vals: List[int]
    rounds: int = 0

    def to_step_stats(self) -> StepStats:
        return StepStats(
            self.name,
            np.asarray(self.intra_msgs, dtype=np.int64),
            np.asarray(self.inter_msgs, dtype=np.int64),
            np.asarray(self.intra_vals, dtype=np.int64),
            np.asarray(self.inter_vals, dtype=np.int64),
        )


@dataclass
class ExchangeSample:
    """One timed execution of one communication pattern."""

    fingerprint: str           # == cache.pattern_fingerprint of the pattern
    label: str                 # e.g. "amg/L2", "setup/L0/gather_A", "moe/a2a"
    strategy: str
    n_procs: int
    procs_per_region: int
    value_bytes: int
    seconds: float
    pure_exchange: bool = True  # False: timing includes non-wire compute
    steps: List[StepSample] = field(default_factory=list)

    def stats(self) -> PlanStats:
        return PlanStats([s.to_step_stats() for s in self.steps],
                         self.value_bytes)

    def topo(self) -> Topology:
        return Topology(self.n_procs, self.procs_per_region)

    def rate_sample(self) -> RateSample:
        return RateSample(self.stats(), self.topo(), self.seconds,
                          label=self.label)


@dataclass
class HistogramSample:
    """One observed per-expert routing histogram (MoE dispatch feed)."""

    label: str
    counts: List[float]
    step: int = 0


class TraceRecorder:
    """Accumulates exchange timings and routing histograms.

    Recording is append-only and cheap (one dataclass per observation;
    plan traffic arrays are copied once).  ``merged_rate_samples`` is the
    fitting view: one ``RateSample`` per (fingerprint, strategy,
    value_bytes) with the median of its measured seconds, so repeated
    timings of one pattern count as one observation instead of over-
    weighting the fit.
    """

    def __init__(self):
        self.samples: List[ExchangeSample] = []
        self.histograms: List[HistogramSample] = []

    # ------------------------------------------------------------ record
    def record_plan(
        self,
        plan: CommPlan,
        seconds: float,
        label: str = "",
        pure_exchange: bool = True,
        fingerprint: Optional[str] = None,
    ) -> ExchangeSample:
        """Record one timed execution of ``plan`` (the PlanCache identity —
        the pattern's content fingerprint — is derived unless given)."""
        fp = fingerprint if fingerprint is not None \
            else pattern_fingerprint(plan.pattern)
        steps = [
            StepSample(
                name=ss.name,
                intra_msgs=[int(v) for v in ss.intra_msgs],
                inter_msgs=[int(v) for v in ss.inter_msgs],
                intra_vals=[int(v) for v in ss.intra_vals],
                inter_vals=[int(v) for v in ss.inter_vals],
                rounds=len(color_rounds(st.messages)),
            )
            for st, ss in zip(plan.steps, plan.stats.steps)
        ]
        sample = ExchangeSample(
            fingerprint=fp,
            label=label,
            strategy=plan.strategy,
            n_procs=plan.topo.n_procs,
            procs_per_region=plan.topo.procs_per_region,
            value_bytes=plan.stats.value_bytes,
            seconds=float(seconds),
            pure_exchange=pure_exchange,
            steps=steps,
        )
        self.samples.append(sample)
        return sample

    def record_histogram(self, label: str, counts,
                         step: int = 0) -> HistogramSample:
        h = HistogramSample(
            label=label,
            counts=[float(c) for c in np.asarray(counts).reshape(-1)],
            step=int(step),
        )
        self.histograms.append(h)
        return h

    def wrap_executor(
        self, plan: CommPlan, fn: Callable, label: str = ""
    ) -> Callable:
        """Wrap a bound device executor so every call is timed (waiting
        for the device of every tensor it returns) and recorded against
        ``plan``'s pattern as a pure exchange."""

        def timed(*args, **kwargs):
            t0 = now()
            out = fn(*args, **kwargs)
            # tensors AND nested outputs (tuples, lists, dicts): a missed
            # sync would record the enqueue time and skew the fitted rates
            _sync_outputs(out)
            self.record_plan(plan, now() - t0, label=label,
                             pure_exchange=True)
            return out

        return timed

    # ----------------------------------------------------------- views
    def merged_rate_samples(self, pure_only: bool = True) -> List[RateSample]:
        """One RateSample per (fingerprint, strategy, value_bytes), with
        the median measured seconds of that pattern's observations."""
        groups: Dict[tuple, List[ExchangeSample]] = {}
        for s in self.samples:
            if pure_only and not s.pure_exchange:
                continue
            groups.setdefault(
                (s.fingerprint, s.strategy, s.value_bytes, s.pure_exchange),
                [],
            ).append(s)
        out = []
        for members in groups.values():
            secs = float(np.median([m.seconds for m in members]))
            rep = members[0]
            out.append(RateSample(rep.stats(), rep.topo(), secs,
                                  label=rep.label))
        return out

    def per_proc_step_seconds(
        self, n_procs: int, pure_only: bool = True
    ) -> np.ndarray:
        """Per-host step *seconds* attributed from the recorded exchanges —
        the measured feed of a straggler detector.

        Each sample's wall seconds are split across processes by their
        share of the sample's total traffic (values moved, intra + inter,
        summed over plan steps): a host that moved 2x the values of the
        fleet is charged 2x the time.  Samples recorded on a different
        process count are skipped.  Returns ``[n_procs]`` seconds (zeros
        when no matching samples exist) — a *relative* load signal, not a
        literal wall clock: exchanges are synchronous, so true per-host
        time is unobservable from one-sided timings; traffic share is the
        deterministic proxy the detector thresholds against the median.
        """
        out = np.zeros(int(n_procs), dtype=float)
        for s in self.samples:
            if pure_only and not s.pure_exchange:
                continue
            if s.n_procs != n_procs:
                continue
            per = np.zeros(n_procs, dtype=float)
            for st in s.steps:
                per += np.asarray(st.intra_vals, dtype=float)
                per += np.asarray(st.inter_vals, dtype=float)
            tot = per.sum()
            if tot <= 0:
                out += s.seconds / n_procs
            else:
                out += s.seconds * (per / tot)
        return out

    def summary(self) -> Dict[str, int]:
        return {
            "samples": len(self.samples),
            "pure_samples": sum(1 for s in self.samples if s.pure_exchange),
            "patterns": len({s.fingerprint for s in self.samples}),
            "histograms": len(self.histograms),
        }

    # ------------------------------------------------------------- JSON
    def to_json(self) -> Dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "samples": [asdict(s) for s in self.samples],
            "histograms": [asdict(h) for h in self.histograms],
        }

    @classmethod
    def from_json(cls, payload: Dict) -> "TraceRecorder":
        tr = cls()
        for d in payload.get("samples", []):
            steps = [StepSample(**sd) for sd in d.get("steps", [])]
            rest = {k: v for k, v in d.items() if k != "steps"}
            tr.samples.append(ExchangeSample(steps=steps, **rest))
        for d in payload.get("histograms", []):
            tr.histograms.append(HistogramSample(**d))
        return tr

    def save(self, path) -> None:
        """Atomic write (tmp + rename): a process killed mid-save can
        never leave a truncated trace that later fails ``fit_trace``.
        Accepts ``str`` or ``pathlib.Path``."""
        path = os.fspath(path)
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(self.to_json(), f, indent=1)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    @classmethod
    def load(cls, path) -> "TraceRecorder":
        with open(os.fspath(path)) as f:
            return cls.from_json(json.load(f))
