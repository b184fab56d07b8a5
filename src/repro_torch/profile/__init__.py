"""Measured-rate profiling and cost-model calibration.

Ported from ``repro.profile``: the feedback loop from execution back into
planning (MPI Advance's thesis that portable communication optimization
must *observe* the actual machine, arXiv 2309.07337):

* :mod:`.trace`: :class:`TraceRecorder`, per-pattern timing/bytes/round
  samples keyed by the same fingerprints ``core.cache.PlanCache`` uses,
  with JSON export/import that ``repro``'s recorder reads too.
* :mod:`.calibrate`: :func:`fit_trace`, the least-squares fit of
  ``MachineParams`` from a trace (the numeric core lives in
  ``core.costmodel.fit_machine_params``), goodness-of-fit reporting,
  round-trip synthesis, and shipped-vs-fitted selection comparison.

``repro``'s adaptive re-planner (``AdaptivePlanner``, ``ReplanEvent`` in
``repro.profile.adapt``) is not ported yet: it needs the adaptive MoE
pieces (``quantize_histogram``, ``moe_plan_from_histogram``) in
``models.moe`` first.
"""
from .trace import ExchangeSample, HistogramSample, StepSample, TraceRecorder
from .calibrate import (
    CalibrationResult,
    fit_trace,
    probe_plans,
    rate_probe_patterns,
    selection_flips,
    synthesize_trace,
)

__all__ = [
    "ExchangeSample", "HistogramSample", "StepSample", "TraceRecorder",
    "CalibrationResult", "fit_trace", "probe_plans", "rate_probe_patterns",
    "selection_flips", "synthesize_trace",
]
