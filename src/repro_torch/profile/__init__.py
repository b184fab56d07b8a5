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
* :mod:`.adapt`: :class:`AdaptivePlanner`, which re-selects the MoE
  dispatch transport when the measured routing histograms drift
  (:class:`ReplanEvent`).
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
from .adapt import AdaptivePlanner, ReplanEvent

__all__ = [
    "ExchangeSample", "HistogramSample", "StepSample", "TraceRecorder",
    "CalibrationResult", "fit_trace", "probe_plans", "rate_probe_patterns",
    "selection_flips", "synthesize_trace", "AdaptivePlanner", "ReplanEvent",
]
