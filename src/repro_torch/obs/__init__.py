"""repro_torch.obs: metrics and span telemetry for plan -> exchange ->
kernel -> serve.

Ported from ``repro.obs``.  One process-wide :class:`Obs` instance
(``default_obs()``) owns a :class:`~repro_torch.obs.metrics.MetricsRegistry`
and a :class:`~repro_torch.obs.spans.SpanRecorder`.  Everything is **off by
default**: until ``enable()`` is called, ``span()`` returns the shared
:data:`~repro_torch.obs.spans.NULL_SPAN` and every counter mutator
early-outs on one boolean, so instrumented hot paths (decode steps, cache
lookups) cost one attribute read and one branch.

Usage::

    from repro_torch.obs import default_obs

    obs = default_obs()
    obs.enable()
    ...  # run instrumented code: solves, decode steps
    print(obs.report())                  # rollup table
    obs.export_perfetto("trace.json")    # load in ui.perfetto.dev

**TraceRecorder bridge** (the online-calibration pipe): attach a
``repro_torch.profile.TraceRecorder`` via ``enable(tracer=...)`` and every
closing span whose attributes carry ``plan=<CommPlan>`` and
``pure_exchange=True`` is forwarded to ``tracer.record_plan``: the same
samples ``fit_trace`` consumes.

:func:`now` (``time.perf_counter``) is the package's one clock.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .export import report as _report
from .export import save_perfetto, to_perfetto
from .metrics import (  # noqa: F401  (re-exported API)
    Counter,
    DEFAULT_TIME_BUCKETS,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from .spans import (  # noqa: F401
    DEFAULT_RING_SIZE,
    NULL_SPAN,
    Span,
    SpanEvent,
    SpanRecorder,
    now,
)

__all__ = [
    "Obs", "default_obs", "now", "NULL_SPAN", "SpanEvent",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "DEFAULT_TIME_BUCKETS", "DEFAULT_RING_SIZE",
]


class Obs:
    """Metrics registry + span ring + optional TraceRecorder bridge."""

    def __init__(self, ring_size: int = DEFAULT_RING_SIZE):
        self._enabled_ref: List[bool] = [False]
        self.metrics = MetricsRegistry(self._enabled_ref)
        self.spans = SpanRecorder(ring_size=ring_size)
        self.spans.on_close = self._on_span_close
        self._tracer = None     # Optional[repro_torch.profile.TraceRecorder]

    # ------------------------------------------------------------ state
    @property
    def enabled(self) -> bool:
        return self._enabled_ref[0]

    @property
    def tracer(self):
        """The attached TraceRecorder, or None (always None when
        disabled: callers may use this to gate bridge-only work)."""
        return self._tracer if self.enabled else None

    def enable(self, tracer=None, ring_size: Optional[int] = None) -> "Obs":
        if ring_size is not None and ring_size != self.spans.ring.maxlen:
            self.spans = SpanRecorder(ring_size=ring_size)
            self.spans.on_close = self._on_span_close
        if tracer is not None:
            self._tracer = tracer
        self._enabled_ref[0] = True
        return self

    def disable(self) -> "Obs":
        self._enabled_ref[0] = False
        return self

    def attach_tracer(self, tracer) -> "Obs":
        self._tracer = tracer
        return self

    def reset(self) -> "Obs":
        """Drop all recorded data (registry declarations survive)."""
        self.metrics.clear()
        self.spans.clear()
        return self

    # ------------------------------------------------------- recording
    def span(self, name: str, **attrs):
        """Open a span; ``with obs.span("amg/solve", levels=3): ...``.
        Disabled fast path: returns the shared NULL_SPAN singleton."""
        if not self._enabled_ref[0]:
            return NULL_SPAN
        return self.spans.span(name, **attrs)

    def event(self, name: str, **attrs) -> None:
        """Record an instant event (replan, resize, refit, ...)."""
        if self._enabled_ref[0]:
            self.spans.event(name, **attrs)

    def counter(self, name: str, help: str = "") -> Counter:
        return self.metrics.counter(name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self.metrics.gauge(name, help)

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:
        return self.metrics.histogram(name, help, **kw)

    # --------------------------------------------------------- bridge
    def _on_span_close(self, ev: SpanEvent) -> None:
        # pure-exchange spans feed the calibration trace: the samples
        # fit_trace consumes, so instrumented runs calibrate like probes
        if self._tracer is not None and ev.attrs.get("pure_exchange"):
            plan = ev.attrs.get("plan")
            if plan is not None:
                self._tracer.record_plan(
                    plan,
                    float(ev.attrs.get("seconds", ev.duration)),
                    label=ev.name,
                    pure_exchange=True,
                    fingerprint=ev.attrs.get("fingerprint"),
                )
        # top-level span close = natural counter-track sample point
        if ev.depth == 0:
            for name, c in sorted(self.metrics._counters.items()):
                if c._series:
                    self.spans.counter_sample(name, sum(c._series.values()))

    # --------------------------------------------------------- export
    def snapshot(self) -> Dict:
        return self.metrics.snapshot()

    def delta(self, before: Dict) -> Dict:
        return MetricsRegistry.delta(before, self.metrics.snapshot())

    def report(self) -> str:
        return _report(self.spans.events(), self.metrics.snapshot())

    def span_tree(self) -> str:
        return self.spans.tree()

    def to_perfetto(self, process_name: str = "repro_torch") -> Dict:
        return to_perfetto(self.spans.events(), process_name=process_name)

    def export_perfetto(self, path, process_name: str = "repro_torch") -> None:
        save_perfetto(self.spans.events(), path, process_name=process_name)


_DEFAULT: Obs = Obs()


def default_obs() -> Obs:
    """The process-wide instance every instrumented module reports to."""
    return _DEFAULT
