"""Structured wall-clock spans over a bounded in-memory ring buffer.

Ported from ``repro.obs.spans``.  A span is one timed region of the
plan → exchange → kernel → serve path::

    with obs.span("amg/solve", levels=3) as sp:
        ...
        sp.set(iters=it)            # attach attributes mid-flight

Spans nest per-thread (a thread-local stack supplies depth and parent
identity), survive exceptions (the ``with`` protocol closes them and tags
``error=...``), and land as :class:`SpanEvent` records in a
``collections.deque(maxlen=...)`` ring — old events fall off the back, a
long-lived serve process never grows without bound.

Two non-span record kinds share the ring so the Perfetto exporter can
interleave them on the same clock:

* ``instant`` — a point event (``obs.event("serve/replan", ...)``);
* ``counter`` — a metric sample for Perfetto counter tracks, emitted by
  ``Obs`` when a top-level span closes.

The **disabled fast path** returns the module singleton :data:`NULL_SPAN`
— no ``Span`` object, no ring append, no clock read.  Tests assert the
identity (``obs.span(...) is NULL_SPAN``) so the fast path cannot
silently regress into an allocating one.

The clock is ``time.perf_counter`` re-exported as :func:`now`, the
package's one clock: every timing of ``repro_torch`` reads it.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, Optional

now = time.perf_counter

DEFAULT_RING_SIZE = 65536


@dataclass
class SpanEvent:
    """One closed span (or instant/counter record) in the ring."""

    name: str
    t0: float                       # perf_counter seconds
    t1: float
    depth: int = 0
    tid: int = 0
    kind: str = "span"              # "span" | "instant" | "counter"
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class _NullSpan:
    """Shared no-op stand-in returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Span:
    """An open span; close it via the ``with`` protocol."""

    __slots__ = ("name", "attrs", "t0", "_rec", "_depth", "_closed")

    def __init__(self, recorder: "SpanRecorder", name: str,
                 attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self._rec = recorder
        self._depth = 0
        self._closed = False
        self.t0 = 0.0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        stack = self._rec._stack()
        self._depth = len(stack)
        stack.append(self)
        self.t0 = now()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = now()          # clock first: exclude our own bookkeeping
        if self._closed:    # defensive: double-exit records once
            return False
        self._closed = True
        stack = self._rec._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:         # mis-nested close: drop through to us
            while stack and stack[-1] is not self:
                stack.pop()
            if stack:
                stack.pop()
        if exc is not None:
            self.attrs["error"] = repr(exc)
        self._rec._close(self, t1)
        return False


class SpanRecorder:
    """Ring buffer + per-thread span stacks.

    ``on_close`` (set by ``Obs``) observes every closed *span* event —
    the hook point for the TraceRecorder bridge and counter sampling.
    """

    def __init__(self, ring_size: int = DEFAULT_RING_SIZE):
        self.ring: Deque[SpanEvent] = deque(maxlen=ring_size)
        self._local = threading.local()
        self.on_close = None        # Optional[Callable[[SpanEvent], None]]
        self.dropped = 0            # ring evictions (ring full)

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @property
    def depth(self) -> int:
        return len(self._stack())

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        t = now()
        self._append(SpanEvent(name=name, t0=t, t1=t,
                               depth=len(self._stack()),
                               tid=threading.get_ident(),
                               kind="instant", attrs=attrs))

    def counter_sample(self, name: str, value: float) -> None:
        t = now()
        self._append(SpanEvent(name=name, t0=t, t1=t, kind="counter",
                               tid=threading.get_ident(),
                               attrs={"value": float(value)}))

    def _append(self, ev: SpanEvent) -> None:
        if len(self.ring) == self.ring.maxlen:
            self.dropped += 1
        self.ring.append(ev)

    def _close(self, span: Span, t1: float) -> None:
        ev = SpanEvent(name=span.name, t0=span.t0, t1=t1,
                       depth=span._depth, tid=threading.get_ident(),
                       kind="span", attrs=span.attrs)
        self._append(ev)
        if self.on_close is not None:
            self.on_close(ev)

    def events(self, kind: Optional[str] = None) -> list:
        evs = list(self.ring)
        if kind is not None:
            evs = [e for e in evs if e.kind == kind]
        return evs

    def clear(self) -> None:
        self.ring.clear()
        self.dropped = 0

    def tree(self) -> str:
        """Indented close-order listing of spans: the quick-look view."""
        lines = []
        for ev in self.ring:
            if ev.kind != "span":
                continue
            lines.append(f"{'  ' * ev.depth}{ev.name} "
                         f"{ev.duration * 1e3:.3f}ms")
        return "\n".join(lines)
