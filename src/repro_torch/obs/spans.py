"""Structured wall-clock spans over a bounded in-memory ring buffer.

A span is one timed region of the plan -> exchange -> kernel path::

    with obs.span("amg/solve", levels=3) as sp:
        ...
        sp.set(iters=it)            # attach attributes mid-flight

Spans nest per-thread (a thread-local stack supplies depth), survive
exceptions (the ``with`` protocol closes them and tags ``error=...``), and
land as :class:`SpanEvent` records in a ``collections.deque(maxlen=...)``
ring, so old events fall off the back.

The disabled fast path returns the module singleton :data:`NULL_SPAN`:
no ``Span`` object, no ring append, no clock read.

The clock is ``time.perf_counter`` re-exported as :func:`now`.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict

now = time.perf_counter

DEFAULT_RING_SIZE = 65536


@dataclass
class SpanEvent:
    """One closed span in the ring."""

    name: str
    t0: float                       # perf_counter seconds
    t1: float
    depth: int = 0
    tid: int = 0
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
    """Ring buffer + per-thread span stacks."""

    def __init__(self, ring_size: int = DEFAULT_RING_SIZE):
        self.ring: Deque[SpanEvent] = deque(maxlen=ring_size)
        self._local = threading.local()
        self.dropped = 0            # ring evictions (ring full)

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def _append(self, ev: SpanEvent) -> None:
        if len(self.ring) == self.ring.maxlen:
            self.dropped += 1
        self.ring.append(ev)

    def _close(self, span: Span, t1: float) -> None:
        ev = SpanEvent(name=span.name, t0=span.t0, t1=t1,
                       depth=span._depth, tid=threading.get_ident(),
                       attrs=span.attrs)
        self._append(ev)

    def events(self) -> list:
        return list(self.ring)

    def clear(self) -> None:
        self.ring.clear()
        self.dropped = 0
