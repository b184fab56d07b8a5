"""repro_torch.obs: wall-clock spans over the plan -> exchange -> kernel path.

Off by default: until :meth:`Obs.enable` is called, ``span()`` returns the
shared :data:`~repro_torch.obs.spans.NULL_SPAN`, so instrumented code costs
one attribute read and one branch.  :func:`now` is the package's clock.
"""
from __future__ import annotations

from typing import Optional

from .spans import DEFAULT_RING_SIZE, NULL_SPAN, SpanEvent, SpanRecorder, now

__all__ = ["Obs", "default_obs", "now", "NULL_SPAN", "SpanEvent"]


class Obs:
    """A span ring that records only while enabled."""

    def __init__(self, ring_size: int = DEFAULT_RING_SIZE):
        self.enabled = False
        self.spans = SpanRecorder(ring_size=ring_size)

    def enable(self) -> "Obs":
        self.enabled = True
        return self

    def disable(self) -> "Obs":
        self.enabled = False
        return self

    def span(self, name: str, **attrs):
        """Timed region; the shared NULL_SPAN while disabled."""
        if not self.enabled:
            return NULL_SPAN
        return self.spans.span(name, **attrs)


_DEFAULT: Optional[Obs] = None


def default_obs() -> Obs:
    """The process-wide instance the instrumented modules report to."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Obs()
    return _DEFAULT
