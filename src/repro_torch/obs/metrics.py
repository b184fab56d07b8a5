"""Label-aware metrics registry: counters, gauges, fixed-bucket histograms.

Ported from ``repro.obs.metrics``.  The runtime stack (PlanCache,
ServeEngine) reports into one process-wide :class:`MetricsRegistry` owned
by ``repro_torch.obs.Obs``.
Design constraints, in order:

* **Near-zero overhead when disabled.**  Every mutator checks one shared
  boolean first and returns without allocating.  The enabled flag lives in
  a one-element list shared by reference with every metric, so
  ``Obs.enable()`` flips all of them at once without a registry walk.
* **Deterministic export.**  Snapshots sort by metric name and label
  tuple, so two runs of the same program produce byte-identical JSON.
* **Fixed buckets.**  Histogram bucket edges are chosen at declaration
  time (no dynamic rebinning); bucket ``i`` counts observations with
  ``value <= edges[i]``, the last bucket is the +inf overflow.

Labels are passed as keyword arguments and keyed internally by the sorted
``(key, value)`` tuple, so ``c.inc(ns="collective")`` and a hypothetical
``c.inc(**{"ns": "collective"})`` hit the same series.
"""
from __future__ import annotations

import bisect
import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

# Default histogram edges: wall-clock seconds from 10us to ~100s, roughly
# half-decade steps — wide enough for both a decode step and a cold
# hierarchy build.
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2,
    1e-1, 3e-1, 1.0, 3.0, 10.0, 30.0, 100.0,
)


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing per-label float counter."""

    __slots__ = ("name", "help", "_enabled", "_series")

    def __init__(self, name: str, help: str, enabled_ref: List[bool]):
        self.name = name
        self.help = help
        self._enabled = enabled_ref
        self._series: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not self._enabled[0]:
            return
        key = _label_key(labels)
        self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._series.get(_label_key(labels), 0.0)

    def clear(self) -> None:
        self._series.clear()


class Gauge:
    """Last-write-wins per-label value (queue depth, device count, ...)."""

    __slots__ = ("name", "help", "_enabled", "_series")

    def __init__(self, name: str, help: str, enabled_ref: List[bool]):
        self.name = name
        self.help = help
        self._enabled = enabled_ref
        self._series: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        if not self._enabled[0]:
            return
        self._series[_label_key(labels)] = float(value)

    def value(self, **labels) -> float:
        return self._series.get(_label_key(labels), 0.0)

    def clear(self) -> None:
        self._series.clear()


class _HistSeries:
    __slots__ = ("counts", "sum", "count", "min", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets
        self.sum = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = float("-inf")


class Histogram:
    """Fixed-bucket histogram.  ``edges`` are upper bounds; one implicit
    +inf overflow bucket is appended, so ``len(counts) == len(edges)+1``."""

    __slots__ = ("name", "help", "edges", "_enabled", "_series")

    def __init__(self, name: str, help: str, enabled_ref: List[bool],
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        self.name = name
        self.help = help
        self.edges = tuple(sorted(float(b) for b in buckets))
        if not self.edges:
            raise ValueError(f"histogram {name!r}: need at least one edge")
        self._enabled = enabled_ref
        self._series: Dict[LabelKey, _HistSeries] = {}

    def observe(self, value: float, **labels) -> None:
        if not self._enabled[0]:
            return
        key = _label_key(labels)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _HistSeries(len(self.edges) + 1)
        # bucket i holds value <= edges[i]; bisect_left gives the first
        # edge >= value, i.e. exactly that bucket, and len(edges) (the
        # overflow bucket) when value exceeds every edge.
        s.counts[bisect.bisect_left(self.edges, value)] += 1
        s.sum += value
        s.count += 1
        if value < s.min:
            s.min = value
        if value > s.max:
            s.max = value

    def series(self, **labels) -> Optional[_HistSeries]:
        return self._series.get(_label_key(labels))

    def clear(self) -> None:
        self._series.clear()


class MetricsRegistry:
    """Process-wide named metric store; one per
    :class:`repro_torch.obs.Obs`."""

    def __init__(self, enabled_ref: Optional[List[bool]] = None):
        self._enabled = enabled_ref if enabled_ref is not None else [False]
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    @property
    def enabled(self) -> bool:
        return self._enabled[0]

    # -- declaration (idempotent: re-declaring returns the same object) --

    def counter(self, name: str, help: str = "") -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name, help, self._enabled)
        return c

    def gauge(self, name: str, help: str = "") -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name, help, self._enabled)
        return g

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
                  ) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(
                name, help, self._enabled, buckets=buckets)
        return h

    # -- export --

    def snapshot(self) -> Dict:
        """Deterministic plain-dict view of every series (sorted)."""

        def dump_scalar(metrics) -> Dict:
            out = {}
            for name in sorted(metrics):
                m = metrics[name]
                out[name] = [
                    {"labels": dict(key), "value": m._series[key]}
                    for key in sorted(m._series)
                ]
            return out

        hists = {}
        for name in sorted(self._histograms):
            h = self._histograms[name]
            hists[name] = {
                "edges": list(h.edges),
                "series": [
                    {
                        "labels": dict(key),
                        "counts": list(h._series[key].counts),
                        "sum": h._series[key].sum,
                        "count": h._series[key].count,
                        "min": h._series[key].min,
                        "max": h._series[key].max,
                    }
                    for key in sorted(h._series)
                ],
            }
        return {"counters": dump_scalar(self._counters),
                "gauges": dump_scalar(self._gauges),
                "histograms": hists}

    @staticmethod
    def delta(before: Dict, after: Dict) -> Dict:
        """Counter/histogram-count differences between two snapshots
        (gauges are last-write-wins: the *after* value is reported)."""

        def index(rows: Iterable[Dict]) -> Dict[LabelKey, Dict]:
            return {_label_key(r["labels"]): r for r in rows}

        out: Dict = {"counters": {}, "gauges": dict(after.get("gauges", {})),
                     "histograms": {}}
        for name, rows in after.get("counters", {}).items():
            prev = index(before.get("counters", {}).get(name, []))
            diff = []
            for r in rows:
                base = prev.get(_label_key(r["labels"]), {}).get("value", 0.0)
                d = r["value"] - base
                if d:
                    diff.append({"labels": r["labels"], "value": d})
            if diff:
                out["counters"][name] = diff
        for name, h in after.get("histograms", {}).items():
            prev = index(before.get("histograms", {}).get(name, {})
                         .get("series", []))
            diff = []
            for r in h["series"]:
                base = prev.get(_label_key(r["labels"]))
                d_count = r["count"] - (base["count"] if base else 0)
                if d_count:
                    diff.append({"labels": r["labels"], "count": d_count,
                                 "sum": r["sum"] - (base["sum"] if base
                                                    else 0.0)})
            if diff:
                out["histograms"][name] = {"edges": h["edges"],
                                           "series": diff}
        return out

    def to_json(self, indent: Optional[int] = 1) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def clear(self) -> None:
        for m in (*self._counters.values(), *self._gauges.values(),
                  *self._histograms.values()):
            m.clear()
