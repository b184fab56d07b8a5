"""Perfetto / Chrome ``trace_event`` export and the ``obs.report()`` table.

Ported from ``repro.obs.export``: the same events give the same JSON and
the same text.

``to_perfetto`` lowers the span ring into the JSON object format both
``ui.perfetto.dev`` and ``chrome://tracing`` load directly:

* closed spans   → complete events (``"ph": "X"``, ``ts``/``dur`` in µs),
* instants       → ``"ph": "i"`` thread-scoped markers,
* counter samples→ ``"ph": "C"`` counter-track points,
* thread names   → ``"ph": "M"`` metadata rows.

Timestamps are ``time.perf_counter`` seconds rebased to the earliest
event so traces start at ``ts=0`` regardless of process uptime.  Span
attributes become the event's ``args`` after :func:`_json_safe`
sanitisation — plan objects and other rich values are stringified, never
serialized structurally (a CommPlan in ``args`` would bloat the trace by
orders of magnitude).

``save_perfetto`` writes atomically (tmp file + ``os.replace``) for the
same reason ``TraceRecorder.save`` does: a serve process killed mid-write
must not leave a truncated JSON behind.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

from .spans import SpanEvent

SCHEMA_VERSION = 1

_JSON_SCALARS = (bool, int, float, str, type(None))


def _json_safe(attrs: Dict) -> Dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, _JSON_SCALARS):
            out[k] = v
        elif isinstance(v, (list, tuple)) and all(
                isinstance(x, _JSON_SCALARS) for x in v):
            out[k] = list(v)
        else:
            out[k] = f"<{type(v).__name__}>"
    return out


def to_perfetto(events: List[SpanEvent],
                process_name: str = "repro_torch", pid: int = 0) -> Dict:
    """Lower ring events to the Chrome trace_event JSON object format."""
    if events:
        t_base = min(e.t0 for e in events)
    else:
        t_base = 0.0
    trace: List[Dict] = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    tids = sorted({e.tid for e in events})
    tid_map = {t: i for i, t in enumerate(tids)}
    for t, i in tid_map.items():
        trace.append({"ph": "M", "name": "thread_name", "pid": pid,
                      "tid": i, "args": {"name": f"thread-{i}"}})
    for e in events:
        ts_us = (e.t0 - t_base) * 1e6
        tid = tid_map.get(e.tid, 0)
        if e.kind == "span":
            trace.append({
                "ph": "X", "name": e.name, "cat": e.name.split("/", 1)[0],
                "pid": pid, "tid": tid, "ts": ts_us,
                "dur": (e.t1 - e.t0) * 1e6, "args": _json_safe(e.attrs),
            })
        elif e.kind == "instant":
            trace.append({
                "ph": "i", "name": e.name, "cat": e.name.split("/", 1)[0],
                "pid": pid, "tid": tid, "ts": ts_us, "s": "t",
                "args": _json_safe(e.attrs),
            })
        elif e.kind == "counter":
            trace.append({
                "ph": "C", "name": e.name, "pid": pid, "tid": tid,
                "ts": ts_us,
                "args": {"value": float(e.attrs.get("value", 0.0))},
            })
    return {"traceEvents": trace, "displayTimeUnit": "ms",
            "otherData": {"schema_version": SCHEMA_VERSION}}


def save_perfetto(events: List[SpanEvent], path,
                  process_name: str = "repro_torch") -> None:
    """Atomic write of :func:`to_perfetto` output (tmp + rename)."""
    path = os.fspath(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(to_perfetto(events, process_name=process_name), f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def report(events: List[SpanEvent], metrics_snapshot: Dict) -> str:
    """Human-readable summary: per-span-name timing rollup, then
    counters, then histogram quantile-ish lines (count/mean/max)."""
    rows: Dict[str, List[float]] = {}
    for e in events:
        if e.kind == "span":
            rows.setdefault(e.name, []).append(e.duration)
    lines = [f"{'span':<40s} {'count':>6s} {'total_ms':>10s} "
             f"{'mean_ms':>9s} {'max_ms':>9s}"]
    for name in sorted(rows):
        ds = rows[name]
        lines.append(
            f"{name:<40s} {len(ds):>6d} {sum(ds) * 1e3:>10.3f} "
            f"{sum(ds) / len(ds) * 1e3:>9.3f} {max(ds) * 1e3:>9.3f}"
        )
    if not rows:
        lines.append("(no spans recorded)")

    counters = metrics_snapshot.get("counters", {})
    if any(counters.values()):
        lines.append("")
        lines.append(f"{'counter':<52s} {'value':>12s}")
        for name in sorted(counters):
            for row in counters[name]:
                lbl = ",".join(f"{k}={v}" for k, v in
                               sorted(row["labels"].items()))
                full = f"{name}{{{lbl}}}" if lbl else name
                lines.append(f"{full:<52s} {row['value']:>12g}")

    hists = metrics_snapshot.get("histograms", {})
    if any(h["series"] for h in hists.values()):
        lines.append("")
        lines.append(f"{'histogram':<52s} {'count':>6s} {'mean':>10s} "
                     f"{'max':>10s}")
        for name in sorted(hists):
            for row in hists[name]["series"]:
                lbl = ",".join(f"{k}={v}" for k, v in
                               sorted(row["labels"].items()))
                full = f"{name}{{{lbl}}}" if lbl else name
                mean = row["sum"] / row["count"] if row["count"] else 0.0
                lines.append(f"{full:<52s} {row['count']:>6d} "
                             f"{mean:>10.4g} {row['max']:>10.4g}")
    return "\n".join(lines)
