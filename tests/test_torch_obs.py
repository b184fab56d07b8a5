"""The port's ``obs`` (metrics, export, the TraceRecorder bridge) and the
``PlanCache`` counters against ``repro``'s.

* The same sequence of counter, gauge and histogram calls gives equal
  ``snapshot()``, ``delta()`` and ``to_json()`` on both registries, with
  upper-inclusive bucket edges; a disabled registry records nothing.
* ``to_perfetto`` and ``report`` give the same JSON and text for the same
  span events, built with fixed times.
* A closing span with ``plan=`` and ``pure_exchange=True`` reaches an
  attached ``repro_torch.profile.TraceRecorder``; a span without them
  records nothing.
* ``PlanCache.snapshot()`` equals ``repro``'s in keys and counts after the
  same ``collective`` / ``dense_collective`` calls, ``stats()`` keeps its
  layout, and the ``plan_cache/*`` counters count the lookups.
* ``ServeEngine`` counts steps, tokens and request latencies.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import LASSEN as R_LASSEN
from repro.core import PlanCache as RPlanCache
from repro.core import Topology as RTopology
from repro.core.plan import CommPattern as RCommPattern
from repro.obs import SpanEvent as RSpanEvent
from repro.obs.export import report as r_report
from repro.obs.export import to_perfetto as r_to_perfetto
from repro.obs.metrics import MetricsRegistry as RRegistry
from repro_torch.core import LASSEN, PlanCache, Topology, build_plan
from repro_torch.core.plan import CommPattern
from repro_torch.obs import NULL_SPAN, Obs, SpanEvent, default_obs
from repro_torch.obs.export import report, to_perfetto
from repro_torch.obs.metrics import DEFAULT_TIME_BUCKETS, MetricsRegistry
from repro_torch.profile import TraceRecorder


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _drive(reg, rng_seed: int, n: int) -> None:
    """One seeded sequence of metric calls, label sets included."""
    rng = np.random.default_rng(rng_seed)
    c = reg.counter("cache/hits", "hits")
    g = reg.gauge("queue/depth")
    h = reg.histogram("step/seconds")
    e = reg.histogram("sizes", buckets=(4.0, 1.0, 2.0))
    for _ in range(n):
        ns = ["collective", "executor", "dense_plan"][rng.integers(3)]
        c.inc(float(rng.integers(1, 4)), ns=ns)
        g.set(float(rng.normal()), lane=int(rng.integers(2)))
        h.observe(float(10.0 ** rng.uniform(-6, 2)), phase=ns)
        e.observe(float(rng.integers(0, 6)))


def test_metrics_snapshot_delta_and_json_equal_repro():
    mine, ref = MetricsRegistry([True]), RRegistry([True])
    _drive(mine, 0, 40)
    _drive(ref, 0, 40)
    before, r_before = mine.snapshot(), ref.snapshot()
    assert before == r_before
    _drive(mine, 1, 25)
    _drive(ref, 1, 25)
    assert mine.snapshot() == ref.snapshot()
    assert mine.to_json() == ref.to_json()
    d = MetricsRegistry.delta(before, mine.snapshot())
    assert d == RRegistry.delta(r_before, ref.snapshot())
    assert d["counters"]["cache/hits"] and d["histograms"]["step/seconds"]
    assert mine.snapshot()["histograms"]["step/seconds"]["edges"] == list(
        DEFAULT_TIME_BUCKETS)


def test_histogram_buckets_are_upper_inclusive():
    reg = MetricsRegistry([True])
    h = reg.histogram("x", buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 1.0000001, 2.0, 4.0, 4.5):
        h.observe(v)
    s = h.series()
    assert s.counts == [2, 2, 1, 1]        # <=1, <=2, <=4, overflow
    assert (s.count, s.min, s.max) == (6, 0.5, 4.5)
    ref = RRegistry([True]).histogram("x", buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 1.0000001, 2.0, 4.0, 4.5):
        ref.observe(v)
    assert ref.series().counts == s.counts


def test_disabled_metrics_and_spans_record_nothing():
    obs = Obs()
    c = obs.counter("n")
    h = obs.histogram("t")
    c.inc(3.0, ns="a")
    h.observe(1.0)
    obs.event("e")
    assert obs.span("s") is NULL_SPAN
    assert c._series == {} and h._series == {}
    assert obs.snapshot() == {"counters": {"n": []}, "gauges": {},
                              "histograms": {"t": {
                                  "edges": list(DEFAULT_TIME_BUCKETS),
                                  "series": []}}}
    assert obs.spans.events() == []


def _events(cls):
    """The same span, instant and counter events on either package's
    ``SpanEvent``, at fixed times."""
    return [
        cls("amg/solve", 10.0, 10.25, depth=0, tid=7,
            attrs={"levels": 3, "plan": object(), "tags": ("a", 1)}),
        cls("amg/vcycle_iter", 10.01, 10.11, depth=1, tid=7,
            attrs={"iter": 0}),
        cls("amg/vcycle_iter", 10.12, 10.2, depth=1, tid=9,
            attrs={"iter": 1, "error": "ValueError()"}),
        cls("serve/replan", 10.3, 10.3, tid=7, kind="instant",
            attrs={"mode": "a2a"}),
        cls("plan_cache/hits", 10.4, 10.4, tid=7, kind="counter",
            attrs={"value": 5.0}),
    ]


def test_perfetto_and_report_equal_repro():
    snap = {"counters": {"plan_cache/hits": [
        {"labels": {"ns": "collective"}, "value": 4.0},
        {"labels": {}, "value": 1.0}]},
        "gauges": {},
        "histograms": {"serve/request_seconds": {"edges": [1.0], "series": [
            {"labels": {}, "counts": [1, 1], "sum": 2.5, "count": 2,
             "min": 0.5, "max": 2.0}]}}}
    mine, ref = _events(SpanEvent), _events(RSpanEvent)
    got = to_perfetto(mine, process_name="p")
    assert json.dumps(got, sort_keys=True) == json.dumps(
        r_to_perfetto(ref, process_name="p"), sort_keys=True)
    assert [e["ph"] for e in got["traceEvents"]].count("X") == 3
    assert report(mine, snap) == r_report(ref, snap)
    assert report([], {}) == r_report([], {})


def _probe_plan():
    needs = [np.empty(0, dtype=np.int64) for _ in range(8)]
    needs[5] = np.arange(4, dtype=np.int64)
    pattern = CommPattern.from_block_partition(needs, np.arange(9) * 16)
    return build_plan(pattern, Topology(8, 4), "standard")


def test_bridge_records_pure_exchange_spans_only():
    tracer = TraceRecorder()
    obs = Obs().enable(tracer=tracer)
    plan = _probe_plan()
    with obs.span("outer"):
        with obs.span("amg/measure_exchange", level=0) as sp:
            sp.set(plan=plan, pure_exchange=True, seconds=2.5e-4)
        with obs.span("amg/other", plan=plan):          # not pure
            pass
        with obs.span("dense/measure", pure_exchange=True):  # no plan
            pass
    assert len(tracer.samples) == 1
    s = tracer.samples[0]
    assert (s.label, s.seconds, s.pure_exchange) == (
        "amg/measure_exchange", 2.5e-4, True)
    assert s.strategy == "standard" and s.n_procs == 8
    obs.disable()
    assert obs.tracer is None and obs.span("x") is NULL_SPAN
    assert [e.name for e in obs.spans.events()] == [
        "amg/measure_exchange", "amg/other", "dense/measure", "outer"]
    assert "outer" in obs.span_tree() and "  amg/other" in obs.span_tree()


def _patterns(rng):
    """Two seeded block-partition patterns, on both packages."""
    offsets = np.arange(9) * 12
    out = []
    for _ in range(2):
        needs = []
        for q in range(8):
            other = np.setdiff1d(np.arange(96), np.arange(12 * q, 12 * q + 12))
            needs.append(np.sort(rng.choice(other, 5, replace=False)))
        out.append((CommPattern.from_block_partition(needs, offsets),
                    RCommPattern.from_block_partition(needs, offsets)))
    return out


def test_plan_cache_snapshot_equals_repro_and_counts_into_obs():
    obs = default_obs()
    mine, ref = PlanCache(max_entries=2), RPlanCache(max_entries=2)
    pats = _patterns(np.random.default_rng(3))
    counts = np.array([5, 3, 7, 1, 4, 4, 2, 6])
    before = obs.snapshot()
    obs.enable()
    try:
        for strategy in ("auto", "standard", "auto", "full", "partial"):
            for p, rp in pats:
                mine.collective(p, Topology(8, 4), strategy, 8, LASSEN)
                ref.collective(rp, RTopology(8, 4), strategy, 8, R_LASSEN)
        for variant in ("auto", "ring", "auto"):
            mine.dense_collective("allgatherv", counts, Topology(8, 4),
                                  variant, 8, LASSEN)
            ref.dense_collective("allgatherv", counts, RTopology(8, 4),
                                 variant, 8, R_LASSEN)
    finally:
        obs.disable()
    snap, r_snap = mine.snapshot(), ref.snapshot()
    drop = ("init_seconds_spent", "init_seconds_saved")
    assert {k: v for k, v in snap.items() if k not in drop} == {
        k: v for k, v in r_snap.items() if k not in drop}
    assert list(snap) == list(r_snap)
    assert snap["counters"]["evictions"] > 0
    assert mine.counters() == snap["counters"]
    stats = mine.stats()
    assert list(stats) == [
        "hits", "misses", "exec_hits", "exec_misses", "evictions",
        "namespaces", "entries", "max_entries", "init_seconds_spent",
        "init_seconds_saved"]
    assert {k: stats[k] for k in snap["counters"]} == snap["counters"]
    d = obs.delta(before)["counters"]
    by_ns = {name: {r["labels"]["ns"]: r["value"] for r in rows}
             for name, rows in d.items()}
    for ns, c in snap["namespaces"].items():
        assert by_ns["plan_cache/hits"].get(ns, 0.0) == c["hits"]
        assert by_ns["plan_cache/misses"].get(ns, 0.0) == c["misses"]
    assert sum(by_ns["plan_cache/evictions"].values()) == \
        snap["counters"]["evictions"]


def test_serve_engine_counts_steps_tokens_and_requests():
    from repro_torch import configs
    from repro_torch.models import Model
    from repro_torch.serve import Request, ServeEngine

    obs = default_obs()
    model = Model(configs.reduced("mamba2-780m"), device="cpu")
    params = model.init_params(seed=0)
    eng = ServeEngine(model, params, batch_slots=2, max_len=16)
    rng = np.random.default_rng(0)
    for rid, (n, m) in enumerate(((3, 2), (4, 3), (2, 2))):
        eng.submit(Request(rid, rng.integers(0, model.cfg.vocab, n)
                           .astype(np.int32), m))
    before = obs.snapshot()
    obs.enable()
    try:
        done = eng.run_until_drained()
    finally:
        obs.disable()
    d = obs.delta(before)
    steps = sum(r["value"] for r in d["counters"]["serve/steps"])
    tokens = sum(r["value"] for r in d["counters"]["serve/tokens"])
    assert len(done) == 3
    assert tokens == sum(len(r.generated) for r in done) == 7
    assert steps >= 4
    hist = d["histograms"]["serve/request_seconds"]["series"]
    assert hist[0]["count"] == 3 and hist[0]["sum"] > 0.0
