"""The port's ``profile`` (TraceRecorder, the fit, calibration) and cost-model
fit against ``repro``'s.

The same plans (built by each package's ``build_plan`` from the same numpy
patterns) and the same seconds go through both sides:

* ``fit_machine_params`` / ``fit_trace`` give params within a relative
  1e-12 and the same goodness of fit, on synthesized traces (the round
  trip of ``tests/test_profile_calibration.py``) and on seeded noisy ones;
  the probes excite every rate; no sample raises; unexcited rates fall
  back to the reference;
* a trace saved by either package loads in the other with equal
  ``to_json``, ``merged_rate_samples`` and ``per_proc_step_seconds``;
* ``selection_flips`` rows and ``CalibrationResult.table()`` are equal;
* ``init_time`` and ``modeled_fine_exchange_time`` agree.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import LASSEN as R_LASSEN
from repro.core import MachineParams as RParams
from repro.core import Topology as RTopology
from repro.core import build_plan as r_build_plan
from repro.core import costmodel as r_costmodel
from repro.core.plan import CommPattern as RCommPattern
from repro.profile import TraceRecorder as RTraceRecorder
from repro.profile import fit_trace as r_fit_trace
from repro.profile import probe_plans as r_probe_plans
from repro.profile import rate_probe_patterns as r_rate_probe_patterns
from repro.profile import selection_flips as r_selection_flips
from repro.profile import synthesize_trace as r_synthesize_trace
from repro_torch.core import LASSEN, MachineParams, Topology, build_plan, plan_time
from repro_torch.core import costmodel
from repro_torch.core.costmodel import RateSample, fit_machine_params
from repro_torch.core.plan import CommPattern
from repro_torch.profile import (
    CalibrationResult,
    TraceRecorder,
    fit_trace,
    probe_plans,
    rate_probe_patterns,
    selection_flips,
    synthesize_trace,
)

RATE_FIELDS = ("alpha_intra", "beta_intra", "alpha_inter", "beta_inter",
               "region_injection_bw")
TRUTH = dict(alpha_intra=3.0e-7, beta_intra=45.0e9, alpha_inter=4.0e-6,
             beta_inter=7.0e9, region_injection_bw=10.0e9)
TRUE = MachineParams(name="truth", **TRUTH)
R_TRUE = RParams(name="truth", **TRUTH)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, so that parallel test workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same_params(mine, ref, mine_gof, ref_gof):
    """Params within a relative 1e-12, the same goodness of fit."""
    for f in RATE_FIELDS:
        a, b = getattr(ref, f), getattr(mine, f)
        assert abs(b - a) <= 1e-12 * abs(a), (f, a, b)
    assert mine.eager_bytes == ref.eager_bytes
    assert mine_gof.keys() == ref_gof.keys()
    for k in ref_gof:
        assert mine_gof[k] == pytest.approx(ref_gof[k], rel=1e-12, abs=1e-24)


def _same_fit(mine, ref):
    _same_params(mine.params, ref.params, mine.gof, ref.gof)
    assert mine.n_samples == ref.n_samples
    assert mine.converged == ref.converged


@pytest.mark.parametrize("topo,strategies,n_per,from_truth", [
    ((8, 4), ("standard", "full"), 16384, RATE_FIELDS),
    # 256 values a message never reach the injection cap
    ((8, 4), ("standard", "partial", "full"), 256, RATE_FIELDS[:4]),
    # one region: no inter traffic exists
    ((4, 4), ("standard",), 4096, RATE_FIELDS[:2]),
])
def test_round_trip_fit_equals_repro(topo, strategies, n_per, from_truth):
    """Synthesized trace -> fit: the generating params back where the
    probes excite them, the reference's elsewhere, on both sides alike."""
    mine = fit_trace(synthesize_trace(
        probe_plans(Topology(*topo), strategies=strategies, n_per=n_per),
        TRUE), ref=LASSEN)
    ref = r_fit_trace(r_synthesize_trace(
        r_probe_plans(RTopology(*topo), strategies=strategies, n_per=n_per),
        R_TRUE), ref=R_LASSEN)
    _same_fit(mine, ref)
    assert mine.converged and mine.gof["rel_rmse"] < 1e-9
    for f in RATE_FIELDS:
        want = TRUTH[f] if f in from_truth else getattr(LASSEN, f)
        assert abs(getattr(mine.params, f) - want) <= 1e-6 * want, f
    assert mine.table() == ref.table()


def test_probe_patterns_excite_every_rate():
    """Each probe's bottleneck is the rate it is named for."""
    topo = Topology(8, 4)
    probes = dict(rate_probe_patterns(topo, n_per=16384))
    sensitive = {"intra_latency": "alpha_intra", "intra_band": "beta_intra",
                 "inter_latency": "alpha_inter", "inter_band": "beta_inter",
                 "injection": "region_injection_bw"}
    assert set(probes) == set(sensitive)
    for label, pattern in probes.items():
        plan = build_plan(pattern, topo, "standard")
        field = sensitive[label]
        bumped = MachineParams(**{
            **TRUTH, "name": "bumped",
            field: TRUTH[field] * (2.0 if field.startswith("alpha") else 0.5)})
        assert plan_time(plan, bumped) > plan_time(plan, TRUE) * 1.5, label


def test_fit_requires_nonzero_samples():
    with pytest.raises(ValueError):
        fit_machine_params([])
    plan = probe_plans(Topology(8, 4))[0]
    with pytest.raises(ValueError):
        fit_machine_params([RateSample(plan.stats, plan.topo, 0.0)])


def _noisy_traces(seed: int = 0):
    """The same plans on both sides (each package's own ``build_plan``)
    with the same seeded noisy seconds, a repeated pattern and an impure
    sample among them."""
    rng = np.random.default_rng(seed)
    mine, ref = TraceRecorder(), RTraceRecorder()
    for n_per in (64, 4096):
        for (label, p), (_, rp) in zip(
                rate_probe_patterns(Topology(8, 4), n_per=n_per),
                r_rate_probe_patterns(RTopology(8, 4), n_per=n_per)):
            for strategy in ("standard", "partial", "full"):
                plan = build_plan(p, Topology(8, 4), strategy)
                rplan = r_build_plan(rp, RTopology(8, 4), strategy)
                base = plan_time(plan, TRUE)
                for _ in range(2):
                    secs = base * float(rng.lognormal(0.0, 0.3)) + 2e-5
                    pure = bool(rng.random() > 0.1)
                    lbl = f"noisy/{n_per}/{label}/{strategy}"
                    mine.record_plan(plan, secs, label=lbl,
                                     pure_exchange=pure)
                    ref.record_plan(rplan, secs, label=lbl,
                                    pure_exchange=pure)
    mine.record_histogram("moe/observed", [3.0, 1.0, 0.0, 4.0], step=7)
    ref.record_histogram("moe/observed", [3.0, 1.0, 0.0, 4.0], step=7)
    return mine, ref


def test_noisy_fit_equals_repro():
    """Noisy seconds (plateaus, cycling bottlenecks): the same iterate on
    both sides, through ``fit_machine_params`` and ``fit_trace``."""
    mine, ref = _noisy_traces()
    a = fit_trace(mine, name="n", ref=LASSEN)
    b = r_fit_trace(ref, name="n", ref=R_LASSEN)
    _same_fit(a, b)
    assert a.table() == b.table()
    assert a.to_json() == b.to_json()
    p, gof = fit_machine_params(mine.merged_rate_samples(pure_only=False),
                                ref=TRUE)
    rp, rgof = r_costmodel.fit_machine_params(
        ref.merged_rate_samples(pure_only=False), ref=R_TRUE)
    _same_params(p, rp, gof, rgof)


def _check_loaded(loaded, src):
    assert loaded.to_json() == src.to_json()
    assert loaded.summary() == src.summary()
    for pure in (True, False):
        a = loaded.merged_rate_samples(pure_only=pure)
        b = src.merged_rate_samples(pure_only=pure)
        assert [(s.label, s.seconds) for s in a] == [
            (s.label, s.seconds) for s in b]
        for sa, sb in zip(a, b):
            assert sa.stats.value_bytes == sb.stats.value_bytes
            for x, y in zip(sa.stats.steps, sb.stats.steps):
                assert x.name == y.name
                for f in ("intra_msgs", "inter_msgs", "intra_vals",
                          "inter_vals"):
                    np.testing.assert_array_equal(getattr(x, f),
                                                  getattr(y, f))
        np.testing.assert_array_equal(
            loaded.per_proc_step_seconds(8, pure_only=pure),
            src.per_proc_step_seconds(8, pure_only=pure))


def test_traces_cross_load(tmp_path):
    """A trace saved by ``repro`` loads in the port and the reverse; the
    recorded samples are equal field for field (fingerprints, rounds)."""
    mine, ref = _noisy_traces(1)
    assert mine.to_json() == ref.to_json()
    mine.save(tmp_path / "port.json")
    ref.save(tmp_path / "ref.json")
    _check_loaded(TraceRecorder.load(tmp_path / "ref.json"), ref)
    _check_loaded(RTraceRecorder.load(tmp_path / "port.json"), mine)
    _same_fit(fit_trace(TraceRecorder.load(tmp_path / "ref.json")),
              r_fit_trace(ref, name="fitted", ref=R_LASSEN))
    assert not list(tmp_path.glob("*.tmp-*"))     # atomic saves


def _level_patterns(rng, n: int = 4):
    """Seeded halo-like patterns of growing reach, on both packages."""
    out = []
    for k in range(n):
        block = 32 >> k
        offsets = np.arange(9) * block
        needs = []
        for q in range(8):
            reach = [(q + d) % 8 for d in (1, 2, 4 + k % 2)]
            cols = np.concatenate([offsets[r] + rng.choice(
                block, max(1, block // 4), replace=False) for r in reach])
            needs.append(np.sort(cols))
        out.append((f"L{k}", CommPattern.from_block_partition(needs, offsets),
                    RCommPattern.from_block_partition(needs, offsets)))
    return out


def test_selection_flips_and_table_equal_repro():
    pats = _level_patterns(np.random.default_rng(2))
    slow = dict(alpha_intra=4e-5, beta_intra=2e9, alpha_inter=3e-5,
                beta_inter=2e9, region_injection_bw=5e9)
    mine = selection_flips([(lbl, p) for lbl, p, _ in pats], Topology(8, 4),
                           LASSEN, MachineParams(name="slow", **slow))
    ref = r_selection_flips([(lbl, rp) for lbl, _, rp in pats],
                            RTopology(8, 4), R_LASSEN,
                            RParams(name="slow", **slow))
    assert mine == ref and len(mine) == 4
    gof = {"residual": 1e-6, "rel_rmse": 0.25, "r2": 0.9,
           "n_samples": 7.0, "outer_iters": 3.0, "converged": 1.0}
    from repro.profile import CalibrationResult as RCalibrationResult

    a = CalibrationResult(MachineParams(name="slow", **slow), LASSEN, gof, 7)
    b = RCalibrationResult(RParams(name="slow", **slow), R_LASSEN, gof, 7)
    assert a.table() == b.table() and a.to_json() == b.to_json()


def test_wrap_executor_records_a_pure_sample():
    plan = probe_plans(Topology(8, 4))[0]
    tr = TraceRecorder()
    fn = tr.wrap_executor(plan, lambda x: (x * 2, {"y": x}), label="w")
    out = fn(torch.ones(3))
    assert torch.equal(out[0], torch.full((3,), 2.0))
    (s,) = tr.samples
    assert s.label == "w" and s.pure_exchange and s.seconds > 0.0


def test_init_and_fine_exchange_time_equal_repro():
    for (label, p), (_, rp) in zip(
            rate_probe_patterns(Topology(8, 4), n_per=512),
            r_rate_probe_patterns(RTopology(8, 4), n_per=512)):
        for strategy in ("standard", "full"):
            plan = build_plan(p, Topology(8, 4), strategy)
            rplan = r_build_plan(rp, RTopology(8, 4), strategy)
            assert costmodel.init_time(plan, TRUE) == \
                r_costmodel.init_time(rplan, R_TRUE), label
    assert costmodel.modeled_fine_exchange_time(6, 4096) == \
        r_costmodel.modeled_fine_exchange_time(6, 4096, params=R_LASSEN)
    assert costmodel.modeled_fine_exchange_time(6, 4096, 4, TRUE) == \
        r_costmodel.modeled_fine_exchange_time(6, 4096, 4, R_TRUE)
    assert costmodel.THETA_FIELDS == r_costmodel.THETA_FIELDS
