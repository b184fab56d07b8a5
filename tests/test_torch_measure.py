"""The port's measured paths on the CPU (``time_executor``,
``measure_exchange_seconds``, ``measure_spmv_seconds``,
``measure_dense_seconds``) and its ``auto`` selections under given figures.

* ``time_executor`` makes ``1 + warmup + iters`` calls, returns a positive
  finite time, and raises when the executor changes the dtype.
* On a small hierarchy (P=8, 4,096 rows) the measurements return the
  levels, strategies, variants and overlaps ``setup`` recorded, 0.0 for a
  ghostless level; their samples carry the fingerprints and step stats
  ``repro``'s ``TraceRecorder.record_plan`` gives for the same patterns;
  the SpMV samples are impure and stay out of the fit; without a tracer
  the obs bridge records the exchanges.
* ``setup`` with every ``auto`` under a non-``LASSEN`` ``MachineParams``
  and explicit device figures reproduces the host solver's history at
  rtol=1e-8, atol=1e-15, and its strategies equal ``repro``'s
  ``select_plan`` under the same params.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import MachineParams as RParams
from repro.core import Topology as RTopology
from repro.core import build_plan as r_build_plan
from repro.core import select_plan as r_select_plan
from repro.core.dense import build_dense_plan as r_build_dense_plan
from repro.core.plan import CommPattern as RCommPattern
from repro.profile import TraceRecorder as RTraceRecorder
from repro_torch.amg import DistributedHierarchy, build_hierarchy, diffusion_2d
from repro_torch.amg import solve as host_solve
from repro_torch.amg.hierarchy import Hierarchy, Level, estimate_rho
from repro_torch.core import (
    MachineParams,
    PlanCache,
    Topology,
    build_dense_plan,
    measure_dense_seconds,
    time_executor,
)
from repro_torch.obs import default_obs
from repro_torch.profile import TraceRecorder
from repro_torch.sparse.csr import CSR

HIST = dict(rtol=1e-8, atol=1e-15)
SLOW = dict(alpha_intra=4e-5, beta_intra=2e9, alpha_inter=3e-5,
            beta_inter=2e9, region_injection_bw=5e9)
# figures that give both kernel variants and both overlap modes at 4,096
# rows (stand-ins for a device's: the CPU runs the plain versions)
FIGURES = dict(vmem_limit=20000, hbm_bw=2e10, vpu_flops=1e12, launch_s=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def hier():
    return build_hierarchy(diffusion_2d(64, 64))


def _setup(h, **kw):
    return DistributedHierarchy.setup(h, 8, procs_per_region=4,
                                      cache=PlanCache(), device="cpu", **kw)


def _ref_pattern(pattern, offsets):
    return RCommPattern.from_block_partition(
        [np.asarray(n) for n in pattern.needs], np.asarray(offsets))


def _ref_sample(tr, op, secs, label, pure):
    """``repro``'s record of the same pattern under the same strategy."""
    rplan = r_build_plan(_ref_pattern(op.part.pattern, op.part.col_offsets),
                         RTopology(8, 4), op.strategy)
    return tr.record_plan(rplan, secs, label=label, pure_exchange=pure)


def test_time_executor_protocol():
    calls = []

    def fn(x):
        calls.append(x.shape)
        return x[:, :2]

    secs = time_executor(fn, 8, 5, iters=7, warmup=2, device="cpu")
    assert len(calls) == 1 + 2 + 7 and calls[0] == (8, 5, 1)
    assert math.isfinite(secs) and secs > 0.0
    assert time_executor(fn, 8, 0, np.float32, 1, 0, device="cpu") > 0.0
    with pytest.raises(RuntimeError, match="float32"):
        time_executor(lambda x: x.float(), 8, 5, device="cpu")


def test_measurements_match_setup_and_reference_records(hier):
    dh = _setup(hier, strategy="auto", spmv_variant="auto",
                spmv_vmem_limit=FIGURES["vmem_limit"])
    tracer, ref = TraceRecorder(), RTraceRecorder()
    ex = dh.measure_exchange_seconds(iters=2, warmup=1, tracer=tracer)
    sp = dh.measure_spmv_seconds(iters=2, warmup=0, tracer=tracer)
    assert [(k, s) for k, s, _ in ex] == [
        (lv.index, lv.A.strategy) for lv in dh.levels]
    assert [r[:3] for r in sp] == [
        (lv.index, lv.A.kernel_variant, lv.A.overlap_mode)
        for lv in dh.levels]
    assert {r[1] for r in sp} == {"flat", "blocked"}
    assert all(s > 0.0 for *_, s in ex + sp)
    ghosted = [lv for lv in dh.levels if lv.A.ell.ghost_pad]
    assert len(tracer.samples) == 2 * len(ghosted) == 2 * len(dh.levels)
    want = [_ref_sample(ref, lv.A, s.seconds, s.label, s.pure_exchange)
            for lv, s in zip(ghosted + ghosted, tracer.samples)]
    assert [dataclasses.asdict(s) for s in tracer.samples] == [
        dataclasses.asdict(w) for w in want]
    assert [s.pure_exchange for s in tracer.samples] == [True] * len(
        ghosted) + [False] * len(ghosted)
    assert [s.label for s in tracer.samples[len(ghosted):]] == [
        f"amg/L{lv.index}/spmv" for lv in ghosted]
    merged = tracer.merged_rate_samples(pure_only=True)
    assert sorted(s.label for s in merged) == sorted(
        f"amg/L{lv.index}" for lv in ghosted)


def test_exchange_measurement_feeds_the_obs_bridge(hier):
    dh = _setup(hier, strategy="standard")
    obs, tracer = default_obs(), TraceRecorder()
    obs.enable(tracer=tracer)
    try:
        dh.measure_exchange_seconds(iters=1, warmup=0)
    finally:
        obs.disable()
        obs.attach_tracer(None)
    assert [s.label for s in tracer.samples] == [
        "amg/measure_exchange"] * len(dh.levels)
    assert all(s.pure_exchange and s.strategy == "standard"
               for s in tracer.samples)


def test_ghostless_level_reports_zero():
    """Eight uncoupled chains, one a rank: no exchange to time."""
    n, P = 64, 8
    rows = np.concatenate([np.arange(n * P)] * 3)
    cols = np.concatenate([np.arange(n * P), np.arange(n * P) - 1,
                           np.arange(n * P) + 1])
    vals = np.concatenate([np.full(n * P, 2.0), -np.ones(2 * n * P)])
    keep = (cols >= 0) & (cols < n * P) & (rows // n == cols // n)
    A = CSR.from_coo(rows[keep], cols[keep], vals[keep], (n * P, n * P))
    dh = _setup(Hierarchy([Level(A=A, rho=estimate_rho(A))]))
    tracer = TraceRecorder()
    (row,) = dh.measure_exchange_seconds(iters=1, warmup=0, tracer=tracer)
    assert row[0] == 0 and row[2] == 0.0
    (srow,) = dh.measure_spmv_seconds(iters=1, warmup=0, tracer=tracer)
    assert srow[:3] == (0, "flat", "off") and srow[3] > 0.0
    assert tracer.samples == []


@pytest.mark.parametrize("collective", ["allreduce", "allgatherv",
                                        "reduce_scatter"])
def test_measure_dense_records_the_dense_plan(collective):
    counts = np.array([5, 3, 7, 1, 4, 4, 2, 6])
    plan = build_dense_plan(collective, counts, Topology(8, 4), "hier")
    calls = []

    def fn(x):
        calls.append(tuple(x.shape))
        return x

    tracer = TraceRecorder()
    secs = measure_dense_seconds(plan, "cpu", iters=3, warmup=1,
                                 tracer=tracer, executor=fn)
    n_seg, cmax = len(counts), int(counts.max())
    shape = (8, cmax) if collective == "allgatherv" else (8, n_seg, cmax)
    assert calls == [shape] * 5 and secs > 0.0
    assert measure_dense_seconds(plan, "cpu", iters=1, warmup=0) > 0.0
    (s,) = tracer.samples
    rplan = r_build_dense_plan(collective, counts, RTopology(8, 4), "hier")
    want = RTraceRecorder().record_plan(
        rplan, s.seconds, label=f"dense/{rplan.strategy}",
        pure_exchange=True, fingerprint=rplan.fingerprint)
    assert dataclasses.asdict(s) == dataclasses.asdict(want)


def test_auto_under_given_params_and_figures(hier):
    """Every ``auto`` under a non-``LASSEN`` model and explicit figures: the
    host history, and ``repro``'s Section-5 choices under the same model."""
    params = MachineParams(name="slow", **SLOW)
    dh = _setup(hier, strategy="auto", params=params, spmv_variant="auto",
                spmv_vmem_limit=FIGURES["vmem_limit"], spmv_overlap="auto",
                spmv_overlap_figures={k: FIGURES[k] for k in (
                    "hbm_bw", "vpu_flops", "launch_s")},
                coarse_gather="auto")
    kernels = {op.kernel_variant for _, _, op in dh._ops()}
    overlaps = {op.overlap_mode for _, _, op in dh._ops()}
    assert kernels == {"flat", "blocked"} and overlaps == {"on", "off"}
    b = np.random.default_rng(0).normal(size=hier.levels[0].A.nrows)
    _, want = host_solve(hier, b, tol=0.0, max_iters=4)
    _, got = dh.solve(b, tol=0.0, max_iters=4)
    np.testing.assert_allclose(got, want, **HIST)
    rparams = RParams(name="slow", **SLOW)
    for lv, name, op in dh._ops():
        rpat = _ref_pattern(op.part.pattern, op.part.col_offsets)
        _, rep = r_select_plan(rpat, RTopology(8, 4), rparams, value_bytes=8)
        assert op.strategy == rep.chosen, (lv.index, name)
    assert dh.coarse_selection.chosen in ("hier", "ring")
