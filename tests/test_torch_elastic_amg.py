"""The port's elastic AMG (``repartition``, ``setup(row_weights=)``, the
straggler mitigation) against ``repro``.

One subprocess runs ``repro``'s ``DistributedHierarchy`` on 8 virtual
devices on ``poisson2d(28)`` (``tests/multidevice_progs/check_elastic.py``'s
problem): 4 V-cycles on 8 devices, a heartbeat ``repartition`` to 4, 4
more from the 8-device iterate, a grow-back to 8; ``setup(row_weights=)``
and a rebalance ``repartition`` under skewed weights (each solve compiles
for 20-40 s, so the subprocess solves twice).  Both sides run under
``LASSEN``, flat/off.  The port, on the same host hierarchy, must give the
iterates within 1e-12, the ``ResizeEvent`` miss and hit counts equal (10
cold misses in the shrink, 0 in the grow-back), every level's offsets
under ``row_weights`` equal, and the histories within 1e-8.

On the port alone: the resumed iterate within 1e-12 of a cold 4-rank
solve and the grown-back one within 1e-10 of it (the reference's bars),
the weighted hierarchy's solve, the straggler scenario of
``check_elastic.py`` on ``poisson2d(24)`` (one rebalance, host 2 with the fewest rows, a refit,
the rebalanced solve below 1e-8), ``repartition`` carrying the blocked
kernel policy, and ``repartition`` of a ``setup_partitioned`` hierarchy
through its reassembled host levels.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.amg import build_hierarchy
from repro.sparse.csr import CSR
from repro_torch.amg import (
    DistributedHierarchy,
    from_reference_hierarchy,
    partition_fine_matrix,
)
from repro_torch.core import PlanCache
from repro_torch.core.costmodel import LASSEN
from repro_torch.profile import TraceRecorder
from repro_torch.runtime import ElasticController, StragglerConfig
from repro_torch.sparse.csr import CSR as PortCSR

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
K, M = 4, 4
WEIGHTS = [0.01, 0.01, 0.03, 0.01, 0.01, 0.005, 0.01, 0.01]
KW = dict(params=LASSEN, spmv_variant="flat", spmv_overlap="off",
          device="cpu")

POISSON = '''
def poisson2d(nx):
    n = nx * nx
    rows, cols, vals = [], [], []
    for i in range(nx):
        for j in range(nx):
            k = i * nx + j
            rows.append(k); cols.append(k); vals.append(4.0)
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < nx and 0 <= jj < nx:
                    rows.append(k); cols.append(ii * nx + jj)
                    vals.append(-1.0)
    return CSR.from_coo(np.array(rows), np.array(cols), np.array(vals),
                        (n, n))
'''

PROG = '''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np
from jax.sharding import Mesh
from repro.amg.distributed import DistributedHierarchy
from repro.amg.hierarchy import build_hierarchy
from repro.core.cache import PlanCache
from repro.core.costmodel import LASSEN
from repro.sparse.csr import CSR
''' + POISSON + '''
K, M = %d, %d
W = np.array(%s)
KW = dict(params=LASSEN, spmv_variant="flat", spmv_overlap="off")

def mesh_n(n):
    return Mesh(np.array(jax.devices()[:n]), ("proc",))

def ev(e):
    return {k: getattr(e, k) for k in ("old_n", "new_n", "plan_misses",
                                       "plan_hits", "exec_misses",
                                       "exec_hits", "warm")}

A = poisson2d(28)
h = build_hierarchy(A)
b = np.random.default_rng(0).normal(size=A.nrows)
cache = PlanCache()
dh8 = DistributedHierarchy.setup(h, mesh_n(8), "proc", cache=cache, **KW)
out, events = {}, {}
out["x_mid"], out["h_mid"] = dh8.solve(b, tol=0.0, max_iters=K)
dh4 = dh8.repartition(mesh_n(4), reason="heartbeat")
events["shrink"] = ev(dh4.last_resize)
out["x_el"], out["h_el"] = dh4.solve(b, tol=0.0, max_iters=M,
                                     x0=out["x_mid"])
dh8b = dh4.repartition(mesh_n(8), reason="requested")
events["grow"] = ev(dh8b.last_resize)
dhw = DistributedHierarchy.setup(h, mesh_n(8), "proc", cache=PlanCache(),
                                 row_weights=W, **KW)
for k, lv in enumerate(dhw.levels):
    out["offs_%%d" %% k] = lv.A.part.offsets
dhr = dh8b.repartition(row_weights=W, reason="rebalance")
events["rebalance"] = ev(dhr.last_resize)
events["levels"] = len(dhw.levels)
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
print(json.dumps(events))
''' % (K, M, WEIGHTS)


def poisson2d(nx: int) -> CSR:
    ns = {"np": np, "CSR": CSR}
    exec(POISSON, ns)
    return ns["poisson2d"](nx)


def _port_hierarchy(h):
    def op(m):
        return None if m is None else (m.indptr, m.indices, m.data, m.shape)

    return from_reference_hierarchy(
        [(op(l.A), op(l.P), op(l.R), l.rho) for l in h.levels]
    )


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``repro``'s elastic solve on 8 virtual devices, dumped to npz."""
    path = tmp_path_factory.mktemp("elastic") / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", PROG, str(path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    events = json.loads(out.stdout.strip().splitlines()[-1])
    return dict(np.load(path)), events


@pytest.fixture(scope="module")
def port():
    """The same sequence on the port, on ``repro``'s host hierarchy."""
    A = poisson2d(28)
    hp = _port_hierarchy(build_hierarchy(A))
    b = np.random.default_rng(0).normal(size=A.nrows)
    cache = PlanCache()
    dh8 = DistributedHierarchy.setup(hp, 8, cache=cache, **KW)
    out, dhs = {}, {}
    out["x_mid"], out["h_mid"] = dh8.solve(b, tol=0.0, max_iters=K)
    dh4 = dh8.repartition(n_procs=4, reason="heartbeat")
    out["x_el"], out["h_el"] = dh4.solve(b, tol=0.0, max_iters=M,
                                         x0=out["x_mid"])
    cold = DistributedHierarchy.setup(hp, 4, cache=PlanCache(), **KW)
    out["x_c4"], out["h_c4"] = cold.solve(b, tol=0.0, max_iters=K + M)
    dh8b = dh4.repartition(n_procs=8, reason="requested")
    out["x_back"], out["h_back"] = dh8b.solve(b, tol=0.0, max_iters=K + M)
    dhw = DistributedHierarchy.setup(hp, 8, cache=PlanCache(),
                                     row_weights=np.array(WEIGHTS), **KW)
    for k, lv in enumerate(dhw.levels):
        out[f"offs_{k}"] = lv.A.part.offsets
    out["x_w"], out["h_w"] = dhw.solve(b, tol=1e-8, max_iters=40)
    dhr = dh8b.repartition(row_weights=np.array(WEIGHTS),
                           reason="rebalance")
    dhs.update(shrink=dh4, grow=dh8b, rebalance=dhr, weighted=dhw, cold=cold)
    return out, dhs


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", ["x_mid", "x_el"])
def test_iterates_match_reference(reference, port, name):
    assert _rel(port[0][name], reference[0][name]) < 1e-12


def test_shrink_resumes_like_a_cold_solve(port):
    out, _ = port
    assert _rel(out["x_el"], out["x_c4"]) < 1e-12
    assert _rel(out["x_back"], out["x_c4"]) < 1e-10
    assert out["h_w"][-1] < 1e-8 and len(out["h_w"]) < 40


@pytest.mark.parametrize("name", ["h_mid", "h_el"])
def test_histories_match_reference(reference, port, name):
    got, want = port[0][name], reference[0][name]
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-15)


@pytest.mark.parametrize("which", ["shrink", "grow", "rebalance"])
def test_resize_events_match_reference(reference, port, which):
    got = port[1][which].last_resize
    want = reference[1][which]
    for field, value in want.items():
        assert getattr(got, field) == value, (field, got)
    if which == "shrink":
        assert got.plan_misses == 10 and not got.warm
    if which == "grow":
        assert got.plan_misses == 0 and got.exec_misses == 0 and got.warm


def test_row_weight_offsets_match_reference(reference, port):
    ref, n_levels = reference[0], reference[1]["levels"]
    assert len(port[1]["weighted"].levels) == n_levels
    for k in range(n_levels):
        np.testing.assert_array_equal(port[0][f"offs_{k}"], ref[f"offs_{k}"])
    rows = np.diff(port[0]["offs_0"])
    assert rows[2] == rows.min() and rows[5] == rows.max()


def test_repartition_carries_every_setting(port):
    dh = port[1]["rebalance"]
    assert dh.topo.n_procs == 8 and dh.params is LASSEN
    assert (dh.spmv_variant, dh.spmv_overlap, dh.device.type) == (
        "flat", "off", "cpu")
    hp = port[1]["cold"]._host
    cache = PlanCache()
    blocked = DistributedHierarchy.setup(
        hp, 8, cache=cache, spmv_variant="blocked", spmv_block_cols=64,
        coarse_gather="hier", device="cpu")
    moved = blocked.repartition(n_procs=4)
    assert {row[2] for row in moved.kernel_table()} == {"blocked"}
    assert moved.spmv_block_cols == 64 and moved.coarse_gather == "hier"
    assert moved.coarse_selection is not None
    assert moved._host is hp and moved.cache is cache


def test_repartition_of_a_partitioned_hierarchy():
    """A ``setup_partitioned`` hierarchy repartitions through its host
    levels reassembled from the rank blocks (bit-exact), rho carried."""
    ref = poisson2d(20)
    A = PortCSR(ref.shape, ref.indptr, ref.indices, ref.data)
    blocks, offs = partition_fine_matrix(A, 8)
    dhp = DistributedHierarchy.setup_partitioned(blocks, offs,
                                                 cache=PlanCache(), **KW)
    b = np.random.default_rng(1).normal(size=A.nrows)
    _, hist = dhp.solve(b, tol=0.0, max_iters=6)
    host = dhp._global_hierarchy()
    np.testing.assert_array_equal(host.levels[0].A.to_dense(), A.to_dense())
    assert [hl.rho for hl in host.levels] == [lv.rho for lv in dhp.levels]
    dh4 = dhp.repartition(n_procs=4, reason="heartbeat")
    assert dh4._host is host
    _, hist4 = dh4.solve(b, tol=0.0, max_iters=6)
    np.testing.assert_allclose(hist4, hist, rtol=1e-8, atol=1e-15)
    assert (dh4.last_resize.old_n, dh4.last_resize.new_n) == (8, 4)


def test_straggler_mitigation_on_the_port():
    """``check_elastic.py``'s straggler scenario on ``poisson2d(24)``."""
    A = poisson2d(24)
    hp = _port_hierarchy(build_hierarchy(A))
    cache = PlanCache()
    tracer = TraceRecorder()
    dh = DistributedHierarchy.setup(hp, 8, cache=cache, device="cpu")
    dh.measure_exchange_seconds(iters=2, warmup=1, tracer=tracer)
    ctrl = ElasticController(8, cache=cache, tracer=tracer,
                             straggler_cfg=StragglerConfig(patience=3),
                             cooldown=8)
    base = np.full(8, 0.010)
    n_events = 0
    for t in range(24):
        times = base.copy()
        if n_events == 0:
            times[2] *= 3.0
        times *= 1.0 + 0.01 * np.sin(t)
        flagged = ctrl.observe_step_times(times)
        if flagged:
            assert flagged == [2]
            dh, ev = ctrl.mitigate_hierarchy(dh, flagged)
            n_events += 1
            rows = np.diff(dh.levels[0].A.part.offsets)
            assert rows[2] == rows.min() and rows[2] < rows.max()
            assert ev.refit and ev.params_name == "straggler-refit"
            assert dh.params.name == "straggler-refit"
            assert ev.resize is dh.last_resize
            assert ev.resize.reason == "rebalance"
    assert len(ctrl.rebalance_events) == 1 and n_events == 1
    assert ctrl.summary()["resize_events"] == 1
    b = np.random.default_rng(2).normal(size=A.nrows)
    x, hist = dh.solve(b, tol=1e-8, max_iters=40)
    assert hist[-1] < 1e-8
    r = b - A.matvec(x)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-6
