"""The port's rank-stacked distributed AMG solve against ``repro``.

* On the CPU at P=8, for every strategy x kernel variant x overlap schedule,
  the port's residual history matches ``repro.amg.hierarchy.solve`` on the
  same operators at rtol=1e-8, atol=1e-15 (the bar of
  ``tests/multidevice_progs/check_distributed_amg.py``).  ``block_cols=64``
  makes the blocked configurations take both the bucket-skipping kernel and
  the dense blocked/partial kernels.
* One subprocess runs ``repro``'s own ``DistributedHierarchy`` on 8 virtual
  devices; the port, given the reference's machine model explicitly, must
  reproduce its history, strategies and kernel variants.
* The coarsest level through a dense allgatherv (``coarse_gather`` auto,
  hier, ring) at the reference's bar
  (``tests/multidevice_progs/check_dense_collectives.py``): iterations
  within 2 of the distributed coarse solve, solution within 1e-8; the warm
  start ``solve(x0=)`` continues the history; ``setup_partitioned`` at P=8
  against the host solver on its own hierarchy; and one more subprocess
  runs ``repro``'s ``setup_partitioned`` with ``coarse_gather="hier"``,
  which the port must reproduce.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.amg import build_hierarchy, diffusion_2d, solve
from repro.core.costmodel import TPU_V5E
from repro_torch.amg import DistributedHierarchy, from_reference_hierarchy
from repro_torch.amg import diffusion_2d as port_diffusion_2d
from repro_torch.amg import partition_fine_matrix
from repro_torch.amg import solve as port_solve
from repro_torch.core import PlanCache

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
HIST = dict(rtol=1e-8, atol=1e-15)
ITERS = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_hierarchy(h):
    def op(m):
        return None if m is None else (m.indptr, m.indices, m.data, m.shape)

    return from_reference_hierarchy(
        [(op(l.A), op(l.P), op(l.R), l.rho) for l in h.levels]
    )


@pytest.fixture(scope="module")
def problem():
    A = diffusion_2d(64, 64)
    h = build_hierarchy(A)
    b = np.random.default_rng(0).normal(size=A.nrows)
    _, hist = solve(h, b, tol=1e-8, max_iters=ITERS)
    return _port_hierarchy(h), b, hist


def _kernels(dh):
    return {k for fns in (dh._Amv, dh._Rmv, dh._Pmv) for f in fns
            if f is not None for k in f.kernels}


@pytest.mark.parametrize("overlap", ["off", "on"])
@pytest.mark.parametrize("variant", ["flat", "blocked"])
@pytest.mark.parametrize("strategy", ["standard", "partial", "full"])
def test_port_history_matches_host_solver(problem, strategy, variant,
                                          overlap):
    hp, b, hist_host = problem
    dh = DistributedHierarchy.setup(
        hp, 8, procs_per_region=4, strategy=strategy, cache=PlanCache(),
        spmv_variant=variant, spmv_overlap=overlap, spmv_block_cols=64,
        device="cpu",
    )
    assert {lv.A.strategy for lv in dh.levels} == {strategy}
    assert {row[2:4] for row in dh.kernel_table()} == {(variant, overlap)}
    kernels = _kernels(dh)
    if variant == "flat":
        assert kernels == {"spmv_ell"}
    else:
        dense = ("spmv_ell_blocked_partial" if overlap == "on"
                 else "spmv_ell_blocked")
        assert kernels == {"spmv_ell_blocked_skip", dense}
    _, hist = dh.solve(b, tol=1e-8, max_iters=ITERS)
    assert len(hist) == len(hist_host)
    np.testing.assert_allclose(hist, hist_host, **HIST)


def test_setup_rejects_auto_without_device_figures(problem):
    hp, _, _ = problem
    with pytest.raises(ValueError, match="vmem_limit_bytes"):
        DistributedHierarchy.setup(hp, 8, spmv_variant="auto",
                                   cache=PlanCache(), device="cpu")
    with pytest.raises(ValueError, match="hbm_bw"):
        DistributedHierarchy.setup(hp, 8, spmv_overlap="auto",
                                   cache=PlanCache(), device="cpu")


def test_repeated_setup_replans_nothing(problem):
    hp, _, _ = problem
    cache = PlanCache()
    dh1 = DistributedHierarchy.setup(hp, 8, procs_per_region=4,
                                     cache=cache, device="cpu")
    misses, exec_misses = cache.misses, cache.exec_misses
    dh2 = DistributedHierarchy.setup(hp, 8, procs_per_region=4,
                                     cache=cache, device="cpu")
    assert (cache.misses, cache.exec_misses) == (misses, exec_misses)
    assert cache.hits > 0 and cache.init_seconds_saved > 0.0
    for l1, l2 in zip(dh1.levels, dh2.levels):
        assert l1.A.coll is l2.A.coll


REFERENCE_RUN = """
import json
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np
from repro.amg import DistributedHierarchy, build_hierarchy, diffusion_2d
from repro.core import PlanCache
assert jax.device_count() == 8, jax.devices()
mesh = jax.make_mesh((8,), ("proc",))
A = diffusion_2d(32, 64)
h = build_hierarchy(A)
b = np.random.default_rng(0).normal(size=A.nrows)
dh = DistributedHierarchy.setup(
    h, mesh, procs_per_region=4, strategy="auto", cache=PlanCache(),
    spmv_variant="blocked", spmv_overlap="on", spmv_block_cols=64)
_, hist = dh.solve(b, tol=1e-8, max_iters=60)
print(json.dumps({
    "hist": [float(v) for v in hist],
    "strategies": [list(r[:3]) for r in dh.selection_table()],
    "kernels": [list(r[:4]) for r in dh.kernel_table()],
}))
"""


def run_reference(program: str) -> dict:
    """Run ``program`` on 8 virtual devices; its last line is JSON."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    out = subprocess.run([sys.executable, "-c", program], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_matches_reference_distributed_solve():
    """``repro``'s DistributedHierarchy on 8 virtual devices (auto
    strategy, blocked kernels, overlap on) against the port on the CPU,
    with the reference's machine model passed to the port."""
    ref = run_reference(REFERENCE_RUN)

    A = diffusion_2d(32, 64)
    h = build_hierarchy(A)
    b = np.random.default_rng(0).normal(size=A.nrows)
    dh = DistributedHierarchy.setup(
        _port_hierarchy(h), 8, procs_per_region=4, strategy="auto",
        params=TPU_V5E, cache=PlanCache(), spmv_variant="blocked",
        spmv_overlap="on", spmv_block_cols=64, device="cpu",
    )
    _, hist = dh.solve(b, tol=1e-8, max_iters=60)
    assert [list(r[:3]) for r in dh.selection_table()] == ref["strategies"]
    assert [list(r[:4]) for r in dh.kernel_table()] == ref["kernels"]
    assert len(hist) == len(ref["hist"])
    np.testing.assert_allclose(hist, ref["hist"], **HIST)


def test_setup_and_solve_record_spans(problem):
    """With the span ring enabled, setup and solve record their spans with
    the per-level verdicts; disabled, nothing is recorded."""
    from repro_torch.obs import NULL_SPAN, default_obs

    hp, b, _ = problem
    obs = default_obs()
    obs.spans.clear()
    assert obs.span("x") is NULL_SPAN
    obs.enable()
    try:
        dh = DistributedHierarchy.setup(hp, 8, procs_per_region=4,
                                        cache=PlanCache(), device="cpu")
        dh.solve(b, tol=1e-8, max_iters=2)
    finally:
        obs.disable()
    events = obs.spans.events()
    obs.spans.clear()
    names = [e.name for e in events]
    assert names.count("amg/build_level") == len(dh.levels)
    assert names.count("amg/vcycle_iter") == 2
    assert {"amg/setup", "amg/solve"} <= set(names)
    levels = [e for e in events if e.name == "amg/build_level"]
    assert [e.attrs["kernel"] for e in levels] == ["flat"] * len(dh.levels)
    solve_ev = next(e for e in events if e.name == "amg/solve")
    assert solve_ev.attrs["iters"] == 2 and solve_ev.duration > 0.0


# ------------------------------------------- coarse gather, warm start,
# ------------------------------------------- partitioned setup
COARSE_TOL, COARSE_ITERS = 1e-8, 60


@pytest.fixture(scope="module")
def coarse_off(problem):
    """The distributed coarse solve to 1e-8: (solution, history)."""
    hp, b, _ = problem
    dh = DistributedHierarchy.setup(hp, 8, procs_per_region=4,
                                    cache=PlanCache(), device="cpu")
    return dh.solve(b, tol=COARSE_TOL, max_iters=COARSE_ITERS)


@pytest.mark.parametrize("coarse_gather", ["auto", "hier", "ring"])
def test_coarse_gather_matches_distributed_coarse_solve(problem, coarse_off,
                                                        coarse_gather):
    hp, b, _ = problem
    x0, hist0 = coarse_off
    dh = DistributedHierarchy.setup(hp, 8, procs_per_region=4,
                                    cache=PlanCache(),
                                    coarse_gather=coarse_gather, device="cpu")
    x, hist = dh.solve(b, tol=COARSE_TOL, max_iters=COARSE_ITERS)
    assert hist[-1] < COARSE_TOL
    assert len(hist) <= len(hist0) + 2
    assert np.max(np.abs(x - x0)) / np.max(np.abs(x0)) < 1e-8
    sel = dh.coarse_selection
    assert sel.collective == "allgatherv"
    assert sel.chosen == (coarse_gather if coarse_gather != "auto"
                          else min(sel.modeled_times,
                                   key=sel.modeled_times.get))
    assert f"coarse_gather={coarse_gather}: dense/allgatherv" in dh.describe()


def test_warm_start_resumes_the_history(problem):
    hp, b, _ = problem
    dh = DistributedHierarchy.setup(hp, 8, procs_per_region=4,
                                    cache=PlanCache(), device="cpu")
    _, full = dh.solve(b, tol=0.0, max_iters=8)
    x3, head = dh.solve(b, tol=0.0, max_iters=3)
    _, tail = dh.solve(b, tol=0.0, max_iters=5, x0=x3)
    np.testing.assert_allclose(head, full[:3], **HIST)
    np.testing.assert_allclose(tail, full[3:], **HIST)


@pytest.fixture(scope="module")
def partitioned():
    A = port_diffusion_2d(64, 64)
    blocks, off = partition_fine_matrix(A, 8)
    b = np.random.default_rng(0).normal(size=A.nrows)
    return blocks, off, b


@pytest.mark.parametrize("variant,overlap", [("flat", "off"),
                                             ("blocked", "off"),
                                             ("blocked", "on")])
def test_setup_partitioned_matches_host_solver(partitioned, variant, overlap):
    blocks, off, b = partitioned
    cache = PlanCache()
    dh = DistributedHierarchy.setup_partitioned(
        blocks, off, procs_per_region=4, cache=cache, spmv_variant=variant,
        spmv_overlap=overlap, spmv_block_cols=64, device="cpu",
    )
    info = dh.setup_info
    assert info is not None and len(dh.levels) == info.n_levels
    assert [lv.n for lv in dh.levels] == [sl.nrows for sl in info.levels]
    _, hist_host = port_solve(info.to_host_hierarchy(), b, tol=1e-8,
                              max_iters=ITERS)
    _, hist = dh.solve(b, tol=1e-8, max_iters=ITERS)
    assert len(hist) == len(hist_host)
    np.testing.assert_allclose(hist, hist_host, **HIST)
    # the solve's collectives came out of the setup's cache where the
    # patterns coincide: a second partitioned setup plans nothing new
    misses, exec_misses = cache.misses, cache.exec_misses
    DistributedHierarchy.setup_partitioned(
        blocks, off, procs_per_region=4, cache=cache, spmv_variant=variant,
        spmv_overlap=overlap, spmv_block_cols=64, device="cpu",
    )
    assert (cache.misses, cache.exec_misses) == (misses, exec_misses)


PARTITIONED_RUN = """
import json
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np
from repro.amg import DistributedHierarchy, diffusion_2d, partition_fine_matrix
from repro.core import PlanCache
assert jax.device_count() == 8, jax.devices()
mesh = jax.make_mesh((8,), ("proc",))
A = diffusion_2d(32, 32)
blocks, off = partition_fine_matrix(A, 8)
b = np.random.default_rng(0).normal(size=A.nrows)
dh = DistributedHierarchy.setup_partitioned(
    blocks, off, mesh, procs_per_region=4, strategy="auto", cache=PlanCache(),
    spmv_variant="blocked", spmv_overlap="off", spmv_block_cols=64,
    coarse_gather="hier")
_, hist = dh.solve(b, tol=1e-8, max_iters=60)
print(json.dumps({
    "hist": [float(v) for v in hist],
    "strategies": [list(r[:3]) for r in dh.selection_table()],
    "kernels": [list(r[:4]) for r in dh.kernel_table()],
    "coarse": dh.coarse_selection.chosen,
    "levels": [int(lv.n) for lv in dh.levels],
}))
"""


def test_port_matches_reference_partitioned_solve():
    """``repro``'s ``setup_partitioned`` with the coarse allgatherv on 8
    virtual devices against the port on the CPU, with the reference's
    machine model passed to the port."""
    ref = run_reference(PARTITIONED_RUN)
    A = port_diffusion_2d(32, 32)
    blocks, off = partition_fine_matrix(A, 8)
    b = np.random.default_rng(0).normal(size=A.nrows)
    dh = DistributedHierarchy.setup_partitioned(
        blocks, off, procs_per_region=4, strategy="auto", params=TPU_V5E,
        cache=PlanCache(), spmv_variant="blocked", spmv_overlap="off",
        spmv_block_cols=64, coarse_gather="hier", device="cpu",
    )
    _, hist = dh.solve(b, tol=1e-8, max_iters=60)
    assert [lv.n for lv in dh.levels] == ref["levels"]
    assert [list(r[:3]) for r in dh.selection_table()] == ref["strategies"]
    assert [list(r[:4]) for r in dh.kernel_table()] == ref["kernels"]
    assert dh.coarse_selection.chosen == ref["coarse"] == "hier"
    assert len(hist) == len(ref["hist"])
    np.testing.assert_allclose(hist, ref["hist"], **HIST)
