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


def test_port_matches_reference_distributed_solve():
    """``repro``'s DistributedHierarchy on 8 virtual devices (auto
    strategy, blocked kernels, overlap on) against the port on the CPU,
    with the reference's machine model passed to the port."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    out = subprocess.run([sys.executable, "-c", REFERENCE_RUN], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    ref = json.loads(out.stdout.strip().splitlines()[-1])

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
