"""The port's adaptive MoE re-planning pieces against ``repro``'s.

* ``quantize_histogram`` equals ``repro``'s on 200 seeded histograms, the
  zero and one-hot ones included.
* ``moe_plan_from_histogram`` gives ``repro``'s plans (fingerprints,
  selected modes, geometry) on 4-lane meshes for ``a2a``, ``hier``,
  ``hier_dedup`` and ``auto``, under ``repro``'s ``TPU_V5E`` and ``LASSEN``
  (passed to both sides), and a repeated histogram re-plans nothing.
* ``AdaptivePlanner`` yields ``repro``'s events on the same histogram
  sequences (steady, drift, return, and a wrong bin count): equal steps,
  modes and fingerprints, drift within 1e-12.

``repro``'s side runs in one subprocess on 8 virtual devices
(``--xla_force_host_platform_device_count=8``), on real ``jax`` meshes.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.costmodel import LASSEN as REF_LASSEN
from repro.core.costmodel import TPU_V5E
from repro.models.moe import quantize_histogram as ref_quantize
from repro_torch.configs import reduced
from repro_torch.core import PlanCache
from repro_torch.models.common import Mesh
from repro_torch.models.moe import (
    make_moe_plan,
    moe_plan_from_histogram,
    quantize_histogram,
)
from repro_torch.profile import AdaptivePlanner, TraceRecorder

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
ARCH = "deepseek-v2-lite-16b"
MESHES = [((1, 4), ("data", "model")), ((2, 2), ("pod", "model"))]
MODES = ("a2a", "hier", "hier_dedup", "auto")
PARAMS = {"tpu_v5e": TPU_V5E, "lassen": REF_LASSEN}
TOKENS = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def histograms(e_log: int):
    """Named histograms over ``e_log`` experts: uniform, skewed, one-hot,
    all on two experts, and two seeded random ones."""
    rng = np.random.default_rng(7)
    skew = np.arange(e_log, 0, -1, dtype=np.float64) ** 2
    return {
        "uniform": np.full(e_log, 4.0),
        "skew": skew,
        "onehot": np.eye(e_log)[0] * 12.0,
        "pair": np.r_[6.0, 6.0, np.zeros(e_log - 2)],
        "rand0": rng.integers(0, 9, e_log).astype(np.float64),
        "rand1": rng.exponential(size=e_log),
    }


def sequences(e_log: int):
    """Histogram sequences the planner observes: steady, a drift, a drift
    and its return, and noise around uniform."""
    uniform = np.full(e_log, 4.0)
    skew = np.r_[14.0, 2.0, np.zeros(e_log - 2)]
    rng = np.random.default_rng(3)
    noisy = [uniform + rng.uniform(0, 0.5, e_log) for _ in range(16)]
    return {
        "steady": [uniform] * 20,
        "drift": [uniform] * 6 + [skew] * 12,
        "return": [uniform] * 6 + [skew] * 12 + [uniform] * 12 + [skew] * 12,
        "noisy": noisy,
    }


REFERENCE = r"""
import dataclasses, json, sys
import jax
import jax.numpy as jnp
import numpy as np
assert jax.device_count() == 8, jax.devices()
sys.path.insert(0, sys.argv[1])
from test_torch_adapt import ARCH, MESHES, MODES, TOKENS, histograms, sequences
from repro.configs import reduced
from repro.core import PlanCache
from repro.core.costmodel import LASSEN, TPU_V5E
from repro.models.moe import make_moe_plan, moe_plan_from_histogram
from repro.profile import AdaptivePlanner
cfg = dataclasses.replace(reduced(ARCH), dtype=jnp.float32)
params = {"tpu_v5e": TPU_V5E, "lassen": LASSEN}
plans = {}
for shape, names in MESHES:
    mesh = jax.make_mesh(shape, names, devices=jax.devices()[:4])
    for pname, p in params.items():
        for mode in MODES:
            for hname, h in histograms(cfg.n_experts).items():
                plan = moe_plan_from_histogram(cfg, mesh, TOKENS, h,
                                               mode=mode, params=p,
                                               cache=PlanCache())
                plans[f"{shape}/{pname}/{mode}/{hname}"] = \
                    dataclasses.asdict(plan)
events = {}
mesh = jax.make_mesh((1, 4), ("data", "model"), devices=jax.devices()[:4])
for pname, p in params.items():
    for sname, seq in sequences(cfg.n_experts).items():
        cache = PlanCache()
        pl = AdaptivePlanner(cfg=cfg, mesh=mesh, tokens_per_lane=TOKENS,
                             plan=make_moe_plan(cfg, mesh, TOKENS, mode="a2a"),
                             threshold=0.3, warmup=2, window=4, params=p,
                             cache=cache)
        for h in seq:
            pl.observe(h)
        events[f"{pname}/{sname}"] = dict(
            events=[dataclasses.asdict(e) for e in pl.events],
            misses=cache.misses, hits=cache.hits)
try:
    pl.observe(np.ones(7))
    wrong = ""
except ValueError as e:
    wrong = str(e)
print(json.dumps({"plans": plans, "events": events, "wrong": wrong}))
"""


@pytest.fixture(scope="module")
def reference():
    """``repro``'s plans and events, from one subprocess on 8 virtual
    devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    here = str(pathlib.Path(__file__).resolve().parent)
    out = subprocess.run([sys.executable, "-c", REFERENCE, here], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    return json.loads(out.stdout.strip().splitlines()[-1])


def cfg():
    return dataclasses.replace(reduced(ARCH), dtype=torch.float32)


def test_quantize_histogram_equals_reference():
    rng = np.random.default_rng(0)
    cases = [(np.zeros(8), 8, 64), (np.eye(8)[3], 8, 64),
             (np.eye(64)[63] * 5, 64, 64), (np.zeros(4), 4, 7)]
    while len(cases) < 200:
        e_log = int(rng.choice([4, 8, 64]))
        quantum = int(rng.choice([7, 16, 64, 100]))
        h = rng.exponential(size=e_log) * rng.integers(0, 2, e_log)
        if rng.random() < 0.3:          # exact ties in the remainders
            h = np.round(h * 2) / 2
        cases.append((h, e_log, quantum))
    for h, e_log, quantum in cases:
        got = quantize_histogram(h, e_log, quantum)
        assert got == ref_quantize(h, e_log, quantum)
        assert sum(got) == quantum
    with pytest.raises(ValueError, match="bins"):
        quantize_histogram(np.ones(5), 4)


def test_histogram_plans_equal_reference(reference):
    c = cfg()
    n = 0
    for shape, names in MESHES:
        mesh = Mesh(names, shape)
        for pname, p in PARAMS.items():
            for mode in MODES:
                for hname, h in histograms(c.n_experts).items():
                    got = moe_plan_from_histogram(c, mesh, TOKENS, h,
                                                  mode=mode, params=p,
                                                  cache=PlanCache())
                    want = reference["plans"][
                        f"{tuple(shape)}/{pname}/{mode}/{hname}"]
                    assert dataclasses.asdict(got) == {
                        k: tuple(v) if isinstance(v, list) else v
                        for k, v in want.items()}, (shape, pname, mode, hname)
                    n += 1
    assert n == len(reference["plans"])
    # the selector chose every transport somewhere
    chosen = {v["mode"] for k, v in reference["plans"].items()
              if "/auto/" in k}
    assert chosen <= {"a2a", "hier", "hier_dedup"} and chosen


def test_histogram_plan_repeats_hit_and_auto_needs_params():
    c = cfg()
    mesh = Mesh(("data", "model"), (1, 4))
    cache = PlanCache()
    h = np.array([5.0, 3.0, 2.0, 6.0, 1.0, 0.0, 0.0, 4.0])
    p1 = moe_plan_from_histogram(c, mesh, TOKENS, h, params=TPU_V5E,
                                 cache=cache)
    misses = cache.misses
    p2 = moe_plan_from_histogram(c, mesh, TOKENS, h * 2.0 + 1e-3,
                                 params=TPU_V5E, cache=cache)
    assert p2 is p1 and cache.misses == misses
    with pytest.raises(ValueError, match="MachineParams"):
        moe_plan_from_histogram(c, mesh, TOKENS, h, cache=cache)


@pytest.mark.parametrize("pname", sorted(PARAMS))
def test_planner_events_equal_reference(reference, pname):
    c = cfg()
    mesh = Mesh(("data", "model"), (1, 4))
    for sname, seq in sequences(c.n_experts).items():
        cache = PlanCache()
        tracer = TraceRecorder()
        pl = AdaptivePlanner(cfg=c, mesh=mesh, tokens_per_lane=TOKENS,
                             plan=make_moe_plan(c, mesh, TOKENS, mode="a2a"),
                             threshold=0.3, warmup=2, window=4,
                             params=PARAMS[pname], cache=cache, tracer=tracer)
        for h in seq:
            pl.observe(h)
        want = reference["events"][f"{pname}/{sname}"]
        assert len(pl.events) == len(want["events"]), sname
        for got, ev in zip(pl.events, want["events"]):
            assert got.step == ev["step"]
            assert (got.old_mode, got.new_mode) == (ev["old_mode"],
                                                    ev["new_mode"])
            assert (got.old_fingerprint, got.new_fingerprint) == (
                ev["old_fingerprint"], ev["new_fingerprint"])
            assert abs(got.drift - ev["drift"]) <= 1e-12
        assert (cache.misses, cache.hits) == (want["misses"], want["hits"])
        assert len(tracer.histograms) == len(seq)
    assert [len(reference["events"][f"{pname}/{s}"]["events"])
            for s in ("steady", "drift", "return")] == [0, 1, 3]


def test_planner_rejects_wrong_bin_count_and_auto_without_params(reference):
    c = cfg()
    mesh = Mesh(("data", "model"), (1, 4))
    plan = make_moe_plan(c, mesh, TOKENS, mode="a2a")
    pl = AdaptivePlanner(cfg=c, mesh=mesh, tokens_per_lane=TOKENS, plan=plan,
                         params=TPU_V5E)
    with pytest.raises(ValueError) as err:
        pl.observe(np.ones(7))
    assert str(err.value) == reference["wrong"]
    with pytest.raises(ValueError, match="MachineParams"):
        AdaptivePlanner(cfg=c, mesh=mesh, tokens_per_lane=TOKENS, plan=plan)
    # a pinned transport needs no machine model
    AdaptivePlanner(cfg=c, mesh=mesh, tokens_per_lane=TOKENS, plan=plan,
                    mode="a2a")
