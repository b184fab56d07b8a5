"""The port's elastic runtime (straggler, elastic, heartbeat, controller)
against ``repro.runtime``, in process.

* ``StragglerDetector``: flags and EWMA bit-equal to ``repro``'s over
  seeded sequences with a persistent straggler, resets (hysteresis),
  flapping and an all-slow fleet.
* ``rebalance_shards`` bit-equal over random weights and row totals.
* ``choose_mesh_shape`` equal over a grid of device counts and
  requirements; ``make_mesh_from_devices`` gives the lane ``Mesh`` of the
  shape.
* ``HeartbeatMonitor`` death lists, ``ElasticController`` cooldown and
  summaries, and ``cache_delta_event`` fields equal.
* ``tests/test_runtime.py``'s elastic and straggler cases, each run on
  both packages (parametrised); ``reshard_state``'s placement on the port.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.runtime as ref_rt
import repro_torch.runtime as rt
from repro_torch.models.common import Mesh

PACKAGES = {"repro": ref_rt, "repro_torch": rt}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def test_all_exports_match_reference():
    assert set(ref_rt.__all__) <= set(rt.__all__)
    for name in ref_rt.__all__:
        assert getattr(rt, name) is not None
    mod = importlib.import_module("repro_torch.runtime.straggler")
    assert mod.rebalance_shards is rt.rebalance_shards


# ---------------------------------------------------------------- straggler
def _sequence(kind: str, n: int, steps: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = 0.01 * (1.0 + 0.05 * rng.random((steps, n)))
    if kind == "straggler":
        base[:, seed % n] *= 1.5 + 2.0 * rng.random()
    elif kind == "flapping":
        base[::2, seed % n] *= 3.0
    elif kind == "all_slow":
        base[:] = 0.02
    elif kind == "late":
        base[steps // 2:, (seed + 1) % n] *= 2.5
    return base


@pytest.mark.parametrize("kind", ["straggler", "flapping", "all_slow",
                                  "late"])
@pytest.mark.parametrize("seed", range(4))
def test_detector_bit_equal(kind, seed):
    n = 3 + seed * 2
    cfgs = [dict(), dict(ewma=1.0, patience=3), dict(threshold=0.5,
                                                     patience=2)]
    kw = cfgs[seed % len(cfgs)]
    ours = rt.StragglerDetector(n, rt.StragglerConfig(**kw))
    ref = ref_rt.StragglerDetector(n, ref_rt.StragglerConfig(**kw))
    seq = _sequence(kind, n, 30, seed)
    for t, times in enumerate(seq):
        assert ours.update(times) == ref.update(times)
        np.testing.assert_array_equal(ours.times, ref.times)
        np.testing.assert_array_equal(ours.flags, ref.flags)
        if t == 12:
            ours.reset(reseed_times=True)
            ref.reset(reseed_times=True)
        elif t == 20:
            ours.reset(hosts=[0, n - 1])
            ref.reset(hosts=[0, n - 1])
        np.testing.assert_array_equal(ours.times, ref.times)
        np.testing.assert_array_equal(ours.flags, ref.flags)


def test_detector_rejects_wrong_length():
    for mod in PACKAGES.values():
        with pytest.raises(ValueError, match="step times"):
            mod.StragglerDetector(4).update(np.ones(3))


@pytest.mark.parametrize("seed", range(25))
def test_rebalance_shards_bit_equal(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 17))
    total = int(rng.integers(0, 1 << 20))
    w = rng.random(n) * 10.0 ** rng.integers(-12, 1)
    if seed % 5 == 0:
        w[rng.integers(n)] = 0.0          # clamped at 1e-9
    got = rt.rebalance_shards(w, total)
    want = ref_rt.rebalance_shards(w, total)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and got.sum() == total


# ------------------------------------------------------------------ elastic
def test_choose_mesh_shape_equal_over_grid():
    cases = 0
    for n in (1, 2, 3, 4, 6, 7, 8, 12, 16, 48, 64, 96, 255, 256, 257, 504,
              512, 600, 1024):
        for div in (1, 2, 4, 6, 8, 14, 16, 48, 64):
            for pref in (1, 2, 4, 8, 16):
                for mn in (1, 2):
                    for pod in (8, 256):
                        req = rt.MeshRequirements(div, pref, mn)
                        rreq = ref_rt.MeshRequirements(div, pref, mn)
                        got = rt.choose_mesh_shape(n, req, pod)
                        assert got == ref_rt.choose_mesh_shape(n, rreq, pod)
                        assert int(np.prod(got[0])) <= n
                        cases += 1
    assert cases > 3000


@pytest.mark.parametrize("n", [4, 8, 512])
def test_make_mesh_from_devices_is_the_lane_mesh(n):
    shape, axes = rt.choose_mesh_shape(n, rt.MeshRequirements(4, 4))
    mesh = rt.make_mesh_from_devices(shape, axes)
    assert mesh == Mesh(axes, shape) and mesh.size == n
    ref_mesh_shape = ref_rt.choose_mesh_shape(n, ref_rt.MeshRequirements(4,
                                                                         4))
    assert (mesh.shape, mesh.axis_names) == ref_mesh_shape


def test_reshard_state_places_without_cast_or_copy():
    rng = np.random.default_rng(3)
    state = {
        "w": torch.as_tensor(rng.normal(size=(4, 6)).astype(np.float32)),
        "h": torch.as_tensor(rng.normal(size=(2, 2))).to(torch.bfloat16),
        "n": rng.integers(0, 99, size=(5,)).astype(np.int32),
        "l": [torch.arange(3), (np.zeros((1, 2)),)],
        "none": None,
    }
    got = rt.reshard_state(state, "cpu")
    assert got["w"] is state["w"] and got["h"] is state["h"]
    assert got["none"] is None and isinstance(got["l"][1], tuple)
    assert got["n"].dtype == torch.int32 and got["n"].shape == (5,)
    np.testing.assert_array_equal(got["n"].numpy(), state["n"])
    assert got["h"].dtype == torch.bfloat16
    assert torch.equal(got["l"][0], state["l"][0])


def test_reshard_state_keeps_namedtuple_types():
    """A NamedTuple holding a NamedTuple (``repro``'s ``TrainState`` holds
    ``OptState``) comes back as the same types, its leaves placed."""
    from typing import Any, NamedTuple

    class Opt(NamedTuple):
        step: Any
        mu: Any

    class State(NamedTuple):
        params: Any
        opt: Opt
        residual: Any

    state = State(params={"w": torch.ones(2, 3)},
                  opt=Opt(step=np.arange(4, dtype=np.int32),
                          mu=[torch.zeros(3)]),
                  residual=None)
    got = rt.reshard_state(state, "cpu")
    assert type(got) is State and type(got.opt) is Opt
    assert got.residual is None and got.params["w"] is state.params["w"]
    assert got.opt.step.dtype == torch.int32
    np.testing.assert_array_equal(got.opt.step.numpy(), state.opt.step)
    assert isinstance(got.opt.mu, list) and got.opt.mu[0] is state.opt.mu[0]


@pytest.mark.parametrize("seed", range(6))
def test_heartbeat_death_lists_equal(seed):
    rng = np.random.default_rng(seed)
    n, timeout = int(rng.integers(1, 9)), int(rng.integers(0, 4))
    ours, ref = rt.HeartbeatMonitor(n, timeout), ref_rt.HeartbeatMonitor(
        n, timeout)
    alive = rng.random(n) < 0.7
    for _ in range(12):
        for h in range(n):
            if alive[h] and rng.random() < 0.9:
                ours.beat(h)
                ref.beat(h)
        assert ours.advance() == ref.advance()
        assert ours.last_seen == ref.last_seen
        alive &= rng.random(n) < 0.9


# --------------------------------------------------------------- controller
@pytest.mark.parametrize("cooldown", [0, 3, 8])
def test_controller_cooldown_equal(cooldown):
    cfg = dict(ewma=1.0, patience=3)
    ours = rt.ElasticController(6, straggler_cfg=rt.StragglerConfig(**cfg),
                                cooldown=cooldown)
    ref = ref_rt.ElasticController(
        6, straggler_cfg=ref_rt.StragglerConfig(**cfg), cooldown=cooldown)
    seq = _sequence("straggler", 6, 40, 1)
    fired = 0
    for t, times in enumerate(seq):
        a, b = ours.observe_step_times(times), ref.observe_step_times(times)
        assert a == b
        if a:
            fired += 1
            for c in (ours, ref):   # what mitigate_hierarchy does after
                c.detector.reset(reseed_times=True)
                c._cooldown_left = c.cooldown
        assert ours.summary() == ref.summary()
        if t % 7 == 0:
            assert ours.advance() == ref.advance()
        ours.beat(t % 6)
        ref.beat(t % 6)
    assert fired >= 2
    req = (rt.MeshRequirements(8, 8), ref_rt.MeshRequirements(8, 8))
    assert ours.plan_mesh(24, req[0]) == ref.plan_mesh(24, req[1])


class _Counters:
    def __init__(self, seq):
        self.seq = iter(seq)

    def counters(self):
        return next(self.seq)


@pytest.mark.parametrize("misses", [0, 10])
def test_cache_delta_event_fields_equal(misses):
    before = dict(hits=5, misses=3, exec_hits=2, exec_misses=1, evictions=0)
    after = dict(hits=17, misses=3 + misses, exec_hits=9,
                 exec_misses=1 + misses, evictions=0)
    got = rt.cache_delta_event(_Counters([after]), before, "heartbeat", 8, 4,
                               0.125)
    want = ref_rt.cache_delta_event(_Counters([after]), before, "heartbeat",
                                    8, 4, 0.125)
    fields = ("reason", "old_n", "new_n", "replan_seconds", "plan_misses",
              "plan_hits", "exec_misses", "exec_hits", "warm")
    assert [getattr(got, f) for f in fields] == [getattr(want, f)
                                                  for f in fields]
    assert str(got) == str(want)
    assert got.warm == (misses == 0)
    ev = rt.RebalanceEvent([2], 3, np.array([0.01, 0.03]), True, "x", 0.5,
                           got)
    rev = ref_rt.RebalanceEvent([2], 3, np.array([0.01, 0.03]), True, "x",
                                0.5, want)
    assert str(ev) == str(rev)


def test_resize_event_emits_obs_event():
    from repro_torch.obs import default_obs

    obs = default_obs()
    obs.reset()
    obs.enable()
    try:
        rt.cache_delta_event(
            _Counters([dict(hits=1, misses=0, exec_hits=1, exec_misses=0,
                            evictions=0)]),
            dict(hits=0, misses=0, exec_hits=0, exec_misses=0, evictions=0),
            "requested", 4, 8, 0.01)
        evs = obs.spans.events(kind="instant")
    finally:
        obs.disable()
    resize = [e for e in evs if e.name == "runtime/resize"]
    assert len(resize) == 1 and resize[0].attrs["warm"] is True


# ------------------------------- tests/test_runtime.py's cases, both packages
def test_choose_mesh_shape_shrinks_gracefully(pkg):
    req = pkg.MeshRequirements(model_divisors=48, prefer_model=16)
    shape, axes = pkg.choose_mesh_shape(512, req)
    assert shape == (2, 16, 16) and axes == ("pod", "data", "model")
    shape, axes = pkg.choose_mesh_shape(504, req)
    assert np.prod(shape) == 504
    shape, axes = pkg.choose_mesh_shape(8, req)
    assert np.prod(shape) == 8
    req2 = pkg.MeshRequirements(model_divisors=14, prefer_model=16)
    shape, _ = pkg.choose_mesh_shape(64, req2)
    assert shape[-1] in (1, 2)


def test_heartbeat_monitor(pkg):
    hb = pkg.HeartbeatMonitor(n_hosts=3, timeout_steps=2)
    for step in range(4):
        hb.beat(0)
        hb.beat(1)
        if step < 1:
            hb.beat(2)
        dead = hb.advance()
    assert dead == [2]


def test_straggler_detector_and_rebalance(pkg):
    det = pkg.StragglerDetector(4)
    flagged = []
    for _ in range(10):
        flagged = det.update(np.array([1.0, 1.0, 1.0, 2.2]))
    assert flagged == [3]
    counts = pkg.rebalance_shards(det.times, total_rows=64)
    assert counts.sum() == 64
    assert counts[3] < counts[0]


def test_rebalance_single_host_is_identity(pkg):
    for w in (1e-9, 0.01, 3.7):
        counts = pkg.rebalance_shards(np.array([w]), total_rows=64)
        assert counts.tolist() == [64]
    counts = pkg.rebalance_shards(np.full(4, 0.02), total_rows=64)
    assert counts.sum() == 64 and counts.max() - counts.min() <= 1


def test_straggler_all_slow_is_not_flagged(pkg):
    det = pkg.StragglerDetector(4, pkg.StragglerConfig(threshold=0.5,
                                                       patience=2))
    flagged = []
    for _ in range(6):
        flagged = det.update(np.full(4, 0.02))
    assert (det.flags >= det.cfg.patience).all()
    assert flagged == []


def test_straggler_flapping_hysteresis(pkg):
    det = pkg.StragglerDetector(4, pkg.StragglerConfig(ewma=1.0, patience=3))
    base = np.full(4, 0.01)
    for t in range(12):
        times = base.copy()
        if t % 2 == 0:
            times[1] *= 3.0
        assert det.update(times) == []
    ctrl = pkg.ElasticController(
        4, straggler_cfg=pkg.StragglerConfig(ewma=1.0, patience=3),
        cooldown=5)
    slow = base.copy()
    slow[1] *= 3.0
    flagged = []
    for _ in range(3):
        flagged = ctrl.observe_step_times(slow)
    assert flagged == [1]
    ctrl.detector.reset(reseed_times=True)
    ctrl._cooldown_left = ctrl.cooldown
    for _ in range(ctrl.cooldown + 6):
        assert ctrl.observe_step_times(base) == []
    ctrl.detector.reset(reseed_times=True)
    ctrl._cooldown_left = ctrl.cooldown
    for _ in range(ctrl.cooldown):
        assert ctrl.observe_step_times(slow) == []
    assert ctrl.observe_step_times(slow) == [1]
