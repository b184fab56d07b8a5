"""The port's MoE dispatch against ``repro.models.moe``.

* Planning: geometry, routing-pattern fingerprints and the Section-5
  selected modes under the paper's ``LASSEN`` model equal ``repro``'s
  exactly, at the reduced and the full DeepSeek-V2-Lite sizes.
* ``route`` and ``capacity_pack`` equal ``repro``'s on seeded inputs,
  including exact ties among the router's probabilities (ties go to the
  lower expert id, as ``jax.lax.top_k`` orders them).
* One subprocess runs ``repro``'s ``moe_layer`` on an 8-device
  (pod, data, model) = (2, 2, 2) mesh for every mode, with and without
  ``ep_over_pods``, at ``cap_factor=8.0``, plus two capacity-starved runs,
  and dumps inputs and outputs; the port, with the 8 devices as lanes on
  the CPU, reproduces each output within 1e-5 (float32; the expert
  products sum in another order) and ``dropped`` / ``expert_counts``
  exactly.
* The layer's K6 call takes the lanes' received rows as they are, with no
  zero row appended, dropped pairs at the sentinel, and gives bit for bit
  what the padded flat call form gives.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import reduced as ref_reduced
from repro.core import PlanCache as RefPlanCache
from repro.core.costmodel import LASSEN as REF_LASSEN
from repro.models import moe as ref_moe
from repro_torch.configs import get, reduced
from repro_torch.core import PlanCache
from repro_torch.core.costmodel import LASSEN
from repro_torch.kernels.moe_pack import combine, combine_lanes
from repro_torch.models import moe
from repro_torch.models.common import Mesh

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def meshes(shape, names):
    """The same mesh for both sides: ``repro``'s planner reads only
    ``axis_names`` and ``devices.shape``."""
    return (SimpleNamespace(axis_names=names, devices=np.empty(shape)),
            Mesh(names, shape))


def cfgs(full=False):
    name = "deepseek-v2-lite-16b"
    if full:
        from repro.configs import get as ref_get
        return ref_get(name), get(name)
    return (dataclasses.replace(ref_reduced(name), dtype=jnp.float32),
            dataclasses.replace(reduced(name), dtype=torch.float32))


GEOMETRIES = [((1, 1), ("data", "model")), ((1, 4), ("data", "model")),
              ((2, 4), ("pod", "model")), ((2, 2, 2), ("pod", "data", "model")),
              ((1, 8), ("data", "model"))]


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("shape,names", GEOMETRIES)
def test_plans_equal_reference(full, shape, names):
    ref_cfg, cfg = cfgs(full)
    ref_mesh, mesh = meshes(shape, names)
    for tokens in (1, 37, 256):
        for mode in ref_moe.MODES:
            for pods in (False, True):
                for cap, dedup in ((1.25, None), (8.0, 1.0), (0.5, 0.25)):
                    kw = dict(mode=mode, ep_over_pods=pods, cap_factor=cap,
                              dedup_factor=dedup)
                    want = ref_moe.make_moe_plan(ref_cfg, ref_mesh, tokens,
                                                 **kw)
                    got = moe.make_moe_plan(cfg, mesh, tokens, **kw)
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(want)


@pytest.mark.parametrize("full,tokens", [(False, 8), (False, 96),
                                         (True, 1), (True, 256)])
def test_auto_selection_and_fingerprints_equal_reference(full, tokens):
    """``moe_plan_for(mode="auto")`` under LASSEN: the same fingerprint,
    modeled times and chosen mode as ``repro``; a repeated call re-plans
    nothing."""
    ref_cfg, cfg = cfgs(full)
    ref_mesh, mesh = meshes((2, 4), ("pod", "model"))
    ref_cache, cache = RefPlanCache(), PlanCache()
    want = ref_moe.moe_plan_for(ref_cfg, ref_mesh, tokens, params=REF_LASSEN,
                                cache=ref_cache)
    got = moe.moe_plan_for(cfg, mesh, tokens, params=LASSEN, cache=cache)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    vb = cfg.d_model * cfg.dtype.itemsize
    _, want_rep = ref_moe.select_moe_mode(want, tokens, vb, REF_LASSEN)
    _, got_rep = moe.select_moe_mode(got, tokens, vb, LASSEN)
    assert got_rep.chosen == want_rep.chosen
    assert got_rep.modeled_times == pytest.approx(want_rep.modeled_times,
                                                  rel=1e-12)
    misses = cache.misses
    again = moe.moe_plan_for(cfg, mesh, tokens, params=LASSEN, cache=cache)
    assert again is got and cache.misses == misses
    with pytest.raises(ValueError, match="MachineParams"):
        moe.moe_plan_for(cfg, mesh, tokens, cache=cache)


@pytest.mark.parametrize("ties", [False, True])
def test_route_and_capacity_pack_equal_reference(ties):
    ref_cfg, cfg = cfgs()
    rng = np.random.default_rng(11)
    N, D, E = 40, cfg.d_model, cfg.n_experts
    x = rng.normal(size=(N, D)).astype(np.float32)
    w_r = rng.normal(size=(D, E)).astype(np.float32) / np.sqrt(D)
    if ties:
        # pairs of identical router columns: exactly equal probabilities;
        # rows of zeros give all-equal probabilities
        w_r[:, 1::2] = w_r[:, 0::2]
        x[::7] = 0.0
    # capacity 8 for 15 pairs an expert on average (drops), then 16 lanes
    # (two replicas of every expert)
    for shape, names, cap in (((1, 4), ("data", "model"), 0.3),
                              ((1, 16), ("data", "model"), 1.25)):
        ref_mesh, mesh = meshes(shape, names)
        plan_ref = ref_moe.make_moe_plan(ref_cfg, ref_mesh, N, mode="a2a",
                                         cap_factor=cap)
        plan = moe.make_moe_plan(cfg, mesh, N, mode="a2a", cap_factor=cap)
        phys_r, w_ref, aux_r = jax.jit(ref_moe.route, static_argnums=2)(
            jnp.asarray(x), jnp.asarray(w_r), plan_ref)
        phys, w, aux = moe.route(torch.as_tensor(x), torch.as_tensor(w_r),
                                 plan)
        np.testing.assert_array_equal(phys.numpy(), np.asarray(phys_r))
        np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), **TOL)
        assert float(aux) == pytest.approx(float(aux_r), rel=1e-5)
        want = jax.jit(ref_moe.capacity_pack, static_argnums=1)(phys_r,
                                                                plan_ref)
        got = moe.capacity_pack(phys, plan)
        for g, r in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        if cap < 1.0:
            assert not got[1].all()               # some pairs dropped
        # lane-stacked: two lanes at once give each lane's own result
        stacked = moe.route(torch.as_tensor(np.stack([x, x[::-1]])),
                            torch.as_tensor(w_r), plan)
        np.testing.assert_array_equal(stacked[0][0].numpy(), phys.numpy())
        flipped = moe.route(torch.as_tensor(x[::-1].copy()),
                            torch.as_tensor(w_r), plan)
        np.testing.assert_array_equal(stacked[0][1].numpy(),
                                      flipped[0].numpy())
        packed = moe.capacity_pack(stacked[0], plan)
        for g, one in zip(packed, moe.capacity_pack(flipped[0], plan)):
            np.testing.assert_array_equal(g[1].numpy(), one.numpy())


REFERENCE_PROGRAM = r'''
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import reduced
from repro.models.common import Initializer
from repro.models.moe import init_moe, make_moe_plan, moe_layer, moe_param_specs

assert jax.device_count() == 8
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
cfg = dataclasses.replace(reduced("deepseek-v2-lite-16b"), dtype=jnp.float32)
rng = np.random.default_rng(0)
B, S = 4, 40
x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(("pod", "data"))))
out = {"x": x}
runs = [(m, pods, 8.0, None) for m in ("dense", "a2a", "hier", "hier_dedup")
        for pods in ((False,) if m == "dense" else (False, True))]
runs += [("a2a", True, 0.5, None), ("hier_dedup", True, 1.0, 0.25)]
for mode, pods, cap, dedup in runs:
    plan = make_moe_plan(cfg, mesh, B * S // 4, mode=mode, ep_over_pods=pods,
                         cap_factor=cap, dedup_factor=dedup)
    init = Initializer(3, jnp.float32)
    params = {k: v[0] for k, v in init_moe(init, cfg, 1, plan.e_phys).items()}
    specs = {k: P(*s[1:]) for k, s in moe_param_specs(cfg, plan).items()}
    pin = {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
           for k, v in params.items() if k in specs}
    y, aux, drop, counts = jax.jit(lambda xx, pp: moe_layer(
        xx, pp, plan, cfg, mesh, ("pod", "data"),
        return_expert_counts=True))(xs, pin)
    tag = f"{mode}|{int(pods)}|{cap}|{dedup}"
    for k, v in params.items():
        out[f"{tag}|p|{k}"] = np.asarray(v)
    out[f"{tag}|y"] = np.asarray(y)
    out[f"{tag}|aux"] = np.asarray(aux)
    out[f"{tag}|drop"] = np.asarray(drop)
    out[f"{tag}|counts"] = np.asarray(counts)
np.savez(sys.argv[1], **out)
'''


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe") / "runs.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, "-c", REFERENCE_PROGRAM, str(path)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as f:
        return dict(f)


def test_moe_layer_matches_reference_in_every_mode(reference_runs):
    _ref_cfg, cfg = cfgs()
    mesh = Mesh(("pod", "data", "model"), (2, 2, 2))
    x = torch.as_tensor(reference_runs["x"])
    B, S = x.shape[:2]
    tags = sorted({k.rsplit("|", 1)[0] for k in reference_runs
                   if k.endswith("|y")})
    assert len(tags) == 9
    ys = {}
    cache = PlanCache()
    for tag in tags:
        mode, pods, cap, dedup = tag.split("|")
        plan = moe.make_moe_plan(
            cfg, mesh, B * S // 4, mode=mode, ep_over_pods=bool(int(pods)),
            cap_factor=float(cap),
            dedup_factor=None if dedup == "None" else float(dedup))
        params = {k.rsplit("|", 1)[1]: torch.as_tensor(v)
                  for k, v in reference_runs.items()
                  if k.startswith(f"{tag}|p|")}
        for _ in range(2):         # the second call hits the cached executor
            y, aux, drop, counts = moe.moe_layer(
                x, params, plan, cfg, mesh, ("pod", "data"), cache=cache,
                return_expert_counts=True)
        np.testing.assert_allclose(y.numpy(), reference_runs[f"{tag}|y"],
                                   **TOL)
        assert float(aux) == pytest.approx(
            float(reference_runs[f"{tag}|aux"]), rel=1e-5)
        assert float(drop) == pytest.approx(
            float(reference_runs[f"{tag}|drop"]), abs=1e-7)
        np.testing.assert_array_equal(counts.numpy(),
                                      reference_runs[f"{tag}|counts"])
        if float(cap) == 8.0:
            assert float(drop) == 0.0
            ys[tag] = y
        else:
            assert float(drop) > 0.0
    assert cache.exec_hits == len(tags) and cache.exec_misses == len(tags)
    # ample capacity: every transport computes the same function
    base = ys["a2a|0|8.0|None"]
    for tag, y in ys.items():
        np.testing.assert_allclose(y.numpy(), base.numpy(), **TOL)


@pytest.mark.parametrize("tag", ["a2a|1|0.5|None", "hier_dedup|1|1.0|0.25",
                                 "hier|0|8.0|None"])
def test_combine_takes_the_received_rows_without_a_pad_row(
        reference_runs, monkeypatch, tag):
    """Every K6 call of the layer: buf is the lanes' [G, e_phys * capacity,
    D] received rows, its indices in [0, e_phys * capacity] with the
    capacity-starved runs' dropped pairs at the sentinel; the output equals
    the earlier call form's (a zero row appended to each lane, indices
    offset into the flat table) bit for bit."""
    _ref_cfg, cfg = cfgs()
    mesh = Mesh(("pod", "data", "model"), (2, 2, 2))
    x = torch.as_tensor(reference_runs["x"])
    B, S = x.shape[:2]
    mode, pods, cap, dedup = tag.split("|")
    plan = moe.make_moe_plan(
        cfg, mesh, B * S // 4, mode=mode, ep_over_pods=bool(int(pods)),
        cap_factor=float(cap),
        dedup_factor=None if dedup == "None" else float(dedup))
    params = {k.rsplit("|", 1)[1]: torch.as_tensor(v)
              for k, v in reference_runs.items() if k.startswith(f"{tag}|p|")}
    calls = []

    def record(buf, idx, w):
        calls.append((buf, idx, w))
        return combine_lanes(buf, idx, w)

    monkeypatch.setattr(moe, "pack_combine_lanes", record)
    y = moe.moe_layer(x, params, plan, cfg, mesh, ("pod", "data"))[0]
    np.testing.assert_allclose(y.numpy(), reference_runs[f"{tag}|y"], **TOL)
    EC = plan.e_phys * plan.capacity
    assert len(calls) == 1
    buf, idx, w = calls[0]
    G, N, K = idx.shape
    assert buf.shape == (mesh.size, EC, cfg.d_model)
    assert int(idx.min()) >= 0 and int(idx.max()) <= EC
    # expert-capacity drops only at cap_factor 0.5 (hier_dedup's at 1.0
    # are unique-slot drops: their pairs keep an expert slot, which
    # receives a zero row)
    assert bool((idx == EC).any()) == (float(cap) < 1.0)
    padded = torch.cat([buf, buf.new_zeros((G, 1, buf.shape[2]))], 1)
    flat = idx + (EC + 1) * torch.arange(G)[:, None, None]
    want = combine(padded.reshape(G * (EC + 1), -1), flat.reshape(-1, K),
                   w.reshape(-1, K))
    assert torch.equal(combine_lanes(buf, idx, w), want.reshape(G, N, -1))


def test_a2a_permutes_lanes_like_all_to_all():
    """Over one axis, lane g's chunk j lands in lane j's chunk g; over two
    axes the group index is row-major in the order given."""
    mesh = Mesh(("pod", "model"), (2, 3))
    G = mesh.size
    t = torch.arange(G * G * 2).reshape(G, G * 2, 1)
    out = moe._a2a(t, mesh, ("pod", "model"), 0)
    for g in range(G):
        for j in range(G):
            assert torch.equal(out[j, 2 * g:2 * g + 2], t[g, 2 * j:2 * j + 2])
    t = torch.arange(G * 2 * 3).reshape(G, 2, 3, 1)
    out = moe._a2a(t, mesh, ("model",), 1)       # within each pod
    for p in range(2):
        for m in range(3):
            for j in range(3):
                assert torch.equal(out[p * 3 + j, :, m], t[p * 3 + m, :, j])
