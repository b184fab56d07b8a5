"""The port's adaptive serve engine against ``repro``'s, in float32.

The reduced DeepSeek-V2-Lite config (the port serves the moe family with
MLA; ``tests/test_adaptive_replan.py`` uses the reduced mixtral, which the
port does not run), with that test's engine settings: ``moe_mode="auto"``,
``moe_cap_factor=8.0``, 2 slots, ``max_len=96``, drift threshold 0.3,
warmup 2, one lane.  ``repro``'s engine runs in-process on one device; its
weights are carried over (``from_reference_params``), and ``repro``'s
``TPU_V5E`` is the machine model on both sides.

* Steady decode makes no new plan-cache or executor misses and no event.
* A zeroed router (ties go to the lower expert ids) gives exactly one
  event on each side, equal to ``repro``'s (step, modes, fingerprints;
  drift within 1e-12), and none after.
* The greedy tokens are equal on both sides at every step (the logits
  agree within ``tests/test_torch_serve.py``'s 2e-3, far inside the
  margins of these tokens).
* ``decode_step(return_moe_stats=True)``'s expert counts and drop fraction
  equal ``repro``'s.
* ``_refit`` on a synthetic trace sets ``machine_params`` and the
  planner's params, and records a ``RefitEvent``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import reduced as ref_reduced
from repro.core.costmodel import TPU_V5E
from repro.models import Model as RefModel
from repro.models import serving as ref_serving
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import reduced
from repro_torch.core import Topology
from repro_torch.models import Model, serving
from repro_torch.models.convert import from_reference_params
from repro_torch.obs import default_obs
from repro_torch.profile import probe_plans, synthesize_trace
from repro_torch.serve import Request, ServeEngine

NAME = "deepseek-v2-lite-16b"
ENGINE = dict(batch_slots=2, max_len=96, adaptive=True, drift_threshold=0.3,
              drift_warmup=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    ref_cfg = dataclasses.replace(ref_reduced(NAME), dtype=jnp.float32)
    cfg = dataclasses.replace(reduced(NAME), dtype=torch.float32)
    ref_model = RefModel(ref_cfg, moe_mode="auto", remat=False,
                         moe_cap_factor=8.0)
    ref_params = jax.jit(lambda: ref_model.init_params(seed=0))()
    model = Model(cfg, moe_mode="auto", moe_cap_factor=8.0,
                  machine_params=TPU_V5E, device="cpu")
    return ref_model, ref_params, model


def engines(pair):
    """Both engines on the same weights, each with the same request
    admitted and prefilled."""
    ref_model, ref_params, model = pair
    ref_params = dict(ref_params, blocks=dict(
        ref_params["blocks"], moe=dict(ref_params["blocks"]["moe"])))
    params = from_reference_params(jax.device_get(ref_params), device="cpu")
    ref_eng = RefServeEngine(ref_model, ref_params, **ENGINE)
    eng = ServeEngine(model, params, **ENGINE)
    prompt = np.random.default_rng(1).integers(
        0, model.cfg.vocab, size=(4,)).astype(np.int32)
    ref_eng.submit(RefRequest(rid=0, prompt=prompt, max_new_tokens=64))
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=64))
    ref_eng.step()
    eng.step()
    return ref_eng, eng


def steps(ref_eng, eng, n):
    for _ in range(n):
        ref_eng.step()
        eng.step()
        assert eng.slots[0].generated == ref_eng.slots[0].generated


def test_engine_replans_once_like_reference(pair):
    ref_eng, eng = engines(pair)
    steps(ref_eng, eng, 8)
    cache = eng.plan_cache
    m0, e0 = cache.misses, cache.exec_misses
    steps(ref_eng, eng, 4)
    assert (cache.misses, cache.exec_misses) == (m0, e0)
    assert eng.replan_events == [] == ref_eng.replan_events
    assert eng.planner.observed == ref_eng.planner.observed >= 12

    p = ref_eng.params
    p["blocks"]["moe"]["router"] = jnp.zeros_like(p["blocks"]["moe"]["router"])
    eng.params["blocks"]["moe"]["router"].zero_()
    steps(ref_eng, eng, 24)
    assert len(eng.replan_events) == 1 == len(ref_eng.replan_events)
    got, want = eng.replan_events[0], ref_eng.replan_events[0]
    assert got.drift > 0.3 and abs(got.drift - want.drift) <= 1e-12
    assert (got.step, got.old_mode, got.new_mode) == (
        want.step, want.old_mode, want.new_mode)
    assert (got.old_fingerprint, got.new_fingerprint) == (
        want.old_fingerprint, want.new_fingerprint)
    assert eng.moe_plan is eng.planner.plan
    assert eng.moe_plan.mode in ("a2a", "hier", "hier_dedup")
    m1 = cache.misses
    steps(ref_eng, eng, 4)
    assert len(eng.replan_events) == 1 and cache.misses == m1
    assert eng.verify() == ref_eng.verify() == {"moe_plans": 2}


def test_decode_moe_stats_equal_reference(pair):
    ref_model, ref_params, model = pair
    params = from_reference_params(jax.device_get(ref_params), device="cpu")
    toks = np.random.default_rng(5).integers(
        0, model.cfg.vocab, size=(2, 6)).astype(np.int32)
    _, ref_caches = jax.jit(lambda p, i: ref_serving.prefill(
        ref_model, p, i, max_len=16))(ref_params,
                                      {"tokens": jnp.asarray(toks)})
    _, caches = serving.prefill(model, params,
                                {"tokens": torch.as_tensor(toks)},
                                max_len=16)
    new = toks[:, -1:]
    want_logits, _, want = jax.jit(lambda p, i, c: ref_serving.decode_step(
        ref_model, p, i, c, 6, return_moe_stats=True))(
        ref_params, {"tokens": jnp.asarray(new)}, ref_caches)
    plan = serving.moe_plan_for_model(model, 2)
    got_logits, _, got = serving.decode_step(
        model, params, {"tokens": torch.as_tensor(new)}, caches, 6,
        moe_plan=plan, return_moe_stats=True)
    np.testing.assert_array_equal(got["expert_counts"].numpy(),
                                  np.asarray(want["expert_counts"]))
    assert float(got["dropped"]) == float(want["dropped"])
    assert float(got["expert_counts"].sum()) == \
        2 * model.cfg.top_k * (model.cfg.n_layers
                               - model.cfg.first_dense_layers)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=2e-3, atol=2e-3)


def test_refit_sets_machine_params_and_planner(pair):
    _ref_model, ref_params, model = pair
    params = from_reference_params(jax.device_get(ref_params), device="cpu")
    obs = default_obs()
    trace = synthesize_trace(probe_plans(Topology(4, 2), n_per=64),
                             TPU_V5E)
    try:
        eng = ServeEngine(model, params, batch_slots=2, max_len=32,
                          adaptive=True, tracer=trace, observe=True,
                          refit_every=4)
        assert obs.enabled and obs.tracer is trace
        event = eng._refit()
        assert event is not None and eng.refit_events == [event]
        assert eng.machine_params is eng.planner.params
        assert eng.machine_params.name == event.params_name == "online-refit"
        # the probe's own sample joined the synthetic ones in the fit
        assert event.n_samples >= 1 and np.isfinite(event.rel_rmse)
        # the last serve event is the refit's, and its span says it fitted
        # (counter samples of earlier tests' metrics may follow the span)
        assert [e.name for e in obs.spans.events(kind="instant")
                if e.name.startswith("serve/")][-1] == "serve/refit"
        refit_spans = [e for e in obs.spans.events(kind="span")
                       if e.name == "serve/refit"]
        assert refit_spans and refit_spans[-1].attrs["fitted"] is True
    finally:
        obs.disable()
        obs.attach_tracer(None)
        obs.reset()
