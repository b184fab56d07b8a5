"""The port's MoE serving path against ``repro``'s at the reduced
DeepSeek-V2-Lite config in float32.

``repro``'s ``Model`` (one lane, in-process, ``moe_cap_factor=8.0``, so no
capacity drops) draws the weights; :func:`from_reference_params` carries
them over.  Forward, prefill and decode logits agree within the
reference's own 2e-3 (``tests/test_models_smoke.py``), and the port's
``ServeEngine`` gives ``repro``'s greedy tokens on the same requests.  On
the port's side alone, the same model with its dispatch spread over
8 lanes (2 pods x 4) computes the same logits in every transport.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import reduced as ref_reduced
from repro.models import Model as RefModel
from repro.models import serving as ref_serving
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import reduced
from repro_torch.core.costmodel import LASSEN
from repro_torch.models import Mesh, Model, serving
from repro_torch.models.convert import from_reference_params
from repro_torch.serve import Request, ServeEngine

TOL = dict(rtol=2e-3, atol=2e-3)
NAME = "deepseek-v2-lite-16b"
B, T, MAX_LEN = 2, 12, 32


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
    ref_model = RefModel(ref_cfg, moe_mode="a2a", remat=False,
                         moe_cap_factor=8.0)
    ref_params = jax.jit(lambda: ref_model.init_params(seed=2))()
    model = Model(cfg, moe_mode="a2a", moe_cap_factor=8.0, device="cpu")
    params = from_reference_params(jax.device_get(ref_params), device="cpu")
    return ref_model, ref_params, model, params


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(
        np.int32)


def test_forward_prefill_decode_match_reference(pair):
    ref_model, ref_params, model, params = pair
    V = model.cfg.vocab
    toks = tokens(0, (B, T), V)
    want, _ = jax.jit(ref_model.forward)(ref_params,
                                         {"tokens": jnp.asarray(toks)})
    got, aux = model.forward(params, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.isfinite(aux)

    want_last, ref_caches = jax.jit(lambda p, i: ref_serving.prefill(
        ref_model, p, i, max_len=MAX_LEN))(ref_params,
                                           {"tokens": jnp.asarray(toks)})
    got_last, caches = serving.prefill(
        model, params, {"tokens": torch.as_tensor(toks)}, max_len=MAX_LEN)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last), **TOL)
    np.testing.assert_allclose(got_last.numpy(), got[:, -1].numpy(), **TOL)
    for c, rc in zip(caches, ref_caches):
        np.testing.assert_allclose(c["ckv"].numpy(), np.asarray(rc["ckv"]),
                                   **TOL)

    new = tokens(9, (B, 1), V)
    want_step, _ = jax.jit(lambda p, i, c: ref_serving.decode_step(
        ref_model, p, i, c, cur_len=T))(ref_params,
                                        {"tokens": jnp.asarray(new)},
                                        ref_caches)
    got_step, _ = serving.decode_step(
        model, params, {"tokens": torch.as_tensor(new)}, caches, cur_len=T)
    np.testing.assert_allclose(got_step.numpy(), np.asarray(want_step), **TOL)


def test_engine_gives_reference_greedy_tokens(pair):
    ref_model, ref_params, model, params = pair
    V = model.cfg.vocab
    prompts = [tokens(10 + i, (4 + 3 * i,), V) for i in range(3)]
    new = [3, 5, 4]
    ref_eng = RefServeEngine(ref_model, ref_params, batch_slots=2,
                             max_len=MAX_LEN)
    eng = ServeEngine(model, params, batch_slots=2, max_len=MAX_LEN)
    for i, (p, n) in enumerate(zip(prompts, new)):
        ref_eng.submit(RefRequest(rid=i, prompt=p, max_new_tokens=n))
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=n))
    want = {r.rid: r.generated for r in ref_eng.run_until_drained(200)}
    cache = eng.plan_cache
    got = {r.rid: r.generated for r in eng.run_until_drained(200)}
    assert got == want and len(got) == 3
    assert all(len(got[i]) == n for i, n in enumerate(new))
    # the decode and worst-case prefill plans were warmed at construction
    misses = cache.misses
    eng.submit(Request(rid=9, prompt=prompts[0], max_new_tokens=2))
    eng.run_until_drained(50)
    assert cache.misses == misses


@pytest.mark.parametrize("mode", ["a2a", "hier", "hier_dedup", "dense",
                                  "auto"])
def test_lane_stacked_dispatch_matches_one_lane(pair, mode):
    _ref_model, _ref_params, one_lane, params = pair
    model = Model(one_lane.cfg, mesh=Mesh(("pod", "model"), (2, 4)),
                  moe_mode=mode, moe_cap_factor=8.0, machine_params=LASSEN,
                  device="cpu")
    assert model.e_phys == one_lane.e_phys
    toks = torch.as_tensor(tokens(1, (B, T), model.cfg.vocab))
    want, _ = one_lane.forward(params, {"tokens": toks})
    got, _ = model.forward(params, {"tokens": toks})
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_init_params_match_reference_tree(pair):
    """The port's seeded on-device init builds ``repro``'s parameter tree:
    the same names, shapes and dtypes (its numbers differ), each tensor a
    truncated normal at the reference's fan-in scale."""
    ref_model, _ref_params, model, _params = pair
    want = jax.tree_util.tree_flatten_with_path(
        ref_model.init_params(seed=0, abstract=True))[0]
    got = model.init_params(seed=0)

    def leaf(tree, path):
        for k in path:
            tree = tree[k.key]
        return tree

    assert len(want) == sum(1 for _ in jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: 0, got)))
    for path, sds in want:
        t = leaf(got, path)
        assert tuple(t.shape) == sds.shape
        assert str(t.dtype).split(".")[-1] == str(sds.dtype)
    wq = got["blocks"]["attn"]["wq"]
    assert float(wq.abs().max()) <= 2.0 / model.cfg.d_model ** 0.5 + 1e-6
    assert 0.8 < float(wq.std()) * model.cfg.d_model ** 0.5 < 0.95
    assert not got["final_norm"].any()
