"""The port's SSM and hybrid serving paths against ``repro``'s at the reduced
``zamba2-7b`` (hybrid: Mamba-2 layers and shared GQA attention blocks) and
``mamba2-780m`` (ssm) configs in float32.

``repro``'s ``Model`` draws the weights; :func:`from_reference_params`
carries them over.  Forward, prefill and decode logits agree within the
reference's own 2e-3 (``tests/test_models_smoke.py``), the port's
``ServeEngine`` gives ``repro``'s greedy tokens on the same requests, and
the parameter trees are equal.  The GQA cache path is held against
``repro``'s directly: ``_decode_attn``'s roll branch (a full cache) and
``gqa_attention`` with a cache.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import reduced as ref_reduced
from repro.models import Model as RefModel
from repro.models import attention as ref_attention
from repro.models import serving as ref_serving
from repro.models import ssm as ref_ssm
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import reduced
from repro_torch.models import Model, attention, serving, ssm
from repro_torch.models.convert import from_reference_params
from repro_torch.serve import Request, ServeEngine

TOL = dict(rtol=2e-3, atol=2e-3)
B, T, MAX_LEN = 2, 12, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_pair(name, **overrides):
    ref_cfg = dataclasses.replace(ref_reduced(name), dtype=jnp.float32,
                                  **overrides)
    cfg = dataclasses.replace(reduced(name), dtype=torch.float32, **overrides)
    ref_model = RefModel(ref_cfg, remat=False)
    ref_params = jax.jit(lambda: ref_model.init_params(seed=2))()
    model = Model(cfg, device="cpu")
    params = from_reference_params(jax.device_get(ref_params), device="cpu")
    return ref_model, ref_params, model, params


@pytest.fixture(scope="module", params=["zamba2-7b", "mamba2-780m"])
def pair(request):
    return make_pair(request.param)


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(
        np.int32)


def assert_close_tree(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_close_tree(got[k], want[k])
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_prefill_decode_match_reference(pair):
    ref_model, ref_params, model, params = pair
    V = model.cfg.vocab
    toks = tokens(0, (B, T), V)
    want, _ = jax.jit(ref_model.forward)(ref_params,
                                         {"tokens": jnp.asarray(toks)})
    got, aux = model.forward(params, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == 0.0

    want_last, ref_caches = jax.jit(lambda p, i: ref_serving.prefill(
        ref_model, p, i, max_len=MAX_LEN))(ref_params,
                                           {"tokens": jnp.asarray(toks)})
    got_last, caches = serving.prefill(
        model, params, {"tokens": torch.as_tensor(toks)}, max_len=MAX_LEN)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last), **TOL)
    np.testing.assert_allclose(got_last.numpy(), got[:, -1].numpy(), **TOL)
    assert len(caches) == len(ref_caches)
    for c, rc in zip(caches, ref_caches):
        assert_close_tree(c, rc)

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
    assert eng.moe_plan is None and eng.moe_prefill_plan is None
    for i, (p, n) in enumerate(zip(prompts, new)):
        ref_eng.submit(RefRequest(rid=i, prompt=p, max_new_tokens=n))
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=n))
    want = {r.rid: r.generated for r in ref_eng.run_until_drained(200)}
    got = {r.rid: r.generated for r in eng.run_until_drained(200)}
    assert got == want and len(got) == 3
    assert all(len(got[i]) == n for i, n in enumerate(new))


def test_init_params_match_reference_tree(pair):
    """The port's seeded on-device init builds ``repro``'s parameter tree:
    the same names, shapes and dtypes (its numbers differ)."""
    ref_model, _ref_params, model, _params = pair
    want = jax.tree_util.tree_flatten_with_path(
        ref_model.init_params(seed=0, abstract=True))[0]
    got = model.init_params(seed=0)

    def leaf(tree, path):
        for k in path:
            tree = tree[k.key]
        return tree

    n_got = len(jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: 0, got)))
    assert n_got == len(want)
    for path, sds in want:
        t = leaf(got, path)
        assert tuple(t.shape) == sds.shape
        assert str(t.dtype).split(".")[-1] == str(sds.dtype)


def test_mamba_decode_from_initial_state_matches_reference(pair):
    """One Mamba-2 layer decoding a token from ``init_mamba_state``."""
    ref_model, ref_params, model, params = pair
    cfg = model.cfg
    key = "blocks" if cfg.family == "ssm" else "mamba_main"
    p = {k: v[0] for k, v in params[key].items()}
    ref_p = {k: v[0] for k, v in ref_params[key].items()}
    x = np.random.default_rng(7).normal(size=(B, 1, cfg.d_model)).astype(
        np.float32)
    want, want_st = ref_ssm.mamba_block(
        ref_p, jnp.asarray(x), ref_model.cfg,
        state=ref_ssm.init_mamba_state(ref_model.cfg, B, jnp.float32))
    state = ssm.init_mamba_state(cfg, B, torch.float32)
    assert {k: (tuple(v.shape), v.dtype) for k, v in state.items()} == {
        "conv": ((B, cfg.d_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
                 torch.float32),
        "ssm": ((B, cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                torch.float32)}
    got, got_st = ssm.mamba_block(p, torch.as_tensor(x), cfg, state=state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_close_tree(got_st, want_st)


def test_hybrid_without_tail_layers():
    """A layer count that the shared-attention period divides leaves
    ``mamba_tail`` empty ({}): the weights carry over with it and the
    forward matches."""
    ref_model, ref_params, model, params = make_pair("zamba2-7b", n_layers=4)
    assert params["mamba_tail"] == {} and ref_params["mamba_tail"] == {}
    assert model.init_params(seed=0)["mamba_tail"] == {}
    toks = tokens(3, (B, T), model.cfg.vocab)
    want, _ = jax.jit(ref_model.forward)(ref_params,
                                         {"tokens": jnp.asarray(toks)})
    got, _ = model.forward(params, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def gqa_inputs(cfg, seed, Lc, filled):
    rng = np.random.default_rng(seed)
    dh = cfg.head_dim
    d_in = 2 * cfg.d_model
    p = {"wq": rng.normal(size=(d_in, cfg.n_heads * dh)) / np.sqrt(d_in),
         "wk": rng.normal(size=(d_in, cfg.n_kv_heads * dh)) / np.sqrt(d_in),
         "wv": rng.normal(size=(d_in, cfg.n_kv_heads * dh)) / np.sqrt(d_in),
         "wo": rng.normal(size=(cfg.n_heads * dh, cfg.d_model))
         / np.sqrt(cfg.n_heads * dh)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(B, 1, d_in)).astype(np.float32)
    k = rng.normal(size=(B, cfg.n_kv_heads, Lc, dh)).astype(np.float32)
    v = rng.normal(size=(B, cfg.n_kv_heads, Lc, dh)).astype(np.float32)
    k[:, :, filled:] = 0.0
    v[:, :, filled:] = 0.0
    return p, x, k, v


@pytest.mark.parametrize("cur", [5, 8, 11])
def test_decode_attn_append_and_roll_match_reference(cur):
    """An 8-slot cache: ``cur`` 5 appends, 8 and 11 roll (``cur >= Lc``)."""
    ref_cfg = dataclasses.replace(ref_reduced("zamba2-7b"), dtype=jnp.float32)
    cfg = dataclasses.replace(reduced("zamba2-7b"), dtype=torch.float32)
    Lc = 8
    p, x, k, v = gqa_inputs(cfg, cur, Lc, min(cur, Lc))
    want, want_c = ref_serving._decode_attn(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
        jnp.asarray(cur, jnp.int32), ref_cfg, 0,
        {"k": jnp.asarray(k), "v": jnp.asarray(v)})
    ck, cv = torch.as_tensor(k.copy()), torch.as_tensor(v.copy())
    got, got_c = serving._decode_attn(
        {n: torch.as_tensor(a) for n, a in p.items()}, torch.as_tensor(x),
        cur, cfg, 0, {"k": ck, "v": cv})
    assert got_c["k"] is ck and got_c["v"] is cv        # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(got_c[name].numpy(),
                                   np.asarray(want_c[name]), **TOL)


def test_gqa_attention_with_cache_matches_reference():
    ref_cfg = dataclasses.replace(ref_reduced("zamba2-7b"), dtype=jnp.float32)
    cfg = dataclasses.replace(reduced("zamba2-7b"), dtype=torch.float32)
    rng = np.random.default_rng(5)
    d, dh, H = cfg.d_model, cfg.head_dim, cfg.n_heads
    p = {"wq": rng.normal(size=(d, H * dh)), "wk": rng.normal(size=(d, H * dh)),
         "wv": rng.normal(size=(d, H * dh)), "wo": rng.normal(size=(H * dh, d))}
    p = {k: (v / np.sqrt(v.shape[0])).astype(np.float32) for k, v in p.items()}
    Tn, S, start = 3, 16, 6
    x = rng.normal(size=(B, Tn, d)).astype(np.float32)
    pos = np.broadcast_to(start + np.arange(Tn, dtype=np.int32), (B, Tn))
    ck = rng.normal(size=(B, H, S, dh)).astype(np.float32)
    cv = rng.normal(size=(B, H, S, dh)).astype(np.float32)
    want, (wk, wv) = ref_attention.gqa_attention(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
        jnp.asarray(pos), ref_cfg, cache=(jnp.asarray(ck), jnp.asarray(cv)),
        kv_len=start)
    got, (gk, gv) = attention.gqa_attention(
        {n: torch.as_tensor(a) for n, a in p.items()}, torch.as_tensor(x),
        torch.as_tensor(pos.copy()), cfg,
        cache=(torch.as_tensor(ck.copy()), torch.as_tensor(cv.copy())),
        kv_len=start)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **TOL)
    # without a cache: causal over its own tokens
    want, _ = ref_attention.gqa_attention(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
        jnp.asarray(pos), ref_cfg)
    got, none = attention.gqa_attention(
        {n: torch.as_tensor(a) for n, a in p.items()}, torch.as_tensor(x),
        torch.as_tensor(pos.copy()), cfg)
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
