"""The port's dense and vlm families against ``repro``'s in float32.

The reduced ``qwen2-0.5b`` (QKV bias, GQA group 2, tied embeddings),
``qwen1.5-0.5b`` (bias, MHA), ``gemma3-1b`` (qk-norm, sandwich norms,
gelu, 5 local layers at window 16 : 1 global), ``nemotron-4-15b``
(squared ReLU, ungated MLP, partial rotary) and ``qwen2-vl-2b`` (M-RoPE
over ``[B, 3, T]`` positions, precomputed embeddings).  ``repro``'s
``Model`` draws the weights, every zero-initialized leaf (norms, biases)
is then drawn at random so that it counts, and
:func:`from_reference_params` carries the tree over.  Forward, prefill and
decode logits agree within the reference's 2e-3
(``tests/test_models_smoke.py``); gemma3's prompts are longer than its
window, so every decode step rolls its local caches.  ``gqa_project_qkv``
is held directly with bias, qk-norm and M-RoPE; the port's ``ServeEngine``
gives ``repro``'s greedy tokens on ``tests/test_serve_engine.py``'s
requests; parameter counts and trees equal ``repro``'s.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.models import Model as RefModel
from repro.models import attention as ref_attention
from repro.models import common as ref_common
from repro.models import serving as ref_serving
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefServeEngine
from repro_torch import configs
from repro_torch.models import Model, attention, serving
from repro_torch.models import common
from repro_torch.models.convert import from_reference_params
from repro_torch.serve import Request, ServeEngine

TOL = dict(rtol=2e-3, atol=2e-3)
DENSE = ["qwen2-0.5b", "qwen1.5-0.5b", "gemma3-1b", "nemotron-4-15b",
         "qwen2-vl-2b"]
B, MAX_LEN, STEPS = 2, 48, 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def drawn_zero_leaves(tree, seed: int):
    """``tree`` (numpy leaves) with every all-zero float leaf drawn from a
    normal of scale 0.2, so the norms' and biases' weights count."""
    rng = np.random.default_rng(seed)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(x[k]) for k in sorted(x)}
        a = np.asarray(x)
        if a.dtype.kind == "f" and not a.any():
            return (0.2 * rng.normal(size=a.shape)).astype(a.dtype)
        return a

    return walk(tree)


def make_pair(name):
    ref_cfg = dataclasses.replace(ref_configs.reduced(name),
                                  dtype=jnp.float32)
    cfg = dataclasses.replace(configs.reduced(name), dtype=torch.float32)
    ref_model = RefModel(ref_cfg, remat=False)
    host = drawn_zero_leaves(
        jax.device_get(jax.jit(lambda: ref_model.init_params(seed=2))()), 5)
    ref_params = jax.tree.map(jnp.asarray, host)
    model = Model(cfg, device="cpu")
    return ref_model, ref_params, model, from_reference_params(host, "cpu")


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    return make_pair(request.param)


def prompt_len(cfg) -> int:
    """Longer than a window layer's cache, so prefill keeps its last
    ``window`` tokens and every decode step rolls it."""
    return max(12, cfg.window + 8)


def inputs_for(cfg, T: int, seed: int):
    """(repro's inputs, the port's): token ids, or for the vlm embeddings
    with M-RoPE positions whose three rows differ."""
    rng = np.random.default_rng(seed)
    if cfg.family != "vlm":
        toks = rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32)
        return {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks)}
    emb = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    base = np.arange(T, dtype=np.int32)
    pos = np.stack([base, base // 3, base % 5 + 2 * base // 7])
    pos = np.broadcast_to(pos, (B, 3, T)).copy()
    return ({"embeds": jnp.asarray(emb), "positions": jnp.asarray(pos)},
            {"embeds": torch.as_tensor(emb), "positions": torch.as_tensor(pos)})


def assert_close_tree(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_close_tree(got[k], want[k])
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_windows_are_the_reference_schedule(pair):
    ref_model, _, model, _ = pair
    assert model.windows == [int(w) for w in ref_model.windows]
    if model.cfg.local_global_period:
        assert model.windows.count(0) == \
            model.cfg.n_layers // model.cfg.local_global_period


def test_forward_prefill_decode_match_reference(pair):
    ref_model, ref_params, model, params = pair
    cfg = model.cfg
    T = prompt_len(cfg)
    ref_in, got_in = inputs_for(cfg, T, 0)
    want, _ = jax.jit(ref_model.forward)(ref_params, ref_in)
    got, aux = model.forward(params, got_in)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == 0.0

    want_last, ref_caches = jax.jit(lambda p, i: ref_serving.prefill(
        ref_model, p, i, max_len=MAX_LEN))(ref_params, ref_in)
    got_last, caches = serving.prefill(model, params, got_in,
                                       max_len=MAX_LEN)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               **TOL)
    np.testing.assert_allclose(got_last.numpy(), got[:, -1].numpy(), **TOL)
    assert len(caches) == len(ref_caches) == cfg.n_layers
    for c, rc, w in zip(caches, ref_caches, model.windows):
        assert c["k"].shape[2] == (w or MAX_LEN)
        assert_close_tree(c, rc)

    step = jax.jit(lambda p, i, c, n: ref_serving.decode_step(
        ref_model, p, i, c, cur_len=n))
    for s in range(STEPS):
        ref_new, new = inputs_for(cfg, 1, 10 + s)
        ref_new.pop("positions", None)
        new.pop("positions", None)
        want_step, ref_caches = step(ref_params, ref_new, ref_caches, T + s)
        got_step, caches = serving.decode_step(model, params, new, caches,
                                               cur_len=T + s)
        np.testing.assert_allclose(got_step.numpy(), np.asarray(want_step),
                                   **TOL)
    for c, rc in zip(caches, ref_caches):
        assert_close_tree(c, rc)


def qkv_inputs(cfg, seed: int, T: int = 7):
    rng = np.random.default_rng(seed)
    dh, d = cfg.head_dim, cfg.d_model
    p = {"wq": rng.normal(size=(d, cfg.n_heads * dh)) / np.sqrt(d),
         "wk": rng.normal(size=(d, cfg.n_kv_heads * dh)) / np.sqrt(d),
         "wv": rng.normal(size=(d, cfg.n_kv_heads * dh)) / np.sqrt(d),
         "wo": rng.normal(size=(cfg.n_heads * dh, d)) / np.sqrt(cfg.n_heads
                                                                * dh),
         "bq": rng.normal(size=(cfg.n_heads * dh,)),
         "bk": rng.normal(size=(cfg.n_kv_heads * dh,)),
         "bv": rng.normal(size=(cfg.n_kv_heads * dh,)),
         "q_norm": 0.3 * rng.normal(size=(dh,)),
         "k_norm": 0.3 * rng.normal(size=(dh,))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(B, T, d)).astype(np.float32)
    if cfg.mrope_sections is not None:
        base = np.arange(T, dtype=np.int32) + 5
        pos = np.broadcast_to(np.stack([base, 2 * base, base // 2]),
                              (B, 3, T)).copy()
    else:
        pos = np.broadcast_to(np.arange(T, dtype=np.int32) + 3,
                              (B, T)).copy()
    return p, x, pos


@pytest.mark.parametrize("variant", ["qkv_bias", "qk_norm", "mrope",
                                     "all three"])
def test_gqa_project_qkv_matches_reference(variant):
    """Bias before the head split, the per-head RMS norm before the rope,
    M-RoPE sections over positions whose three rows differ."""
    base = dict(name="t", family="dense", n_layers=1, d_model=48, n_heads=6,
                n_kv_heads=2, d_ff=64, vocab=32, d_head=16)
    opts = {"qkv_bias": dict(qkv_bias=True),
            "qk_norm": dict(qk_norm=True),
            "mrope": dict(mrope_sections=(2, 3, 3)),
            "all three": dict(qkv_bias=True, qk_norm=True,
                              mrope_sections=(4, 2, 2))}[variant]
    cfg = common.ArchConfig(**base, **opts, dtype=torch.float32)
    ref_cfg = ref_common.ArchConfig(**base, **opts, dtype=jnp.float32)
    p, x, pos = qkv_inputs(cfg, 3)
    want = ref_attention.gqa_project_qkv(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(pos), ref_cfg)
    got = attention.gqa_project_qkv(
        {k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(x),
        torch.as_tensor(pos), cfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    # the whole attention, K7's plain version included
    want_o, _ = ref_attention.gqa_attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(pos), ref_cfg, window=4)
    got_o, _ = attention.gqa_attention(
        {k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(x),
        torch.as_tensor(pos), cfg, window=4)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)


def test_apply_mrope_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 5, 16)).astype(np.float32)
    pos = rng.integers(0, 50, size=(2, 3, 5)).astype(np.int32)
    want = ref_common.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                                  (2, 3, 3))
    got = common.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), 1e6,
                             (2, 3, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_cross_attention_raises():
    cfg = dataclasses.replace(configs.reduced("qwen2-0.5b"),
                              dtype=torch.float32)
    p, x, pos = qkv_inputs(cfg, 1)
    p = {k: torch.as_tensor(v) for k, v in p.items()}
    x = torch.as_tensor(x)
    with pytest.raises(NotImplementedError, match="kv_x"):
        attention.gqa_attention(p, x, torch.as_tensor(pos), cfg, kv_x=x)


@pytest.mark.parametrize("name", DENSE)
def test_engine_gives_reference_greedy_tokens(name):
    """``tests/test_serve_engine.py``'s requests: two slots, four requests,
    slots recycled and the batch re-prefilled."""
    ref_model, ref_params, model, params = make_pair(name)
    V = model.cfg.vocab
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, V, size=(4 + i,)).astype(np.int32), 3 + i % 2)
            for i in range(4)]
    ref_eng = RefServeEngine(ref_model, ref_params, batch_slots=2,
                             max_len=64)
    eng = ServeEngine(model, params, batch_slots=2, max_len=64)
    assert eng.moe_plan is None and eng.moe_prefill_plan is None
    for i, (p, n) in enumerate(reqs):
        ref_eng.submit(RefRequest(rid=i, prompt=p, max_new_tokens=n))
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=n))
    want = {r.rid: r.generated for r in ref_eng.run_until_drained(200)}
    got = {r.rid: r.generated for r in eng.run_until_drained(200)}
    assert got == want and len(got) == 4
    assert all(len(got[i]) == n for i, (_, n) in enumerate(reqs))


@pytest.mark.parametrize("name", configs.list_archs())
def test_param_counts_match_reference(name):
    for which in ("get", "reduced"):
        cfg = getattr(configs, which)(name)
        ref_cfg = getattr(ref_configs, which)(name)
        assert common.count_params_analytic(cfg) == \
            ref_common.count_params_analytic(ref_cfg)
        assert cfg.param_count() == ref_cfg.param_count()
        assert [cfg.layer_is_global(i) for i in range(cfg.n_layers)] == \
            [ref_cfg.layer_is_global(i) for i in range(ref_cfg.n_layers)]


@pytest.mark.parametrize("name", DENSE)
def test_configs_are_the_reference_configs(name):
    for which in ("get", "reduced"):
        mine = dataclasses.asdict(getattr(configs, which)(name))
        ref = dataclasses.asdict(getattr(ref_configs, which)(name))
        assert mine.pop("dtype") == torch.bfloat16
        assert ref.pop("dtype") == jnp.bfloat16
        assert mine == ref


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), tuple(v.shape), str(v.dtype).split(".")[-1]


def test_parameter_trees_match_reference(pair):
    """The port's seeded init, the carried-over reference weights and
    ``repro``'s abstract init: the same names, shapes and dtypes."""
    ref_model, _, model, params = pair
    want = list(_leaves(jax.tree.map(
        lambda s: np.empty(s.shape, s.dtype),
        ref_model.init_params(seed=0, abstract=True))))
    assert list(_leaves(model.init_params(seed=0))) == want
    assert list(_leaves(params)) == want
    names = {path[-1] for path, _, _ in want}
    cfg = model.cfg
    assert ("bq" in names) == cfg.qkv_bias
    assert ("q_norm" in names) == cfg.qk_norm
    assert ("ln1_post" in names) == cfg.sandwich_norm
    assert ("w_gate" in names) == cfg.gated_mlp
    assert ("lm_head" in names) != cfg.tie_embeddings


def test_dense_mla_raises():
    cfg = dataclasses.replace(configs.reduced("qwen2-0.5b"), mla=True)
    with pytest.raises(NotImplementedError, match="MLA"):
        Model(cfg, device="cpu")


@pytest.mark.parametrize("name", ["mixtral-8x7b", "seamless-m4t-medium"])
def test_unported_configs_raise(name):
    with pytest.raises(NotImplementedError):
        configs.get(name)
    ref_cfg = ref_configs.reduced(name)
    cfg = common.ArchConfig(**{k: v for k, v in ref_cfg.__dict__.items()
                               if k != "dtype"})
    for build in (lambda: Model(cfg, device="cpu"),
                  lambda: common.count_params_analytic(cfg)):
        with pytest.raises(NotImplementedError, match=cfg.family
                           if cfg.family == "audio" else "MLA"):
            build()
