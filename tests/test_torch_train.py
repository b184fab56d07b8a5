"""The port's training substrate against ``repro.train`` on the CPU.

AdamW (one step, every moment), ``lr_at`` over the three schedules, the
global-norm clip, ``TokenStream`` (bit for bit, sharded too), int8
compression with error feedback, the loss falling on the reduced
``qwen2-0.5b`` (float32, vocab 128) with 1 and 2 microbatches, and a train
step on that model with ``repro``'s weights carried over
(``from_reference_params``, every zero-initialized norm and bias drawn at
random): the loss and the flattened gradient of one step, and the
parameters after 3 AdamW steps, against ``repro``'s ``make_train_step`` on
its reference kernel backend, with remat on and off.

Tolerances: the optimizer's arithmetic is the same op for op, so its
outputs agree to a float32 ulp or two (rtol 1e-6; ``lr_at``'s cosine may
round differently by an ulp).  The model's forward and backward sum in
other orders than XLA's: the loss within 1e-6 relative, the gradient
within 1e-5 of its largest element, and the parameters after 3 steps
within 1e-6 absolute for all but 1e-4 of them and within the steps' full
swing (2 lr a step) for every one: AdamW moves each by about lr sign(g),
so an element whose gradient is near its own rounding may move either
way.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from repro import configs as ref_configs
from repro import train as ref_train
from repro.models import Model as RefModel
from repro_torch import configs, train
from repro_torch.models import Model
from repro_torch.models.convert import from_reference_params
from repro_torch.train import trainer
from repro_torch.train.tree import ravel, tree_leaves


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch(tree):
    return from_reference_params(to_np(tree), "cpu")


def flat_np(tree) -> np.ndarray:
    return np.concatenate([np.asarray(t).reshape(-1) for t in
                           tree_leaves(tree)]) if isinstance(
        tree, dict) else np.asarray(tree)


def test_adamw_one_step_matches_reference():
    rng = np.random.default_rng(0)
    p = {"w": rng.normal(size=(4, 3)).astype(np.float32),
         "b": rng.normal(size=(3,)).astype(np.float32),
         "blocks": {"m": rng.normal(size=(2, 5, 3)).astype(np.float32)}}
    g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                     p)
    for cfg in (ref_train.AdamWConfig(lr=1e-2, warmup_steps=3,
                                      weight_decay=0.5),
                ref_train.AdamWConfig(lr=1e-2, warmup_steps=1,
                                      grad_clip=1e9)):
        mine_cfg = train.AdamWConfig(**dataclasses.asdict(cfg))
        want_p, want_st, want_m = ref_train.adamw_update(
            cfg, jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
            ref_train.init_opt_state(jax.tree.map(jnp.asarray, p)))
        got_p, got_st, got_m = train.adamw_update(
            mine_cfg, to_torch(p), to_torch(g),
            train.init_opt_state(to_torch(p)))
        for got, want in ((got_p, want_p), (got_st.mu, want_st.mu),
                          (got_st.nu, want_st.nu)):
            np.testing.assert_allclose(flat_np(got), flat_np(want),
                                       rtol=1e-6, atol=0)
        assert int(got_st.step) == int(want_st.step) == 1
        for k in ("gnorm", "lr"):
            np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                       rtol=1e-6)


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_lr_at_matches_reference(schedule):
    cfg = ref_train.AdamWConfig(lr=3e-3, warmup_steps=17, total_steps=240,
                                schedule=schedule, min_lr_frac=0.1)
    mine = train.AdamWConfig(**dataclasses.asdict(cfg))
    steps = np.arange(0, 260, 3)
    want = np.array([float(ref_train.lr_at(cfg, jnp.asarray(s, jnp.int32)))
                     for s in steps])
    got = np.array([float(train.lr_at(mine, torch.tensor(s, dtype=torch.int32)))
                    for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert want[0] < want[5]           # the warmup ramp


def test_grad_clip():
    p = {"w": np.zeros((2, 2), np.float32)}
    g = {"w": np.full((2, 2), 100.0, np.float32)}
    _, _, want = ref_train.adamw_update(
        ref_train.AdamWConfig(grad_clip=1.0, warmup_steps=1),
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
        ref_train.init_opt_state(jax.tree.map(jnp.asarray, p)))
    new, _, got = train.adamw_update(
        train.AdamWConfig(grad_clip=1.0, warmup_steps=1), to_torch(p),
        to_torch(g), train.init_opt_state(to_torch(p)))
    assert float(got["gnorm"]) == pytest.approx(200.0)
    assert float(got["gnorm"]) == float(want["gnorm"])
    assert torch.isfinite(new["w"]).all()


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_token_stream_bitwise(n_shards):
    cfg = dict(vocab=128, seq_len=32, global_batch=8, seed=3)
    mine = train.TokenStream(train.DataConfig(**cfg))
    ref = ref_train.TokenStream(ref_train.DataConfig(**cfg))
    for step in (0, 5, 11):
        for shard in range(n_shards):
            a = mine.sample(step, shard, n_shards)
            b = ref.sample(step, shard, n_shards)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(mine.motifs, ref.motifs)


def test_compression_matches_reference():
    rng = np.random.default_rng(1)
    g = {"w": rng.normal(size=(64,)).astype(np.float32),
         "m": rng.normal(size=(4, 8)).astype(np.float32)}
    q, s = train.compress(torch.from_numpy(g["w"]))
    qr, sr = ref_train.compress(jnp.asarray(g["w"]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    assert float(s) == float(sr) and q.dtype == torch.int8
    np.testing.assert_array_equal(train.decompress(q, s).numpy(),
                                  np.asarray(ref_train.decompress(qr, sr)))
    res, res_r = train.init_residual(to_torch(g)), ref_train.init_residual(
        jax.tree.map(jnp.asarray, g))
    total = torch.zeros(64)
    for _ in range(20):
        out, res = train.ef_compress_tree(to_torch(g), res)
        out_r, res_r = ref_train.ef_compress_tree(
            jax.tree.map(jnp.asarray, g), res_r)
        np.testing.assert_array_equal(flat_np(out), flat_np(out_r))
        np.testing.assert_array_equal(flat_np(res), flat_np(res_r))
        total = total + out["w"]
    # error feedback: the compressed steps' mean converges to the truth
    np.testing.assert_allclose((total / 20).numpy(), g["w"],
                               atol=float(s) * 1.1)


def tiny_configs():
    cfg = dataclasses.replace(configs.reduced("qwen2-0.5b"),
                              dtype=torch.float32, vocab=128)
    ref_cfg = dataclasses.replace(ref_configs.reduced("qwen2-0.5b"),
                                  dtype=jnp.float32, vocab=128)
    return cfg, ref_cfg


@pytest.mark.parametrize("microbatches", [1, 2])
def test_loss_decreases_tiny_model(microbatches):
    cfg, _ = tiny_configs()
    model = Model(cfg, device="cpu", remat=False)
    tcfg = train.TrainerConfig(
        opt=train.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60),
        microbatches=microbatches)
    state = train.make_train_state(model, tcfg, seed=0)
    step = train.make_train_step(model, tcfg)
    data = train.TokenStream(train.DataConfig(vocab=128, seq_len=32,
                                              global_batch=4))
    losses = []
    for i in range(30):
        batch = {k: torch.from_numpy(v) for k, v in
                 data.global_batch_at(i).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::6]
    assert np.isfinite(losses).all()


def drawn_params(ref_model, seed: int = 0):
    """``repro``'s weights with every all-zero leaf (norms, biases) drawn
    from a normal of scale 0.2, so that they count."""
    rng = np.random.default_rng(seed)

    def draw(a):
        a = np.asarray(a)
        if a.dtype.kind == "f" and not a.any():
            return rng.normal(scale=0.2, size=a.shape).astype(a.dtype)
        return a

    return jax.tree.map(draw, ref_model.init_params(seed=seed))


@pytest.mark.parametrize("remat", [True, False])
def test_train_step_parity_with_reference(remat):
    cfg, ref_cfg = tiny_configs()
    ref_model = RefModel(ref_cfg, remat=remat)
    model = Model(cfg, device="cpu", remat=remat)
    params_np = drawn_params(ref_model)
    data = train.TokenStream(train.DataConfig(vocab=128, seq_len=48,
                                              global_batch=4, seed=5))
    batch_np = data.global_batch_at(0)

    # loss and gradient of one step
    (want_loss, _), want_g = jax.value_and_grad(
        lambda p: ref_model.loss(p, jax.tree.map(jnp.asarray, batch_np)),
        has_aux=True)(jax.tree.map(jnp.asarray, params_np))
    (got_loss, aux), got_g = trainer.value_and_grad(
        model.loss, to_torch(params_np),
        {k: torch.from_numpy(v) for k, v in batch_np.items()}, has_aux=True)
    assert set(aux) == {"ce", "aux", "zloss"}
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)
    want_flat = np.asarray(ravel_pytree(want_g)[0])
    got_flat = ravel(got_g)[0].numpy()
    np.testing.assert_allclose(got_flat, want_flat, rtol=0,
                               atol=1e-5 * np.abs(want_flat).max())
    # the tied embedding's gradient counts its use as the head: rows of
    # tokens that no input holds still get one
    unseen = np.setdiff1d(np.arange(cfg.vocab), batch_np["tokens"])
    assert len(unseen) and np.abs(got_g["embed"][unseen].numpy()).max() > 0
    np.testing.assert_allclose(got_g["embed"].numpy(),
                               np.asarray(want_g["embed"]), rtol=0,
                               atol=1e-5 * np.abs(want_flat).max())

    # the parameters after 3 AdamW steps
    tcfg = ref_train.TrainerConfig(
        opt=ref_train.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=3))
    mine_tcfg = train.TrainerConfig(
        opt=train.AdamWConfig(**dataclasses.asdict(tcfg.opt)))
    ref_step = jax.jit(ref_train.make_train_step(ref_model, tcfg))
    step = train.make_train_step(model, mine_tcfg)
    ref_state = ref_train.TrainState(
        jax.tree.map(jnp.asarray, params_np),
        ref_train.init_opt_state(jax.tree.map(jnp.asarray, params_np)), None)
    state = train.TrainState(to_torch(params_np),
                             train.init_opt_state(to_torch(params_np)), None)
    for i in range(3):
        b = data.global_batch_at(i)
        ref_state, ref_m = ref_step(ref_state, jax.tree.map(jnp.asarray, b))
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   rtol=1e-5)
    got_p = ravel(state.params)[0].numpy()
    want_p = np.asarray(ravel_pytree(ref_state.params)[0])
    off = np.abs(got_p - want_p)
    # every element within the 3 steps' full swing, and all but 1e-4 of
    # them within 1e-6 (AdamW's normalized update moves an element whose
    # gradient is near its rounding by up to lr either way)
    assert off.max() <= 2 * 3 * tcfg.opt.lr, off.max()
    assert np.mean(off > 1e-6) <= 1e-4, np.sort(off)[-5:]
    assert int(state.opt.step) == 3
