"""``Model.loss`` with labels outside ``[0, V)``, against ``repro``'s.

``repro``'s chunked cross entropy reads a label's logit as a one-hot sum
(``where(iota == label, logits, 0)``), so a label of -1 or V picks no
logit: its position's ll is 0 and it adds ``lse * mask`` to ce.  The port
gathers on the label clamped to ``[0, V - 1]`` and zeroes the result
where the label lies outside ``[0, V)``: the same value and the same
gradient, where a plain gather would raise on the CPU (and trip a
device-side assert on the card).

On the reduced ``qwen2-0.5b`` (float32, vocab 128) with ``repro``'s
weights carried across (every zero-initialized norm and bias drawn at
random, as ``tests/test_torch_train.py`` does), labels -1 and V at some
positions, each of them masked out and kept in: the loss within 1e-6
relative and the flattened gradient within 1e-5 of its largest element,
the tolerances of the train-step parity test.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from repro import configs as ref_configs
from repro.models import Model as RefModel
from repro_torch import configs, train
from repro_torch.models import Model
from repro_torch.models.convert import from_reference_params
from repro_torch.train import trainer
from repro_torch.train.tree import ravel

VOCAB = 128


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def drawn_params(ref_model, seed: int = 0):
    """``repro``'s weights with every all-zero leaf drawn from a normal of
    scale 0.2, so that norms and biases count."""
    rng = np.random.default_rng(seed)

    def draw(a):
        a = np.asarray(a)
        if a.dtype.kind == "f" and not a.any():
            return rng.normal(scale=0.2, size=a.shape).astype(a.dtype)
        return a

    return jax.tree.map(draw, ref_model.init_params(seed=seed))


def labelled_batch(masked: bool):
    """A [4, 48] batch whose labels hold -1 and V at some positions; with
    ``masked`` those positions are out of the loss mask, else in it (the
    mask drops a few other positions either way)."""
    data = train.TokenStream(train.DataConfig(vocab=VOCAB, seq_len=48,
                                              global_batch=4, seed=5))
    batch = data.global_batch_at(0)
    labels = batch["labels"].copy()
    rng = np.random.default_rng(7)
    flat = rng.choice(labels.size, size=12, replace=False)
    bad = np.unravel_index(flat, labels.shape)
    labels[bad] = np.where(np.arange(12) % 2, -1, VOCAB).astype(labels.dtype)
    mask = np.ones(labels.shape, np.float32)
    mask[:, :3] = 0.0
    if masked:
        mask[bad] = 0.0
    return dict(batch, labels=labels, loss_mask=mask)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_gradient_with_labels_outside_the_vocab(masked):
    cfg = dataclasses.replace(configs.reduced("qwen2-0.5b"),
                              dtype=torch.float32, vocab=VOCAB)
    ref_cfg = dataclasses.replace(ref_configs.reduced("qwen2-0.5b"),
                                  dtype=jnp.float32, vocab=VOCAB)
    ref_model = RefModel(ref_cfg, remat=True)
    model = Model(cfg, device="cpu", remat=True)
    params_np = drawn_params(ref_model)
    batch_np = labelled_batch(masked)
    assert ((batch_np["labels"] == -1).any()
            and (batch_np["labels"] == VOCAB).any())

    (want_loss, _), want_g = jax.value_and_grad(
        lambda p: ref_model.loss(p, jax.tree.map(jnp.asarray, batch_np)),
        has_aux=True)(jax.tree.map(jnp.asarray, params_np))
    (got_loss, aux), got_g = trainer.value_and_grad(
        model.loss, from_reference_params(jax.tree.map(np.asarray,
                                                       params_np), "cpu"),
        {k: torch.from_numpy(v) for k, v in batch_np.items()}, has_aux=True)
    assert np.isfinite(float(got_loss))
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(float(aux["ce"]), float(
        ref_model.loss(jax.tree.map(jnp.asarray, params_np),
                       jax.tree.map(jnp.asarray, batch_np))[1]["ce"]),
        rtol=1e-6)
    want_flat = np.asarray(ravel_pytree(want_g)[0])
    got_flat = ravel(got_g)[0].numpy()
    assert np.isfinite(got_flat).all()
    np.testing.assert_allclose(got_flat, want_flat, rtol=0,
                               atol=1e-5 * np.abs(want_flat).max())
