"""K7's backward on the CPU: the plain version and the ``autograd.Function``.

``repro`` has no Pallas backward: its gradient through attention is
``jax``'s VJP of ``attention_ref`` (chunked, the model's path) or
``attention_ref_naive``.  The port's plain backward
(``flash_attention_bh_bwd_ref``, from the forward's output and lse) is
held to ``torch.autograd`` of the plain forward and to ``jax.vjp`` of both
reference functions on the same seeded inputs, and
``ops.attention``'s gradient (GQA's broadcast outside the Function, so
autograd sums dk / dv over each group) to the same; causal, a window,
non-causal, GQA groups 1, 2 and 7, T not a multiple of 64, d 64 and 128,
in float32 within 1e-5 of each gradient's largest element (the sums run
in other orders).  A row that sees no key outputs 0 in the port (the
reference's functions give it the mean of v, ROADMAP Queue 3), so its dq
is exactly 0 and that case is held to the port's own autograd only.
``gradcheck`` in float64; the calls the backward does not take raise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels.flash_attention.ref import (
    attention_ref as jax_attention_ref,
    attention_ref_naive as jax_attention_naive,
)
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention import (
    FlashAttentionBH,
    attention,
    flash_attention_bh,
    flash_attention_bh_bwd,
    flash_attention_bh_bwd_ref,
    flash_attention_bh_ref,
)

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, (
        np.abs(got - want).max() / scale)


# (B, Hq, Hkv, T, d, causal, window): GQA groups 1, 2 and 7
CASES = [
    (2, 2, 2, 70, 64, True, 0),
    (1, 4, 2, 100, 128, True, 0),
    (1, 7, 1, 65, 64, True, 0),
    (2, 2, 1, 90, 64, True, 16),
    (1, 2, 2, 33, 128, False, 0),
    (1, 4, 2, 130, 64, False, 24),
]
# also against the chunked attention_ref (its scan compiles slowly)
CHUNKED = [CASES[2], CASES[3], CASES[5]]


def draws(seed, B, Hq, Hkv, T, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, T, d)).astype(np.float32)
    k, v = (rng.normal(size=(B, Hkv, T, d)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(B, Hq, T, d)).astype(np.float32)
    return q, k, v, do


def jax_grads(fn, q, k, v, do, **kw):
    def grads(a, b, c, g):
        return jax.vjp(lambda x, y, z: fn(x, y, z, **kw), a, b, c)[1](g)

    return [np.asarray(g) for g in jax.jit(grads)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(do))]


@pytest.mark.parametrize("case", CASES)
def test_attention_grad_matches_jax_vjp(case):
    """``ops.attention``'s gradient through the Function (plain backward
    on the CPU) against ``jax.vjp`` of ``attention_ref_naive`` (and, for
    ``CHUNKED``, of ``attention_ref`` at chunk 64, so several chunks), and
    against autograd of the port's plain ``attention_ref``."""
    B, Hq, Hkv, T, d, causal, window = case
    q, k, v, do = draws(sum(case), B, Hq, Hkv, T, d)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = attention(tq, tk, tv, causal=causal, window=window)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    kw = dict(causal=causal, window=window)
    wants = [jax_grads(jax_attention_naive, q, k, v, do, **kw)]
    if case in CHUNKED:
        wants.append(jax_grads(jax_attention_ref, q, k, v, do, chunk=64,
                               **kw))
    for want in wants:
        for g, w in zip(got, want):
            close(g.numpy(), w)
    from repro_torch.kernels.flash_attention import attention_ref
    sq, sk, sv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    plain = torch.autograd.grad(attention_ref(sq, sk, sv, **kw), (sq, sk, sv),
                                torch.from_numpy(do))
    for g, w in zip(got, plain):
        close(g.numpy(), w.numpy())


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_autograd_of_plain_forward(case):
    """``flash_attention_bh_bwd_ref`` from the forward's o and lse against
    ``torch.autograd`` of the plain forward, over flattened heads."""
    B, Hq, Hkv, T, d, causal, window = case
    q, k, v, do = draws(sum(case) + 1, B, Hq, Hq, T, d)
    q, k, v, do = (torch.from_numpy(a).reshape(B * Hq, T, d)
                   for a in (q, k, v, do))
    kw = dict(scale=d ** -0.5, causal=causal, window=window)
    o, lse = flash_attention_bh_ref(q, k, v, return_lse=True, **kw)
    got = flash_attention_bh_bwd_ref(q, k, v, o, lse, do, **kw)
    rq, rk, rv = (t.clone().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(flash_attention_bh_ref(rq, rk, rv, **kw),
                               (rq, rk, rv), do)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        close(g.numpy(), w.numpy())
    # the device dispatcher takes the plain version for CPU tensors and
    # counts no launch
    before = dict(LAUNCHES)
    again = flash_attention_bh_bwd(q, k, v, o, lse, do, **kw)
    assert LAUNCHES == before
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_rows_that_see_no_key_get_zero_gradient():
    """Non-causal with a window and Tq > Tk: rows from Tk + window - 1 on
    see no key; their output and dq are exactly 0, and the gradient is
    autograd's of the plain forward."""
    rng = np.random.default_rng(7)
    Tq, Tk, d, w = 90, 33, 64, 16
    q = torch.tensor(rng.normal(size=(2, Tq, d)), dtype=torch.float32,
                     requires_grad=True)
    k, v = (torch.tensor(rng.normal(size=(2, Tk, d)), dtype=torch.float32,
                         requires_grad=True) for _ in range(2))
    do = torch.tensor(rng.normal(size=(2, Tq, d)), dtype=torch.float32)
    kw = dict(scale=0.125, causal=False, window=w)
    # the Function takes kv_len == Tk, q_offset 0; Tq may exceed Tk
    out = flash_attention_bh(q, k, v, **kw)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
    dead = slice(Tk + w - 1, Tq)
    assert (out[:, dead] == 0).all() and (dq[:, dead] == 0).all()
    assert (dq[:, :Tk + w - 1].abs().amax(-1) > 0).all()
    _, lse = flash_attention_bh_ref(q.detach(), k.detach(), v.detach(),
                                    return_lse=True, **kw)
    assert torch.isinf(lse[:, dead]).all()
    rq, rk, rv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(flash_attention_bh_ref(rq, rk, rv, **kw),
                               (rq, rk, rv), do)
    for g, wnt in zip((dq, dk, dv), want):
        close(g.numpy(), wnt.numpy())


def test_gradcheck_float64():
    gen = torch.Generator().manual_seed(3)
    for causal, window in ((True, 0), (True, 3), (False, 4)):
        args = tuple(torch.randn(2, 9, 4, generator=gen, dtype=torch.float64,
                                 requires_grad=True) for _ in range(3))
        assert torch.autograd.gradcheck(
            lambda q, k, v: FlashAttentionBH.apply(q, k, v, 0.5, causal,
                                                   window), args)


def test_no_gradient_wanted_bypasses_the_function():
    """Without a gradient the call is the serving path: no graph."""
    q = torch.randn(2, 8, 64)
    out = flash_attention_bh(q, q, q, scale=0.125, causal=True)
    assert out.grad_fn is None
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert flash_attention_bh(qg, qg, qg, scale=0.125,
                                  causal=True).grad_fn is None
    fn = flash_attention_bh(qg, qg, qg, scale=0.125, causal=True).grad_fn
    assert type(fn).__name__ == "FlashAttentionBHBackward"


@pytest.mark.parametrize("kw,Tq,Tk", [
    (dict(q_offset=3), 8, 11),
    (dict(kv_len=6), 8, 8),
    (dict(), 1, 8),
])
def test_backward_refuses_other_calls(kw, Tq, Tk):
    q = torch.randn(2, Tq, 64, requires_grad=True)
    k = torch.randn(2, Tk, 64, requires_grad=True)
    with pytest.raises(ValueError, match="backward takes a prefill call"):
        flash_attention_bh(q, k, k, scale=0.125, causal=True, **kw)
    o = torch.zeros(2, Tq, 64)
    with pytest.raises(ValueError, match="backward takes a prefill call"):
        flash_attention_bh_bwd_ref(q.detach(), k.detach(), k.detach(), o,
                                   torch.zeros(2, Tq), o, scale=0.125,
                                   causal=True, **kw)
