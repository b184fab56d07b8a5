"""The port's attention (plain K7 and ``ops.attention``) against ``repro``'s
``flash_attention_bh`` in Pallas interpret mode and ``ops.attention`` on the
reference backend, on seeded numpy inputs in float32.

Cases cover causal and non-causal attention, a sliding window, ``kv_len``
padding, decode's ``q_offset``, GQA, and MLA's d = 192 (128 nope + 64 rope)
with v zero-padded from 128.  Tolerance 2e-5, the reference's own for its
kernel in float32 (``tests/test_kernel_flash_attention.py``): both sides
accumulate in float32 in different orders.

Rows whose every key is masked are the one place the two differ.  The port
outputs 0 there, as the reference's kernel says it does
(``flash_attention.py:92``); the reference's kernel and oracle actually
return the mean of v over all keys (ROADMAP Queue 3).  Those rows are
checked against 0 and the rest against the reference.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels import use_backend
from repro.kernels.flash_attention import attention as ref_attention
from repro.kernels.flash_attention.flash_attention import (
    flash_attention_bh as pallas_bh,
)
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention import (
    attention,
    attention_ref,
    cuda,
    flash_attention_bh,
)

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def visible(Tq, Tk, causal, window, kv_len, q_offset):
    """[Tq] bool: the query row sees at least one key."""
    q = q_offset + np.arange(Tq)[:, None]
    k = np.arange(Tk)[None, :]
    m = (k < kv_len) & (q >= 0)
    if causal:
        m = m & (k <= q)
    if window > 0:
        m = m & (k > q - window)
    return m.any(axis=1)


# (BH, Tq, Tk, d, causal, window, kv_len, q_offset, block_q, block_k)
BH_CASES = [
    (4, 64, 64, 32, True, 0, 64, 0, 32, 32),        # prefill, causal
    (2, 32, 96, 32, False, 0, 96, 0, 32, 32),       # non-causal
    (3, 64, 128, 64, True, 16, 128, 64, 32, 64),    # window + q_offset
    (2, 8, 64, 24, True, 0, 37, 29, 8, 32),         # decode-like, kv_len
    (2, 32, 64, 192, True, 0, 64, 0, 32, 32),       # MLA head dim
    (2, 16, 64, 32, True, 4, 44, 40, 16, 32),       # fully masked rows
]


@pytest.mark.parametrize("case", BH_CASES)
def test_plain_k7_matches_pallas(case):
    BH, Tq, Tk, d, causal, window, kv_len, q_offset, bq, bk = case
    rng = np.random.default_rng(Tq + Tk + d)
    q, k, v = rand(rng, BH, Tq, d), rand(rng, BH, Tk, d), rand(rng, BH, Tk, d)
    kw = dict(scale=d ** -0.5, causal=causal, window=window, kv_len=kv_len,
              q_offset=q_offset)
    want = np.asarray(jax.jit(functools.partial(
        pallas_bh, block_q=bq, block_k=bk, interpret=True, **kw))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = flash_attention_bh(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), **kw).numpy()
    seen = visible(Tq, Tk, causal, window, kv_len, q_offset)
    np.testing.assert_allclose(got[:, seen], want[:, seen], **TOL)
    assert not got[:, ~seen].any()
    if case is BH_CASES[-1]:
        assert (~seen).any() and seen.any()


# (B, Hq, Hkv, Tq, Tk, d, v_dim, causal, window, kv_len, q_offset, pallas):
# every case against the reference backend, the ``pallas`` ones also
# through the Pallas wrapper in interpret mode (its padding and GQA path)
OPS_CASES = [
    (2, 4, 2, 40, 40, 32, 32, True, 0, None, 0, True),     # GQA, ragged T
    (1, 8, 1, 1, 70, 16, 16, True, 0, 51, 50, False),      # MQA decode
    (2, 4, 4, 12, 48, 24, 16, True, 0, 12, 0, False),      # MLA, reduced
    (1, 2, 2, 20, 64, 192, 128, True, 0, 64, 44, True),    # MLA, full dims
    (1, 2, 2, 50, 50, 32, 32, True, 16, None, 0, False),   # window
    (2, 2, 1, 30, 30, 32, 32, False, 0, 25, 0, False),     # non-causal
]


@pytest.mark.parametrize("case", OPS_CASES)
def test_attention_matches_reference(case):
    B, Hq, Hkv, Tq, Tk, d, vd, causal, window, kv_len, q_offset, pallas = \
        case
    rng = np.random.default_rng(Hq * Tq + d)
    q, k = rand(rng, B, Hq, Tq, d), rand(rng, B, Hkv, Tk, d)
    v = np.zeros((B, Hkv, Tk, d), np.float32)
    v[..., :vd] = rand(rng, B, Hkv, Tk, vd)        # MLA: v padded to qk dim
    kw = dict(scale=d ** -0.5 if vd == d else 0.125, causal=causal,
              window=window, kv_len=kv_len, q_offset=q_offset)
    args = [jnp.asarray(a) for a in (q, k, v)]
    wants = [np.asarray(jax.jit(functools.partial(ref_attention, **kw))(
        *args))]
    if pallas:
        with use_backend("pallas_interpret"):
            wants.append(np.asarray(jax.jit(functools.partial(
                ref_attention, block_q=16, block_k=32, **kw))(*args)))
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    got = attention(tq, tk, tv, **kw).numpy()
    for want in wants:
        np.testing.assert_allclose(got, want, **TOL)
    assert not got[..., vd:].any()
    # the plain version a served model is bound to as its oracle
    np.testing.assert_array_equal(attention_ref(tq, tk, tv, **kw).numpy(),
                                  got)


def test_attention_bf16_keeps_dtype_and_stays_close():
    """bf16 in, bf16 out; m, l and acc stay float32 inside, so the result
    is within bf16 rounding (2^-8 relative) of the float32 one."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.as_tensor(rand(rng, 1, 4, 24, 64)) for _ in range(3))
    full = attention(q, k, v)
    half = attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert half.dtype == torch.bfloat16
    scale = float(full.abs().max())
    assert float((half.float() - full).abs().max()) <= 2 ** -6 * scale


@pytest.mark.parametrize("kw,match", [
    (dict(kv_len=65), "kv_len"),
    (dict(window=-1), "window"),
    (dict(q_offset=-2), "q_offset"),
])
def test_k7_rejects_bad_masks(kw, match):
    q = torch.zeros(2, 4, 32)
    k = torch.zeros(2, 64, 32)
    with pytest.raises(ValueError, match=match):
        flash_attention_bh(q, k, k, scale=1.0, causal=True, **kw)


def test_k7_rejects_malformed_shapes_and_devices():
    q, k = torch.zeros(2, 4, 32), torch.zeros(2, 8, 32)
    with pytest.raises(ValueError, match="BH"):
        flash_attention_bh(q, k[:1], k[:1], scale=1.0, causal=True)
    with pytest.raises(ValueError, match="query heads"):
        attention(torch.zeros(1, 3, 4, 32), torch.zeros(1, 2, 8, 32),
                  torch.zeros(1, 2, 8, 32))
    with pytest.raises(ValueError, match="devices"):
        flash_attention_bh(q, k.to("meta"), k.to("meta"), scale=1.0,
                           causal=True)
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="not cuda"):
        cuda.flash_attention_bh(q, k, k, 1.0, True, 0, 8, 0)
    assert LAUNCHES == before
