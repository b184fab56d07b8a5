"""K7's one-row call split over its keys, in its plain version.

The split-key decode (``decode_splits``, ``flash_decode_partials_ref``,
``flash_decode_combine_ref``) is held against the port's plain K7
(``flash_attention_bh_ref``) and against ``repro``'s ``ops.attention`` on
its reference backend and through the Pallas kernel in interpret mode, on
seeded numpy inputs in float32 at 1e-5: every side accumulates in float32,
in different orders.  ``ops.flash_attention_bh`` hands a head dim of 112
to the kernel wrapper as it is, with no padding.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels import use_backend
from repro.kernels.flash_attention import attention as ref_attention
from repro_torch.kernels.flash_attention import cuda, flash_attention_bh, ops
from repro_torch.kernels.flash_attention.ref import (
    DECODE_SPLIT,
    attention_mask,
    decode_splits,
    flash_attention_bh_ref,
    flash_decode_combine_ref,
    flash_decode_partials_ref,
    flash_decode_ref,
)

TOL = dict(rtol=1e-5, atol=1e-5)


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


# (BH, Tk, d, causal, window, kv_len, q_offset, split)
DECODE_CASES = [
    (3, 256, 64, True, 0, 200, 199, DECODE_SPLIT),   # kv_len not a multiple
    (2, 64, 32, True, 0, 1, 0, DECODE_SPLIT),        # kv_len = 1
    (2, 300, 64, True, 100, 300, 250, DECODE_SPLIT),  # a window
    (2, 512, 112, True, 0, 77, 76, DECODE_SPLIT),    # zamba2's head dim
    (2, 512, 112, True, 0, 512, 511, DECODE_SPLIT),  # a full cache, 8 splits
    (2, 128, 32, False, 0, 100, 5, 16),              # non-causal, 7 splits
    (2, 96, 48, True, 9, 96, 40, 4),                 # window, ragged splits
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_split_decode_matches_plain_k7_and_reference(case):
    BH, Tk, d, causal, window, kv_len, q_offset, split = case
    rng = np.random.default_rng(Tk + d + kv_len)
    q, k, v = rand(rng, BH, 1, d), rand(rng, BH, Tk, d), rand(rng, BH, Tk, d)
    kw = dict(scale=d ** -0.5, causal=causal, window=window, kv_len=kv_len,
              q_offset=q_offset)
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    got = flash_decode_ref(tq, tk, tv, split=split, **kw)
    assert got.shape == (BH, 1, d) and got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), flash_attention_bh_ref(tq, tk, tv, **kw).numpy(), **TOL)
    # repro's K7 on [B, H, T, d]: its reference backend and its Pallas
    # kernel in interpret mode (which pads Tq and Tk to its blocks)
    args = [jnp.asarray(a[None]) for a in (q, k, v)]
    want = np.asarray(jax.jit(functools.partial(ref_attention, **kw))(*args))
    np.testing.assert_allclose(got.numpy(), want[0], **TOL)
    with use_backend("pallas_interpret"):
        want = np.asarray(jax.jit(functools.partial(
            ref_attention, block_q=8, block_k=32, **kw))(*args))
    np.testing.assert_allclose(got.numpy(), want[0], **TOL)


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_splits_cover_the_visible_keys(case):
    _, Tk, _, causal, window, kv_len, q_offset, split = case
    begin, end, n = decode_splits(Tk, kv_len, causal, window, q_offset, split)
    seen = attention_mask(1, Tk, causal, window, kv_len, q_offset,
                          "cpu")[0].nonzero()[:, 0].tolist()
    assert seen == list(range(begin, end))
    assert n == -(-(end - begin) // split) and (n - 1) * split < end - begin


def test_split_partials_and_a_row_that_sees_nothing():
    """Each split's partial is its own softmax pieces; a split past the
    visible keys has m = -inf and l = 0, and a row that sees no key
    combines to 0."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.as_tensor(rand(rng, 2, T, 16)) for T in (1, 40, 40))
    kw = dict(scale=0.25, causal=True, window=0, kv_len=40, q_offset=39)
    m, l, acc = flash_decode_partials_ref(q, k, v, split=16, **kw)
    assert m.shape == l.shape == (2, 3) and acc.shape == (2, 3, 16)
    s = torch.einsum("bd,bkd->bk", q[:, 0], k[:, 16:32]) * 0.25
    torch.testing.assert_close(m[:, 1], s.amax(dim=1))
    torch.testing.assert_close(l[:, 1], torch.exp(s - m[:, 1:2]).sum(dim=1))
    # the last split holds keys 32..39 and 8 keys past the end
    torch.testing.assert_close(
        acc[:, 2], torch.einsum("bk,bkd->bd", torch.exp(
            torch.einsum("bd,bkd->bk", q[:, 0], k[:, 32:]) * 0.25
            - m[:, 2:3]), v[:, 32:]))
    none = flash_decode_partials_ref(q, k, v, split=16,
                                     **dict(kw, kv_len=0))
    assert torch.isinf(none[0]).all() and not none[1].any()
    assert not flash_decode_combine_ref(*none, torch.float32).any()
    with pytest.raises(ValueError, match="1"):
        flash_decode_partials_ref(k, k, v, **kw)


@pytest.mark.parametrize("Tq", [1, 17])
def test_ops_hands_head_dim_112_to_the_kernel_unpadded(Tq, monkeypatch):
    """The kernel is built for d = 112 (zamba2-7b): ``ops`` passes q, k
    and v to the wrapper as they are and returns what it returns."""
    assert 112 in cuda.HEAD_DIMS
    seen = []

    def kernel(q, k, v, scale, causal, window, kv_len, q_offset):
        seen.append((q.shape, k.shape, v.shape))
        return flash_attention_bh_ref(q, k, v, scale=scale, causal=causal,
                                      window=window, kv_len=kv_len,
                                      q_offset=q_offset)

    monkeypatch.setattr(ops, "use_kernel", lambda *t: True)
    monkeypatch.setattr(cuda, "flash_attention_bh", kernel)
    rng = np.random.default_rng(Tq)
    q, k, v = (torch.as_tensor(rand(rng, 3, T, 112)) for T in (Tq, 64, 64))
    kw = dict(scale=112 ** -0.5, causal=True, window=0, kv_len=50,
              q_offset=49 if Tq == 1 else 0)
    got = flash_attention_bh(q, k, v, **kw)
    assert seen == [((3, Tq, 112), (3, 64, 112), (3, 64, 112))]
    torch.testing.assert_close(got, flash_attention_bh_ref(q, k, v, **kw),
                               rtol=0, atol=0)
