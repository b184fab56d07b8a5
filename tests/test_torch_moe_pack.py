"""The port's plain versions of the MoE pack / combine kernels (K5, K6)
against ``repro``'s Pallas kernels in interpret mode on the CPU, plus the
ops' input validation and device dispatch.

Inputs are seeded numpy arrays in float32.  K5 is a copy, so it must agree
exactly.  K6 sums K weighted rows in float32 on both sides; only the order
of the adds may differ, hence 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.moe_pack.moe_pack import combine_rows, gather_rows
from repro_torch.kernels import LAUNCHES, use_kernel
from repro_torch.kernels.moe_pack import (
    combine,
    combine_rows_ref,
    gather_rows_ref,
    pack,
)
from repro_torch.kernels.moe_pack import cuda

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def table(rng, N, D):
    """[N + 1, D] rows with the zero pad row last."""
    x = rng.normal(size=(N + 1, D)).astype(np.float32)
    x[-1] = 0.0
    return x


@pytest.mark.parametrize("N,D,M,bm,bd", [
    (40, 64, 96, 32, 64),      # send pack shape of the reduced config
    (17, 128, 64, 64, 128),    # feature dim over one block
    (9, 256, 256, 128, 128),   # D tiled over two blocks
])
def test_pack_matches_pallas(N, D, M, bm, bd):
    rng = np.random.default_rng(N)
    x = table(rng, N, D)
    idx = rng.integers(0, N + 1, size=M).astype(np.int32)
    idx[::5] = N                               # pad slots: the zero row
    want = np.asarray(gather_rows(jnp.asarray(x), jnp.asarray(idx),
                                  block_m=bm, block_d=bd, interpret=True))
    got = pack(torch.as_tensor(x), torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[torch.as_tensor(idx == N)].any()


@pytest.mark.parametrize("T,K,N,D,bm,bd", [
    (48, 3, 97, 64, 16, 64),   # top-3 of the reduced config
    (32, 6, 200, 128, 32, 128),   # top-6, DeepSeek-V2-Lite's k
    (16, 1, 33, 256, 16, 128),    # K = 1
])
def test_combine_matches_pallas(T, K, N, D, bm, bd):
    rng = np.random.default_rng(T + K)
    buf = table(rng, N, D)
    idx = rng.integers(0, N + 1, size=(T, K)).astype(np.int32)
    w = rng.random(size=(T, K)).astype(np.float32)
    idx[::4, -1], w[::4, -1] = N, 0.0          # dropped slots
    want = np.asarray(combine_rows(jnp.asarray(buf), jnp.asarray(idx),
                                   jnp.asarray(w), block_m=bm, block_d=bd,
                                   interpret=True))
    got = combine(torch.as_tensor(buf), torch.as_tensor(idx),
                  torch.as_tensor(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_combine_all_pad_rows_give_zero_and_keep_dtype():
    """Every slot at the pad row: the output is exactly 0 in buf's dtype."""
    buf = torch.zeros(5, 16, dtype=torch.bfloat16)
    buf[:4] = 1.0
    idx = torch.full((7, 2), 4, dtype=torch.int32)
    out = combine(buf, idx, torch.ones(7, 2))
    assert out.dtype == torch.bfloat16 and not out.any()


def test_plain_versions_index_like_the_ops():
    rng = np.random.default_rng(3)
    x = torch.as_tensor(table(rng, 10, 8))
    idx = torch.as_tensor(rng.integers(0, 11, size=12))
    assert torch.equal(pack(x, idx), gather_rows_ref(x, idx))
    cidx = idx.reshape(6, 2)
    w = torch.rand(6, 2, generator=torch.Generator().manual_seed(0))
    assert torch.equal(combine(x, cidx, w), combine_rows_ref(x, cidx, w))
    with pytest.raises(IndexError):
        pack(x, torch.tensor([11]))


X = torch.zeros(9, 4)
IDX = torch.arange(12, dtype=torch.int32) % 9
W = torch.ones(6, 2)


@pytest.mark.parametrize("call", [
    lambda: pack(X[0], IDX),                          # x not [N, D]
    lambda: pack(X, IDX.reshape(6, 2)),               # idx not [M]
    lambda: pack(X, IDX.float()),                     # idx not integer
    lambda: combine(X, IDX, W),                       # idx not [T, K]
    lambda: combine(X, IDX.reshape(6, 2), W.reshape(-1)),   # w vs idx
    lambda: combine(X, IDX.reshape(6, 2), W.long()),  # w not float
])
def test_ops_reject_malformed_input(call):
    with pytest.raises(ValueError, match="pack|combine"):
        call()


def test_dispatch_is_by_device():
    """CPU tensors take the plain version and count no launch; mixed
    devices are refused; the CUDA wrappers refuse CPU tensors."""
    x, idx = torch.zeros(4, 8), torch.zeros(3, dtype=torch.int32)
    assert use_kernel(x, idx) is False
    with pytest.raises(ValueError, match="devices"):
        pack(x, idx.to("meta"))
    with pytest.raises(ValueError, match="devices"):
        combine(x.to("meta"), idx.reshape(3, 1), torch.ones(3, 1))
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="not cuda"):
        cuda.gather_rows(x, idx)
    with pytest.raises(ValueError, match="not cuda"):
        cuda.combine_rows(x, idx.reshape(3, 1), torch.ones(3, 1))
    pack(x, idx)
    combine(x, idx.reshape(3, 1), torch.ones(3, 1))
    assert LAUNCHES == before
