"""The port's plain versions of the MoE pack / combine kernels (K5, K6)
against ``repro``'s Pallas kernels in interpret mode on the CPU, plus the
ops' input validation and device dispatch.

Inputs are seeded numpy arrays in float32.  K5 is a copy, so it must agree
exactly.  K6 sums K weighted rows in float32 on both sides; only the order
of the adds may differ, hence 1e-6.  K6's lane form (``combine_lanes``:
buf [G, R, D], an index >= R adds zero) is held against ``repro``'s kernel
on the table ``repro``'s MoE layer feeds it: each lane's rows with a zero
row appended, the lanes concatenated, each lane's indices offset into its
own and its sentinels pointed at its zero row.  All three ops read an index
outside the row table (negative or past the end) as a zero row and raise
for none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.moe_pack.moe_pack import combine_rows, gather_rows
from repro_torch.kernels import LAUNCHES, use_kernel
from repro_torch.kernels.moe_pack import (
    combine,
    combine_lanes,
    combine_lanes_ref,
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
    assert torch.equal(pack(x, torch.tensor([11])), torch.zeros(1, 8))


OUT_OF_RANGE = [-1, 0, 5]     # -1, and R + 0 / R + 5 past the last row


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("past", OUT_OF_RANGE)
def test_pack_reads_zero_outside_the_table(past, idx_dtype):
    """An index at -1, R or R + 5 gives a zero row, the others their row,
    even when the row past the table is NaN."""
    base = torch.randn(7 + 6, 8, generator=torch.Generator().manual_seed(2))
    base[7:] = float("nan")
    x = base[:7]
    bad = -1 if past < 0 else 7 + past
    idx = torch.tensor([3, bad, 0, bad, 6], dtype=idx_dtype)
    out = pack(x, idx)
    assert torch.equal(out, gather_rows_ref(x, idx))
    assert not out[[1, 3]].any() and not out[[1, 3]].signbit().any()
    assert torch.equal(out[[0, 2, 4]], x[[3, 0, 6]])


@pytest.mark.parametrize("past", OUT_OF_RANGE)
def test_combine_adds_zero_outside_the_table(past):
    """``combine`` and ``combine_lanes``: an index at -1, R or R + 5 adds
    exactly zero whatever its weight, on a table whose next row is NaN."""
    gen = torch.Generator().manual_seed(3)
    base = torch.randn(2 * 5 + 6, 4, generator=gen)
    base[10:] = float("nan")
    bad = -1 if past < 0 else 5 + past
    idx = torch.tensor([[[1, bad, 4]], [[bad, bad, 0]]])
    w = torch.rand(2, 1, 3, generator=gen)
    lanes = base[:10].view(2, 5, 4)
    out = combine_lanes(lanes, idx, w)
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, combine_lanes_ref(lanes, idx, w))
    assert torch.equal(out[1, 0], (w[1, 0, 2] * lanes[1, 0]))
    flat = combine(base[:5], idx[0], w[0])
    assert torch.equal(flat, combine_rows_ref(base[:5], idx[0], w[0]))
    want = w[0, 0, 0] * lanes[0, 1] + w[0, 0, 2] * lanes[0, 4]
    assert torch.equal(flat[0], want)


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
    lambda: combine_lanes(X, IDX.reshape(1, 6, 2), W[None]),   # buf 2-d
    lambda: combine_lanes(X[None], IDX.reshape(6, 2), W),      # idx 2-d
    lambda: combine_lanes(X[None], IDX.reshape(2, 3, 2),       # lanes differ
                          W.reshape(2, 3, 2)),
    lambda: combine_lanes(X[None], IDX.reshape(1, 6, 2), W[None, :3]),
    lambda: combine_lanes(X[None], IDX.reshape(1, 6, 2).float(), W[None]),
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


def lanes_case(G, N, K, R, D, sentinels, seed):
    """Seeded lane-form inputs: buf [G, R, D], idx [G, N, K] in [0, R] (R
    the sentinel, with its weight zeroed as the MoE layer zeroes a
    dropped pair's), w [G, N, K]."""
    rng = np.random.default_rng(seed)
    buf = rng.normal(size=(G, R, D)).astype(np.float32)
    idx = rng.integers(0, R, size=(G, N, K)).astype(np.int32)
    w = rng.random(size=(G, N, K)).astype(np.float32)
    if sentinels:
        drop = rng.random(size=(G, N, K)) < 0.3
        idx[drop], w[drop] = R, 0.0
        idx[-1, ::2] = R                   # whole tokens dropped, any weight
    return buf, idx, w


def padded_flat(buf, idx):
    """``repro``'s call form: each lane's rows + a zero row, concatenated,
    indices offset into their lane and sentinels at its zero row."""
    G, R, D = buf.shape
    table = np.concatenate([buf, np.zeros((G, 1, D), buf.dtype)], axis=1)
    flat = np.minimum(idx, R) + (R + 1) * np.arange(G)[:, None, None]
    return table.reshape(G * (R + 1), D), flat.reshape(-1, idx.shape[2])


@pytest.mark.parametrize("sentinels", [False, True])
@pytest.mark.parametrize("K", [1, 6, 9])
@pytest.mark.parametrize("G", [1, 3])
def test_combine_lanes_matches_pallas(G, K, sentinels):
    N, R, D = 16, 24, 128
    buf, idx, w = lanes_case(G, N, K, R, D, sentinels, seed=10 * G + K)
    table, flat = padded_flat(buf, idx)
    want = np.asarray(combine_rows(
        jnp.asarray(table), jnp.asarray(flat), jnp.asarray(w.reshape(-1, K)),
        block_m=16, block_d=128, interpret=True)).reshape(G, N, D)
    got = combine_lanes(torch.as_tensor(buf), torch.as_tensor(idx),
                        torch.as_tensor(w))
    assert got.dtype == torch.float32 and got.shape == (G, N, D)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_lanes_ref_equals_the_padded_flat_combine(dtype):
    """Bit for bit the earlier call form of the MoE layer: a zero row
    appended to every lane, indices offset into the flat table, the flat
    plain K6."""
    buf, idx, w = lanes_case(4, 10, 6, 33, 64, True, seed=7)
    table, flat = padded_flat(buf, idx)
    tb = torch.as_tensor(buf).to(dtype)
    want = combine_rows_ref(torch.as_tensor(table).to(dtype),
                            torch.as_tensor(flat),
                            torch.as_tensor(w.reshape(-1, 6)))
    got = combine_lanes_ref(tb, torch.as_tensor(idx), torch.as_tensor(w))
    assert torch.equal(got, want.reshape(got.shape))
    assert torch.equal(combine_lanes(tb, torch.as_tensor(idx),
                                     torch.as_tensor(w)), got)


def test_combine_lanes_all_sentinel_lane_is_exact_zero():
    """A lane whose every index is the sentinel gives exact zeros in buf's
    dtype, whatever the weights (inf and NaN included); the other lanes
    are untouched."""
    buf = torch.ones(2, 5, 16, dtype=torch.bfloat16)
    idx = torch.zeros(2, 3, 2, dtype=torch.int32)
    idx[1] = 5
    w = torch.ones(2, 3, 2)
    w[1, 0], w[1, 1] = float("inf"), float("nan")
    out = combine_lanes(buf, idx, w)
    assert out.dtype == torch.bfloat16
    assert not out[1].any() and not out[1].signbit().any()
    assert torch.equal(out[0], torch.full((3, 16), 2.0, dtype=torch.bfloat16))


def test_combine_lanes_reads_no_sentinel_row():
    """buf is a view of a table whose next row is NaN, with the sentinel
    in the last lane: nothing past each lane's R rows is read."""
    base = torch.randn(2 * 7 + 1, 8, generator=torch.Generator().manual_seed(1))
    base[-1] = float("nan")
    buf = base[:14].view(2, 7, 8)
    idx = torch.tensor([[[0, 6]], [[7, 3]]])
    w = torch.ones(2, 1, 2)
    out = combine_lanes(buf, idx, w)
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out[1, 0], buf[1, 3])


def test_combine_lanes_negative_index_raises():
    """No longer raises: a negative index adds exactly zero, as the kernel
    reads it (the name is kept from when the plain version raised)."""
    buf = torch.arange(32, dtype=torch.float32).reshape(1, 4, 8)
    out = combine_lanes(buf, torch.tensor([[[1, -1]]]), torch.ones(1, 1, 2))
    assert torch.equal(out[0, 0], buf[0, 1])


def test_combine_lanes_dispatch_is_by_device():
    """CPU tensors take the plain version and count no launch; mixed
    devices (``meta``) are refused; the CUDA wrapper refuses CPU
    tensors."""
    buf = torch.zeros(2, 4, 8)
    idx = torch.zeros(2, 3, 1, dtype=torch.int32)
    w = torch.ones(2, 3, 1)
    with pytest.raises(ValueError, match="devices"):
        combine_lanes(buf.to("meta"), idx, w)
    with pytest.raises(ValueError, match="devices"):
        combine_lanes(buf, idx, w.to("meta"))
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="not cuda"):
        cuda.combine_lanes(buf, idx, w)
    assert combine_lanes(buf, idx, w).shape == (2, 3, 8)
    assert LAUNCHES == before
