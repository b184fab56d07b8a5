"""The port's plain versions of the ELL SpMV kernels K1-K4 against
``repro``'s Pallas kernels (interpret mode on the CPU), plus the layout
conversion, the ops' input validation and device dispatch.

Shapes follow ``test_kernel_spmv_overlap.py``.  Every case stacks P=2 ranks
with different data and compares each rank with its own Pallas call.  The
Pallas kernels take the reference's ``[R, C*K]`` bucketed layout; the port
takes the same operator bucket-major (``ops.to_bucket_major``).  Both
sides run in float64 (JAX's x64 mode is scoped to each call) and agree to
1e-12: only the order of the sums may differ.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.amg import diffusion_2d
from repro.kernels.spmv_ell import ops as ref_ops
from repro.kernels.spmv_ell import spmv_ell as pallas
from repro.sparse import (
    partition_csr,
    partitioned_to_ell_blocked,
    row_block_bucket_map,
)
from repro_torch.kernels import LAUNCHES, use_kernel
from repro_torch.kernels.spmv_ell import cuda, ops

TOL = dict(rtol=1e-12, atol=1e-12)
P = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def pallas64(fn, *args, **kw):
    """Run a Pallas kernel in interpret mode with float64 enabled."""
    with jax.enable_x64(True):
        args = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
                for a in args]
        kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
              for k, v in kw.items()}
        return np.asarray(fn(*args, interpret=True, **kw))


def random_bucketed(rng, R, C, K, bc, empty=()):
    """[P, R, C*K] bucketed layout; buckets in ``empty`` hold all zeros."""
    cols = rng.integers(0, bc, size=(P, R, C * K)).astype(np.int32)
    vals = rng.normal(size=(P, R, C * K))
    for j in empty:
        vals[:, :, j * K: (j + 1) * K] = 0.0
    x = rng.normal(size=(P, C * bc))
    return cols, vals, x


def t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def bm(a, C):
    """The reference's [P, R, C*K] bucketed operand, bucket-major."""
    return ops.to_bucket_major(np.ascontiguousarray(a), C)


def skip_lists(vals, C, K, br):
    """Per-rank live-bucket lists of every row block (padding = 0)."""
    R = vals.shape[1]
    nrb = -(-R // br)
    live = np.zeros((P, nrb * br, C), bool)
    live[:, :R] = (vals.reshape(P, R, C, K) != 0).any(-1)
    live_rb = live.reshape(P, nrb, br, C).any(2)
    counts = live_rb.sum(-1).astype(np.int32)
    M = max(int(counts.max()), 1)
    lists = np.zeros((P, nrb, M), np.int32)
    for p in range(P):
        for rb in range(nrb):
            idx = np.flatnonzero(live_rb[p, rb])
            lists[p, rb, : len(idx)] = idx
    return lists, counts


@pytest.mark.parametrize("R,K,N,br", [(64, 4, 33, 16), (97, 7, 50, 32)])
def test_flat_vs_pallas(R, K, N, br):
    rng = np.random.default_rng(1)
    cols = rng.integers(0, N, size=(P, R, K)).astype(np.int32)
    vals = rng.normal(size=(P, R, K))
    cols[:, :, -1] = N - 1                     # padding -> zero sentinel
    vals[:, :, -1] = 0.0
    x = rng.normal(size=(P, N))
    x[:, -1] = 0.0
    got = ops.spmv(t(cols), t(vals), t(x)).numpy()
    for p in range(P):
        want = pallas64(pallas.spmv_ell, cols[p], vals[p], x[p],
                        block_rows=br)
        np.testing.assert_allclose(got[p], want, **TOL)


@pytest.mark.parametrize("R,C,K,bc,br", [(64, 5, 4, 16, 16),
                                         (97, 4, 3, 32, 32)])
def test_blocked_vs_pallas(R, C, K, bc, br):
    rng = np.random.default_rng(2)
    cols, vals, x = random_bucketed(rng, R, C, K, bc, empty=(1,))
    got = ops.spmv_blocked(bm(cols, C), bm(vals, C), t(x), bc).numpy()
    for p in range(P):
        want = pallas64(pallas.spmv_ell_blocked, cols[p], vals[p], x[p],
                        block_cols=bc, block_rows=br)
        np.testing.assert_allclose(got[p], want, **TOL)


@pytest.mark.parametrize("R,C,K,bc,br", [(64, 5, 4, 16, 16),
                                         (97, 5, 3, 32, 32),   # prime R
                                         (128, 2, 6, 64, 32)])
@pytest.mark.parametrize("lo,hi", [(0, 1), (1, 2), (0, 2), (2, 2)])
def test_partial_vs_pallas(R, C, K, bc, br, lo, hi):
    """Carried-output partial product on every bucket range, including the
    empty range, which returns y0 itself."""
    rng = np.random.default_rng(6)
    cols, vals, x = random_bucketed(rng, R, C, K, bc)
    y0 = rng.normal(size=(P, R))
    xs = x[:, lo * bc: hi * bc]
    y0_t = t(y0)
    got = ops.spmv_blocked_partial(
        bm(cols, C), bm(vals, C), t(xs), y0_t, bucket_lo=lo, bucket_hi=hi,
        n_buckets=C, block_cols=bc,
    )
    if hi == lo:
        assert got is y0_t
    for p in range(P):
        want = pallas64(pallas.spmv_ell_blocked_partial, cols[p], vals[p],
                        xs[p], y0[p], bucket_lo=lo, bucket_hi=hi,
                        n_buckets=C, block_cols=bc, block_rows=br)
        np.testing.assert_allclose(got[p].numpy(), want, **TOL)


@pytest.mark.parametrize("empty", [(), (1,), (0, 2, 4)])
def test_skip_vs_pallas_with_empty_buckets(empty):
    """Bucket lists with empty buckets skipped; row blocks list fewer
    buckets than M where a bucket is empty for them only."""
    R, C, K, bc, br = 64, 5, 4, 16, 16
    rng = np.random.default_rng(8)
    cols, vals, x = random_bucketed(rng, R, C, K, bc, empty=empty)
    vals[1, :br, 3 * K: 4 * K] = 0.0     # rank 1, row block 0: M > count
    lists, counts = skip_lists(vals, C, K, br)
    assert (counts < lists.shape[2]).any()
    got = ops.spmv_blocked_skip(
        bm(cols, C), bm(vals, C), t(x), t(lists), t(counts), n_buckets=C,
        block_cols=bc, block_rows=br,
    ).numpy()
    for p in range(P):
        want = pallas64(pallas.spmv_ell_blocked_skip, cols[p], vals[p], x[p],
                        lists[p], counts[p], n_buckets=C, block_cols=bc,
                        block_rows=br)
        np.testing.assert_allclose(got[p], want, **TOL)


def test_skip_steps_past_count_add_exactly_zero():
    """Padding list entries point at a live bucket; steps past the count
    must still add nothing."""
    R, C, K, bc, br = 48, 3, 2, 8, 16
    rng = np.random.default_rng(4)
    cols, vals, x = random_bucketed(rng, R, C, K, bc)
    nrb = R // br
    lists = np.tile(np.array([0, 1, 2], np.int32), (P, nrb, 1))
    counts = np.full((P, nrb), 1, np.int32)
    got = ops.spmv_blocked_skip(
        bm(cols, C), bm(vals, C), t(x), t(lists), t(counts), n_buckets=C,
        block_cols=bc, block_rows=br,
    ).numpy()
    only_first = ops.spmv_blocked_partial(
        bm(cols, C), bm(vals, C), t(x[:, :bc]),
        torch.zeros(P, R, dtype=torch.float64),
        bucket_lo=0, bucket_hi=1, n_buckets=C, block_cols=bc,
    ).numpy()
    np.testing.assert_allclose(got, only_first, **TOL)
    for p in range(P):
        want = pallas64(pallas.spmv_ell_blocked_skip, cols[p], vals[p], x[p],
                        lists[p], counts[p], n_buckets=C, block_cols=bc,
                        block_rows=br)
        np.testing.assert_allclose(got[p], want, **TOL)


def test_skip_ghost_phase_carried():
    """Trailing bucket window with bucket_base and a carried y0 (the
    overlap schedule's ghost phase)."""
    R, C, K, bc, br = 64, 6, 3, 16, 16
    base = 4
    rng = np.random.default_rng(9)
    cols, vals, x = random_bucketed(rng, R, C, K, bc)
    y0 = rng.normal(size=(P, R))
    nrb = R // br
    lists = np.tile(np.arange(base, C, dtype=np.int32), (P, nrb, 1))
    counts = np.full((P, nrb), C - base, np.int32)
    xg = x[:, base * bc:]
    got = ops.spmv_blocked_skip(
        bm(cols, C), bm(vals, C), t(xg), t(lists), t(counts), n_buckets=C,
        block_cols=bc, bucket_base=base, y0=t(y0), block_rows=br,
    ).numpy()
    for p in range(P):
        want = pallas64(pallas.spmv_ell_blocked_skip, cols[p], vals[p],
                        xg[p], lists[p], counts[p], n_buckets=C,
                        block_cols=bc, bucket_base=base, y0=y0[p],
                        block_rows=br)
        np.testing.assert_allclose(got[p], want, **TOL)


def test_skip_on_amg_matrix_uses_the_reference_bucket_map():
    """On a real partitioned operator the skip product fed by the
    reference's row_block_bucket_map matches the Pallas skip kernel."""
    A = diffusion_2d(24, 24)
    bell = partitioned_to_ell_blocked(partition_csr(A, P), block_cols=32)
    lists, counts = row_block_bucket_map(bell, block_rows=16)
    assert lists.shape[2] < bell.n_buckets
    x = np.random.default_rng(10).normal(size=(P, bell.x_len))
    C = bell.n_buckets
    got = ops.spmv_blocked_skip(
        bm(bell.cols, C), bm(bell.vals, C), t(x), t(lists), t(counts),
        n_buckets=bell.n_buckets, block_cols=bell.block_cols, block_rows=16,
    ).numpy()
    for p in range(P):
        want = pallas64(pallas.spmv_ell_blocked_skip, bell.cols[p],
                        bell.vals[p], x[p], lists[p], counts[p],
                        n_buckets=bell.n_buckets,
                        block_cols=bell.block_cols, block_rows=16)
        np.testing.assert_allclose(got[p], want, **TOL)


@pytest.mark.parametrize("R,C,K,br", [(64, 5, 4, 16),
                                      (97, 4, 3, 32)])   # ragged last block
def test_bucket_major_round_trip(R, C, K, br):
    """``to_bucket_major`` puts bucket b of a row block's rows in one
    contiguous run, the ragged last row block too, and
    ``from_bucket_major`` gives the reference's layout back exactly."""
    rng = np.random.default_rng(11)
    cols, vals, _ = random_bucketed(rng, R, C, K, 16)
    for a in (cols, vals):
        got = bm(a, C)
        assert got.shape == (P, C, R, K) and got.is_contiguous()
        assert got.dtype == t(a).dtype
        np.testing.assert_array_equal(ops.from_bucket_major(got).numpy(), a)
        flat = got.reshape(-1).numpy()
        for p in range(P):
            for b in range(C):
                for r0 in range(0, R, br):
                    nr = min(br, R - r0)
                    start = ((p * C + b) * R + r0) * K
                    np.testing.assert_array_equal(
                        flat[start:start + nr * K],
                        a[p, r0:r0 + nr, b * K:(b + 1) * K].ravel())
    with pytest.raises(ValueError, match="n_buckets"):
        ops.to_bucket_major(cols, C + 1)


def test_csr_to_ell_equal():
    A = diffusion_2d(8, 12)
    got = ops.csr_to_ell(A.indptr, A.indices, A.data, A.nrows, A.ncols,
                         block_rows=32)
    want = ref_ops.csr_to_ell(A.indptr, A.indices, A.data, A.nrows, A.ncols,
                              block_rows=32)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------- validation
def _operands():
    """Bucket-major cols/vals [P, 3, 16, 2] and x [P, 24]."""
    rng = np.random.default_rng(0)
    cols, vals, x = random_bucketed(rng, 16, 3, 2, 8)
    return bm(cols, 3), bm(vals, 3), t(x)


@pytest.mark.parametrize("call,match", [
    (lambda c, v, x: ops.spmv_blocked(c, v, x[:, :-1], 8), "multiple"),
    (lambda c, v, x: ops.spmv_blocked(c[:, :-1], v[:, :-1], x, 8),
     "not divisible"),
    (lambda c, v, x: ops.spmv_blocked_partial(
        c, v, x, torch.zeros(P, 16, dtype=torch.float64), bucket_lo=2,
        bucket_hi=4, n_buckets=3, block_cols=8), "outside"),
    (lambda c, v, x: ops.spmv_blocked_partial(
        c, v, x, torch.zeros(P, 16, dtype=torch.float64), bucket_lo=0,
        bucket_hi=2, n_buckets=3, block_cols=8), "hi-lo"),
    (lambda c, v, x: ops.spmv_blocked_partial(
        c[:, :-1], v[:, :-1], x[:, :8],
        torch.zeros(P, 16, dtype=torch.float64), bucket_lo=0, bucket_hi=1,
        n_buckets=3, block_cols=8), "n_buckets"),
    (lambda c, v, x: ops.spmv_blocked_partial(
        c, v, x[:, :8], torch.zeros(P, 15, dtype=torch.float64),
        bucket_lo=0, bucket_hi=1, n_buckets=3, block_cols=8), "y0"),
    (lambda c, v, x: ops.spmv_blocked_skip(
        c, v, x[:, :-3], torch.zeros(P, 1, 1, dtype=torch.int32),
        torch.ones(P, 1, dtype=torch.int32), n_buckets=3, block_cols=8),
     "multiple"),
    (lambda c, v, x: ops.spmv_blocked_skip(
        c[:, :-1], v[:, :-1], x, torch.zeros(P, 1, 1, dtype=torch.int32),
        torch.ones(P, 1, dtype=torch.int32), n_buckets=3, block_cols=8),
     "n_buckets"),
    (lambda c, v, x: ops.spmv_blocked_skip(
        c, v, x, torch.zeros(P, 2, 1, dtype=torch.int32),
        torch.ones(P, 2, dtype=torch.int32), n_buckets=3, block_cols=8),
     "bucket_lists"),
    (lambda c, v, x: ops.spmv(c[0, 0], v[0, 0], x[0]), r"\[P, R, W\]"),
    (lambda c, v, x: ops.spmv(c[:, 0], v[:, 0], x[:1]), r"\[P, N\]"),
    (lambda c, v, x: ops.spmv_blocked(ops.from_bucket_major(c),
                                      ops.from_bucket_major(v), x, 8),
     "bucket-major"),
])
def test_ops_reject_malformed_input(call, match):
    with pytest.raises(ValueError, match=match):
        call(*_operands())


def test_plain_versions_reject_out_of_range_columns():
    """A column past a rank's own x raises instead of reading the next
    rank's values."""
    cols, vals, x = _operands()
    bad = cols[:, 0].clone()             # a flat [P, R, K] operand
    bad[0, 0, 0] = x.shape[1]            # rank 0 reaches past its x
    with pytest.raises(RuntimeError, match="out of bounds"):
        ops.spmv(bad, vals[:, 0], x)


def test_dispatch_is_by_device():
    """CPU tensors take the plain version; anything but all-cpu or
    all-cuda operands is refused, and the CUDA wrappers refuse CPU
    tensors instead of computing on them."""
    cols, vals, x = _operands()
    assert use_kernel(cols, vals, x) is False
    with pytest.raises(ValueError, match="devices"):
        use_kernel(cols, vals.to("meta"))
    with pytest.raises(ValueError, match="devices"):
        ops.spmv_blocked(cols.to("meta"), vals.to("meta"), x.to("meta"), 8)
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="not cuda"):
        cuda.spmv_ell_blocked(cols, vals, x, 8)
    ops.spmv_blocked(cols, vals, x, 8)
    assert LAUNCHES == before          # the plain version counts nothing
