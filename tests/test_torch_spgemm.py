"""The port's distributed SpGEMM (``repro_torch.sparse.spgemm``) against
``repro``'s on the same seeded blocks.

Remote-row gathers, row-set merges, local merge products and the
distributed Galerkin product are host numpy over simulated ranks, so the
port must produce the same blocks bit for bit, the same exchange patterns
(by fingerprint) and the same discovery counts.  ``spgemm_rap`` is also
held to the host Galerkin product of the port's ``build_hierarchy`` within
1e-12, the reference's bar (``tests/test_distributed_setup.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import PlanCache as RefCache, Topology as RefTopology
from repro.core.cache import pattern_fingerprint as ref_fingerprint
from repro.core.costmodel import TPU_V5E
from repro.sparse import CSR as RefCSR
from repro.sparse import (
    gather_remote_rows as ref_gather,
    merge_row_sets as ref_merge,
    spgemm_local as ref_local,
    spgemm_rap as ref_rap,
)
from repro_torch.amg import build_hierarchy, diffusion_2d
from repro_torch.core import PlanCache, Topology, pattern_fingerprint
from repro_torch.sparse import (
    CSR,
    block_offsets,
    gather_remote_rows,
    merge_row_sets,
    spgemm_local,
    spgemm_rap,
    split_rows,
    stack_blocks,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_csr(rng, m, n, density=0.08) -> CSR:
    nnz = max(1, int(m * n * density))
    rows = rng.integers(0, m, size=nnz)
    cols = rng.integers(0, n, size=nnz)
    return CSR.from_coo(rows, cols, rng.normal(size=nnz), (m, n))


def ref(m: CSR) -> RefCSR:
    return RefCSR(m.shape, m.indptr, m.indices, m.data)


def assert_same_csr(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    assert np.array_equal(got.indptr, want.indptr)
    assert np.array_equal(got.indices, want.indices)
    assert np.array_equal(got.data, want.data)


def assert_same_stats(got, want):
    assert (got.allreduce_ints, got.request_ints) == (
        want.allreduce_ints, want.request_ints)
    assert np.array_equal(got.request_partners, want.request_partners)
    assert np.array_equal(got.serve_partners, want.serve_partners)


def assert_same_gather(got, want):
    for g, w in zip(got.rows, want.rows):
        assert_same_csr(g, w)
    for g, w in zip(got.needs, want.needs):
        assert np.array_equal(g, w)
    for pat in ("row_pattern", "payload_pattern"):
        assert (pattern_fingerprint(getattr(got, pat))
                == ref_fingerprint(getattr(want, pat)))
    assert_same_stats(got.discovery, want.discovery)
    assert (got.total_rows, got.total_values) == (
        want.total_rows, want.total_values)


@pytest.mark.parametrize("n_procs,ppr,seed", [(4, 2, 0), (6, 3, 1), (8, 4, 2)])
def test_gather_remote_rows_matches_reference(n_procs, ppr, seed):
    rng = np.random.default_rng(seed)
    A = random_csr(rng, 60, 45)
    off = block_offsets(A.nrows, n_procs)
    blocks = split_rows(A, off)
    needs = []
    for p in range(n_procs):
        others = np.setdiff1d(np.arange(A.nrows), np.arange(off[p], off[p + 1]))
        needs.append(np.sort(rng.choice(others, size=6, replace=False)))
    cache = PlanCache()
    got = gather_remote_rows(blocks, off, needs, Topology(n_procs, ppr),
                             cache, params=TPU_V5E)
    want = ref_gather([ref(b) for b in blocks], off, needs,
                      RefTopology(n_procs, ppr), RefCache())
    assert_same_gather(got, want)
    for p in range(n_procs):
        assert_same_csr(got.rows[p], A.take_rows(needs[p]))
    # both exchange plans went through the cache; a second gather hits
    assert cache.misses == 2
    gather_remote_rows(blocks, off, needs, Topology(n_procs, ppr), cache,
                       params=TPU_V5E)
    assert (cache.misses, cache.hits) == (2, 2)


def test_merge_row_sets_matches_reference():
    rng = np.random.default_rng(4)
    M = random_csr(rng, 12, 8)
    ids_a, ids_b = np.array([3, 4, 5]), np.array([0, 9, 11])
    ids, sub = merge_row_sets(ids_a, M.take_rows(ids_a),
                              ids_b, M.take_rows(ids_b))
    ref_ids, ref_sub = ref_merge(ids_a, ref(M.take_rows(ids_a)),
                                 ids_b, ref(M.take_rows(ids_b)))
    assert np.array_equal(ids, ref_ids)
    assert np.array_equal(ids, np.array([0, 3, 4, 5, 9, 11]))
    assert_same_csr(sub, ref_sub)


@pytest.mark.parametrize("subset", [False, True])
def test_spgemm_local_matches_reference(subset):
    rng = np.random.default_rng(1)
    L = random_csr(rng, 20, 30)
    B = random_csr(rng, 30, 25)
    ids = np.unique(L.indices).astype(np.int64) if subset else np.arange(30)
    avail = B.take_rows(ids)
    out = spgemm_local(L, ids, avail)
    assert_same_csr(out, ref_local(ref(L), ids, ref(avail)))
    assert np.abs(out.to_dense() - L.matmat(B).to_dense()).max() < 1e-14


def test_spgemm_local_missing_rows_raises():
    rng = np.random.default_rng(2)
    L = random_csr(rng, 10, 12)
    B = random_csr(rng, 12, 9)
    present = np.unique(L.indices)[:-1]  # drop one referenced row
    with pytest.raises(ValueError, match="missing"):
        spgemm_local(L, present, B.take_rows(present))


@pytest.mark.parametrize("n_procs,ppr", [(4, 2), (6, 2)])
def test_spgemm_rap_matches_reference_and_host_galerkin(n_procs, ppr):
    A = diffusion_2d(16, 16)
    h = build_hierarchy(A)
    lvl = h.levels[0]
    off = block_offsets(A.nrows, n_procs)
    coff = block_offsets(lvl.R.nrows, n_procs)
    R_b, A_b, P_b = (split_rows(lvl.R, coff), split_rows(A, off),
                     split_rows(lvl.P, off))
    res = spgemm_rap(R_b, A_b, P_b, off, Topology(n_procs, ppr), PlanCache(),
                     params=TPU_V5E)
    want = ref_rap([ref(b) for b in R_b], [ref(b) for b in A_b],
                   [ref(b) for b in P_b], off, RefTopology(n_procs, ppr),
                   RefCache())
    for g, w in zip(res.Ac_blocks, want.Ac_blocks):
        assert_same_csr(g, w)
    assert_same_gather(res.gather_A, want.gather_A)
    assert_same_gather(res.gather_P, want.gather_P)
    Ac = stack_blocks(res.Ac_blocks).prune(1e-14)
    assert np.abs(Ac.to_dense() - h.levels[1].A.to_dense()).max() < 1e-12
