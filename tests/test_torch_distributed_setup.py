"""The port's distributed AMG setup (``repro_torch.amg.distributed_setup``)
against ``repro``'s and against the host hierarchy.

The setup is host numpy over simulated ranks with every exchange through
``CommPlan.execute_numpy``, in ``repro``'s arithmetic and order, so on the
same partitioned fine matrix the port must build the same levels bit for
bit: splittings, the A / P / R block arrays, rho, and the exchange records
(phase, level, values, pattern fingerprint, discovery counts).  Against
the port's host ``build_hierarchy`` it is held at the reference's bars
(``tests/test_distributed_setup.py``): identical splittings, operators
within 1e-12, rho within 1e-6 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.amg import (
    distributed_build_hierarchy as ref_build,
    partition_fine_matrix as ref_partition,
)
from repro.core import PlanCache as RefCache, Topology as RefTopology
from repro.core.cache import pattern_fingerprint as ref_fingerprint
from repro.core.costmodel import TPU_V5E
from repro_torch.amg import (
    build_hierarchy,
    diffusion_2d,
    distributed_build_hierarchy,
    partition_fine_matrix,
)
from repro_torch.core import PlanCache, Topology, pattern_fingerprint

N_PROCS, PPR = 6, 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def built():
    """(fine operator, the port's setup, repro's setup) on diffusion_2d(24,
    24) over 6 ranks, 2 a region."""
    A = diffusion_2d(24, 24)
    blocks, off = partition_fine_matrix(A, N_PROCS)
    ds = distributed_build_hierarchy(blocks, off, Topology(N_PROCS, PPR),
                                     cache=PlanCache(), params=TPU_V5E)
    from repro.sparse import CSR as RefCSR

    ref_blocks, ref_off = ref_partition(
        RefCSR(A.shape, A.indptr, A.indices, A.data), N_PROCS)
    assert np.array_equal(off, ref_off)
    rs = ref_build(ref_blocks, ref_off, RefTopology(N_PROCS, PPR),
                   cache=RefCache())
    return A, ds, rs


def same_blocks(got, want) -> bool:
    return len(got) == len(want) and all(
        tuple(g.shape) == tuple(w.shape)
        and np.array_equal(g.indptr, w.indptr)
        and np.array_equal(g.indices, w.indices)
        and np.array_equal(g.data, w.data)
        for g, w in zip(got, want))


def test_levels_equal_reference_bit_for_bit(built):
    _, ds, rs = built
    assert ds.n_levels == rs.n_levels >= 3
    for k, (got, want) in enumerate(zip(ds.levels, rs.levels)):
        assert np.array_equal(got.row_offsets, want.row_offsets), k
        assert same_blocks(got.A_blocks, want.A_blocks), k
        assert got.rho == want.rho, k
        if want.P_blocks is None:
            assert got.P_blocks is None and got.splitting_blocks is None
            continue
        assert np.array_equal(got.coarse_offsets, want.coarse_offsets), k
        assert all(np.array_equal(g, w) for g, w in
                   zip(got.splitting_blocks, want.splitting_blocks)), k
        assert same_blocks(got.P_blocks, want.P_blocks), k
        assert same_blocks(got.R_blocks, want.R_blocks), k


def test_records_equal_reference(built):
    _, ds, rs = built
    assert len(ds.records) == len(rs.records)
    for got, want in zip(ds.records, rs.records):
        assert (got.level, got.phase, got.values) == (
            want.level, want.phase, want.values)
        assert (got.pattern is None) == (want.pattern is None)
        if got.pattern is not None:
            assert (pattern_fingerprint(got.pattern)
                    == ref_fingerprint(want.pattern))
        assert (got.discovery is None) == (want.discovery is None)
        if got.discovery is not None:
            g, w = got.discovery, want.discovery
            assert (g.allreduce_ints, g.request_ints) == (
                w.allreduce_ints, w.request_ints)
            assert np.array_equal(g.request_partners, w.request_partners)
            assert np.array_equal(g.serve_partners, w.serve_partners)
    assert ds.exchange_summary() == rs.exchange_summary()
    assert {"halo", "strength_transpose", "p_transpose", "gather_A",
            "gather_P"} <= {r.phase for r in ds.records}


def test_matches_host_hierarchy(built):
    A, ds, _ = built
    h = build_hierarchy(A)
    hh = ds.to_host_hierarchy()
    assert hh.n_levels == h.n_levels
    for k in range(h.n_levels):
        lh, ld = h.levels[k], hh.levels[k]
        if lh.splitting is not None:
            assert ld.splitting is not None
            assert np.array_equal(lh.splitting, ld.splitting), f"L{k}"
        assert np.abs(lh.A.to_dense() - ld.A.to_dense()).max() < 1e-12, f"L{k}"
        if lh.P is not None and ld.P is not None:
            assert np.abs(lh.P.to_dense() - ld.P.to_dense()).max() < 1e-12
            assert np.abs(lh.R.to_dense() - ld.R.to_dense()).max() < 1e-12
        assert abs(lh.rho - ld.rho) < 1e-6 * max(lh.rho, 1.0)
    text = ds.describe()
    assert f"{ds.n_levels} levels on {N_PROCS} ranks" in text
    assert "exchange gather_A" in text


def test_rebuild_replans_nothing():
    A = diffusion_2d(16, 16)
    blocks, off = partition_fine_matrix(A, 4)
    topo = Topology(4, 2)
    cache = PlanCache()
    distributed_build_hierarchy(blocks, off, topo, cache=cache)
    misses = cache.misses
    assert misses > 0 and cache.hits == 0
    ds2 = distributed_build_hierarchy(blocks, off, topo, cache=cache)
    # every setup-phase exchange plan of the rebuild is a cache hit
    assert cache.misses == misses
    assert cache.hits == misses
    assert cache.init_seconds_saved > 0.0
    assert ds2.to_host_hierarchy().n_levels >= 2
