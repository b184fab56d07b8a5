"""The port's sparse dynamic data exchange (``repro_torch.core.dynexchange``)
against ``repro``'s on the same seeded needs and pushes.

Pull-side ``discover`` and push-side ``push`` are host numpy, so the port
must agree exactly: the discovered patterns (by fingerprint), the
``DiscoveryStats`` and the pushed rows and their sources.  The last two
tests are the reference's own cases
(``tests/test_distributed_setup.py``) run on the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import SparseDynamicExchange as RefExchange
from repro.core.cache import pattern_fingerprint as ref_fingerprint
from repro_torch.core import SparseDynamicExchange, pattern_fingerprint


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_same_stats(got, want):
    assert (got.n_procs, got.allreduce_ints, got.request_ints) == (
        want.n_procs, want.allreduce_ints, want.request_ints)
    assert np.array_equal(got.request_partners, want.request_partners)
    assert np.array_equal(got.serve_partners, want.serve_partners)
    assert (got.max_request_partners, got.max_serve_partners) == (
        want.max_request_partners, want.max_serve_partners)


def random_needs(rng, n_procs, per_rank):
    """Sorted unique remote indices per rank over a ragged block partition."""
    sizes = rng.integers(0, 2 * per_rank, size=n_procs)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    needs = []
    for p in range(n_procs):
        others = np.setdiff1d(np.arange(offsets[-1]),
                              np.arange(offsets[p], offsets[p + 1]))
        k = int(rng.integers(0, min(len(others), per_rank) + 1))
        needs.append(np.sort(rng.choice(others, size=k, replace=False)))
    return needs, offsets


@pytest.mark.parametrize("n_procs,per_rank,seed", [
    (3, 4, 0), (6, 9, 1), (8, 20, 2), (8, 3, 3),
])
def test_discover_matches_reference(n_procs, per_rank, seed):
    needs, offsets = random_needs(np.random.default_rng(seed), n_procs,
                                  per_rank)
    pattern, stats = SparseDynamicExchange.discover(needs, offsets)
    ref_pattern, ref_stats = RefExchange.discover(needs, offsets)
    assert pattern_fingerprint(pattern) == ref_fingerprint(ref_pattern)
    assert_same_stats(stats, ref_stats)


@pytest.mark.parametrize("trailing", [(), (2,), (3, 2)])
@pytest.mark.parametrize("n_procs,seed", [(4, 0), (7, 1), (8, 2)])
def test_push_matches_reference(n_procs, seed, trailing):
    rng = np.random.default_rng(seed)
    dest = [rng.integers(0, n_procs, size=int(rng.integers(0, 12)))
            for _ in range(n_procs)]
    payload = [rng.normal(size=(len(d),) + trailing) for d in dest]
    got, sources, stats = SparseDynamicExchange.push(dest, payload)
    want, ref_sources, ref_stats = RefExchange.push(dest, payload)
    assert_same_stats(stats, ref_stats)
    for g, w, s, rs in zip(got, want, sources, ref_sources):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w) and np.array_equal(s, rs)


def test_push_with_no_rows_keeps_the_dtype():
    dest = [np.zeros(0, dtype=np.int64)] * 3
    payload = [np.zeros((0, 2), dtype=np.float32)] * 3
    got, sources, stats = SparseDynamicExchange.push(dest, payload)
    want, _, _ = RefExchange.push(dest, payload)
    assert [g.dtype for g in got] == [w.dtype for w in want]
    assert [g.shape for g in got] == [(0, 2)] * 3
    assert stats.request_ints == 0 and all(len(s) == 0 for s in sources)


def test_discover_partners_counts_and_pattern():
    off = np.array([0, 3, 6, 10])
    needs = [np.array([4, 8]), np.array([0, 1, 9]), np.zeros(0, dtype=np.int64)]
    pattern, stats = SparseDynamicExchange.discover(needs, off)
    assert stats.n_procs == 3
    assert stats.allreduce_ints == 9          # the P*P count matrix
    assert stats.request_ints == 5            # total requested indices
    # rank 0 pulls from ranks 1 and 2; rank 1 from 0 and 2; rank 2 idles
    assert stats.request_partners.tolist() == [2, 2, 0]
    # owners: rank 0 serves rank 1; rank 1 serves rank 0; rank 2 serves both
    assert stats.serve_partners.tolist() == [1, 1, 2]
    assert pattern.n_procs == 3
    for p in range(3):
        assert np.array_equal(pattern.needs[p], needs[p])
    assert pattern.owner_proc[4] == 1 and pattern.owner_proc[8] == 2


def test_push_exchange_roundtrip():
    rng = np.random.default_rng(3)
    P_ = 4
    dest = [rng.integers(0, P_, size=k) for k in (5, 0, 7, 3)]
    payload = [
        np.stack([np.full(len(d), p, dtype=float), rng.normal(size=len(d))],
                 axis=-1)
        for p, d in enumerate(dest)
    ]
    received, sources, stats = SparseDynamicExchange.push(dest, payload)
    assert stats.allreduce_ints == P_ * P_
    total = sum(len(d) for d in dest)
    assert stats.request_ints == total
    assert sum(len(r) for r in received) == total
    for q in range(P_):
        # every delivered row was addressed to q, by its claimed source
        for src, row in zip(sources[q], received[q]):
            assert int(row[0]) == src
        # sources arrive in ascending rank order
        assert np.all(np.diff(sources[q]) >= 0)
