"""The port's dense collectives (``repro_torch.core.dense``) against
``repro``'s.

For ``allreduce``, ``reduce_scatter`` and ``allgatherv``, every variant,
even and ragged counts and four rank geometries: the round schedules, the
fingerprints and the host interpretation ``execute_numpy`` must equal
``repro``'s exactly, and the rank-stacked executor ``bind_dense`` on the
CPU must equal ``execute_numpy`` bit for bit (it does the same adds in the
same order).  ``select_dense`` must pick ``repro``'s variant with equal
modeled times under the same machine model, passed to both sides.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import (
    build_dense_plan as ref_build,
    select_dense as ref_select,
)
from repro.core.costmodel import TPU_V5E
from repro_torch.core import (
    DENSE_COLLECTIVES,
    PlanCache,
    Topology,
    bind_dense,
    build_dense_plan,
    dense_round_runner,
    dense_variants,
    even_counts,
    pack_dense_input,
    select_dense,
    unpack_dense_output,
)
from repro.core import Topology as RefTopology

GEOMETRIES = [(8, 4), (8, 2), (6, 2), (4, 4)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def counts_for(kind: str, n_procs: int) -> np.ndarray:
    if kind == "even":
        return even_counts(100, n_procs)
    return np.random.default_rng(n_procs).integers(1, 23, size=n_procs)


def inputs_for(plan, seed=1):
    rng = np.random.default_rng(seed)
    if plan.collective == "allgatherv":
        return [rng.normal(size=int(c)) for c in plan.counts]
    n = int(plan.counts.sum())
    return [rng.normal(size=n) for _ in range(plan.topo.n_procs)]


def cases():
    for n_procs, ppr in GEOMETRIES:
        for coll in DENSE_COLLECTIVES:
            for variant in dense_variants(coll, Topology(n_procs, ppr)):
                for kind in ("even", "ragged"):
                    yield pytest.param(
                        coll, variant, kind, n_procs, ppr,
                        id=f"{coll}-{variant}-{kind}-{n_procs}p{ppr}r")


CASES = list(cases())


def test_variants_match_reference():
    from repro.core import dense_variants as ref_variants

    for n_procs, ppr in GEOMETRIES:
        for coll in DENSE_COLLECTIVES:
            assert dense_variants(coll, Topology(n_procs, ppr)) == \
                ref_variants(coll, RefTopology(n_procs, ppr))


@pytest.mark.parametrize("coll,variant,kind,n_procs,ppr", CASES)
def test_plan_and_oracle_match_reference(coll, variant, kind, n_procs, ppr):
    counts = counts_for(kind, n_procs)
    plan = build_dense_plan(coll, counts, Topology(n_procs, ppr), variant)
    ref = ref_build(coll, counts, RefTopology(n_procs, ppr), variant)
    assert plan.fingerprint == ref.fingerprint
    assert plan.n_rounds == ref.n_rounds
    for got, want in zip(plan.rounds, ref.rounds):
        assert got.pairs == want.pairs
        assert (got.reduce, got.phase) == (want.reduce, want.phase)
        assert all(np.array_equal(g, w) for g, w in zip(got.segs, want.segs))
    assert plan.stats.totals() == ref.stats.totals()
    vals = inputs_for(plan)
    for got, want in zip(plan.execute_numpy(vals), ref.execute_numpy(vals)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("coll,variant,kind,n_procs,ppr", CASES)
def test_bind_dense_equals_execute_numpy(coll, variant, kind, n_procs, ppr):
    plan = build_dense_plan(coll, counts_for(kind, n_procs),
                            Topology(n_procs, ppr), variant)
    vals = inputs_for(plan)
    x = torch.as_tensor(pack_dense_input(plan, vals))
    out = bind_dense(plan, "cpu")(x)
    shape = ((n_procs, plan.cmax) if coll == "reduce_scatter"
             else (n_procs, n_procs, plan.cmax))
    assert tuple(out.shape) == shape
    for got, want in zip(unpack_dense_output(plan, out),
                         plan.execute_numpy(vals)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_round_runner_leaves_its_input_alone():
    plan = build_dense_plan("allreduce", counts_for("ragged", 8),
                            Topology(8, 4), "hier")
    x = torch.as_tensor(pack_dense_input(plan, inputs_for(plan)))
    before = x.clone()
    dense_round_runner(plan, "cpu")(x)
    assert torch.equal(x, before)


@pytest.mark.parametrize("coll", DENSE_COLLECTIVES)
@pytest.mark.parametrize("n_procs,ppr", GEOMETRIES)
def test_select_dense_matches_reference(coll, n_procs, ppr):
    counts = counts_for("ragged", n_procs)
    plan, sel = select_dense(coll, counts, Topology(n_procs, ppr),
                             params=TPU_V5E)
    ref_plan, ref_sel = ref_select(coll, counts, RefTopology(n_procs, ppr),
                                   params=TPU_V5E)
    assert sel.chosen == ref_sel.chosen == plan.variant
    assert plan.fingerprint == ref_plan.fingerprint
    assert sel.modeled_times == ref_sel.modeled_times
    assert str(sel).split(" (")[0] == str(ref_sel).split(" (")[0]
    assert plan.modeled_time(TPU_V5E) == sel.modeled_times[sel.chosen]


def test_pack_unpack_roundtrip():
    plan = build_dense_plan("allgatherv", counts_for("ragged", 8),
                            Topology(8, 4), "hier")
    vals = inputs_for(plan)
    packed = pack_dense_input(plan, vals)
    assert packed.shape == (8, plan.cmax)
    for p in range(8):
        c = int(plan.counts[p])
        np.testing.assert_array_equal(packed[p, :c], vals[p])
        assert not packed[p, c:].any()
    # a fully gathered padded buffer unpacks to the concatenated vector
    buf = np.zeros((8, len(plan.counts), plan.cmax))
    for s in range(8):
        buf[:, s, : int(plan.counts[s])] = vals[s]
    cat = np.concatenate(vals)
    for g in unpack_dense_output(plan, torch.as_tensor(buf)):
        np.testing.assert_array_equal(g, cat)


def test_rd_requires_power_of_two_allreduce():
    with pytest.raises(ValueError, match="2\\^k"):
        build_dense_plan("allreduce", counts_for("ragged", 6),
                         Topology(6, 3), "rd")
    with pytest.raises(ValueError, match="allreduce variant"):
        build_dense_plan("allgatherv", counts_for("ragged", 8),
                         Topology(8, 4), "rd")


def test_unknown_collective_rejected():
    with pytest.raises(ValueError, match="unknown dense collective"):
        build_dense_plan("alltoall", counts_for("ragged", 8),
                         Topology(8, 4), "ring")


def test_cache_dense_hits_and_misses():
    cache = PlanCache()
    topo, counts = Topology(8, 4), counts_for("ragged", 8)
    plan, sel = cache.dense_collective("allgatherv", counts, topo,
                                       params=TPU_V5E)
    again, sel2 = cache.dense_collective("allgatherv", counts.copy(), topo,
                                         params=TPU_V5E)
    assert again is plan and sel2 is sel
    cache.dense_collective("allreduce", counts, topo, params=TPU_V5E)
    ns = cache.stats()["namespaces"]["dense_plan"]
    assert (ns["hits"], ns["misses"], ns["entries"]) == (1, 2, 2)
    assert (cache.hits, cache.misses) == (1, 2)
    fn = cache.dense_executor(plan, "cpu")
    assert cache.dense_executor(plan, "cpu") is fn
    ns = cache.stats()["namespaces"]["dense_executor"]
    assert (ns["hits"], ns["misses"], ns["entries"]) == (1, 1, 1)
    assert (cache.exec_hits, cache.exec_misses) == (1, 1)
    cache.clear()
    assert cache.stats()["entries"] == 0
