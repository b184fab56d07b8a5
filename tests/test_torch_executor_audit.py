"""The port's executor audit (``repro_torch.verify.executor_audit``).

The audit runs a bound rank-stacked executor once under a dispatch mode
and holds its gathers, rank permutations and scatters to the plan:

* it accepts the executors of all three strategies, on a small pattern and
  on a partitioned operator's pattern, also when held to ``repro``'s own
  frozen ``DevicePlan`` of the same pattern (so the port's executor runs
  ``repro``'s rounds, index array for index array);
* it accepts the dense executors of every collective and variant;
* it refuses an executor audited against a foreign plan, an executor whose
  round order is swapped, one whose index depends on the data, and one
  that moves values with an off-plan op; the refusals name the step,
  round, rank and slot.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as rc
import repro_torch.core as pc
from repro_torch.sparse import CSR, partition_csr
from repro_torch.verify import (
    VerifyError,
    audit_dense_executor,
    audit_executor,
    trace_indexing,
)

STRATEGIES = ("standard", "partial", "full")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def patterns(core):
    """A small hand-made pattern on 4 ranks and a random operator's ghost
    pattern on 8."""
    needs = [np.array([4, 5, 9]), np.array([0, 8]), np.array([2]),
             np.array([1, 6])]
    small = core.CommPattern.from_block_partition(needs, np.arange(5) * 3)
    rng = np.random.default_rng(3)
    n = 96
    A = CSR.from_coo(rng.integers(0, n, 6 * n), rng.integers(0, n, 6 * n),
                     rng.normal(size=6 * n), (n, n))
    part = partition_csr(A, 8)
    big = core.CommPattern.from_block_partition(
        [np.asarray(x) for x in part.needs], np.asarray(part.col_offsets))
    return {"small": (small, core.Topology(4, 2)),
            "operator": (big, core.Topology(8, 4))}


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("which", ["small", "operator"])
def test_audit_accepts_every_strategy_and_repro_plan(strategy, which):
    pat, topo = patterns(pc)[which]
    coll = pc.NeighborAlltoallV.init(pat, topo, strategy)
    fn = coll.bind("cpu")
    recs = audit_executor(fn, coll.device_plan, "cpu")
    dplan = coll.device_plan
    local = sum(1 for st in dplan.steps if st.local_gather.shape[1])
    assert len(recs) == 4 * dplan.n_rounds + 2 * local
    assert {r.kind for r in recs} <= {"gather", "scatter"}
    ref_pat, ref_topo = patterns(rc)[which]
    ref = rc.NeighborAlltoallV.init(ref_pat, ref_topo, strategy)
    audit_executor(fn, ref.device_plan, "cpu")


@pytest.mark.parametrize("collective", ["allreduce", "allgatherv",
                                        "reduce_scatter"])
def test_audit_accepts_dense_executors(collective):
    topo = pc.Topology(8, 4)
    counts = np.array([3, 0, 5, 1, 4, 2, 0, 6])
    for variant in pc.dense_variants(collective, topo):
        plan = pc.build_dense_plan(collective, counts, topo, variant)
        recs = audit_dense_executor(pc.bind_dense(plan, "cpu"), plan, "cpu")
        reducing = sum(1 for r in plan.rounds if r.reduce)
        edge = 1 if collective in ("allgatherv", "reduce_scatter") else 0
        assert len(recs) == 3 * len(plan.rounds) + reducing + edge
        other = next(v for v in pc.dense_variants(collective, topo)
                     if v != variant)
        foreign = pc.build_dense_plan(collective, counts, topo, other)
        with pytest.raises(VerifyError) as err:
            audit_dense_executor(pc.bind_dense(plan, "cpu"), foreign, "cpu")
        assert "round" in err.value.context


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_audit_refuses_foreign_plan(strategy):
    pat, topo = patterns(pc)["operator"]
    coll = pc.NeighborAlltoallV.init(pat, topo, strategy)
    other = next(s for s in STRATEGIES if s != strategy)
    foreign = pc.NeighborAlltoallV.init(pat, topo, other)
    with pytest.raises(VerifyError) as err:
        audit_executor(coll.bind("cpu"), foreign.device_plan, "cpu")
    assert {"step", "round", "rank"} <= set(err.value.context)


def swap_rounds(dplan):
    """The plan with the first two rounds of its first multi-round step
    swapped."""
    steps = [dataclasses.replace(st, rounds=list(st.rounds))
             for st in dplan.steps]
    st = next(st for st in steps if len(st.rounds) > 1)
    st.rounds[0], st.rounds[1] = st.rounds[1], st.rounds[0]
    return dataclasses.replace(dplan, steps=steps), st.name


def test_audit_refuses_swapped_round_order():
    pat, topo = patterns(pc)["operator"]
    coll = pc.NeighborAlltoallV.init(pat, topo, "standard")
    bad, step = swap_rounds(coll.device_plan)
    fn = pc.make_executor(bad, "cpu")
    audit_executor(fn, bad, "cpu")          # right for its own plan
    with pytest.raises(VerifyError) as err:
        audit_executor(fn, coll.device_plan, "cpu")
    assert err.value.context["step"] == step
    assert err.value.context["round"] == 0 and "rank" in err.value.context
    # the dense schedule's round order too
    plan = pc.build_dense_plan("allreduce", np.arange(1, 9), topo, "ring")
    bad_dense = dataclasses.replace(
        plan, rounds=[plan.rounds[1], plan.rounds[0], *plan.rounds[2:]])
    with pytest.raises(VerifyError):
        audit_dense_executor(pc.bind_dense(bad_dense, "cpu"), plan, "cpu")


def test_audit_refuses_swapped_scatter_index():
    pat, topo = patterns(pc)["small"]
    coll = pc.NeighborAlltoallV.init(pat, topo, "standard")
    dplan = coll.device_plan
    steps = [dataclasses.replace(st, rounds=list(st.rounds))
             for st in dplan.steps]
    st = next(st for st in steps if any(r.width > 1 for r in st.rounds))
    i = next(i for i, r in enumerate(st.rounds) if r.width > 1)
    sc = st.rounds[i].scatter.copy()
    q = int(np.argmax(sc[:, 0] != sc[:, 1]))
    sc[q, [0, 1]] = sc[q, [1, 0]]
    st.rounds[i] = dataclasses.replace(st.rounds[i], scatter=sc)
    bad = dataclasses.replace(dplan, steps=steps)
    with pytest.raises(VerifyError, match="scatter") as err:
        audit_executor(pc.make_executor(bad, "cpu"), dplan, "cpu")
    assert (err.value.context["rank"], err.value.context["slot"]) == (q, 0)


def test_audit_refuses_data_dependent_index_and_off_plan_ops():
    pat, topo = patterns(pc)["small"]
    coll = pc.NeighborAlltoallV.init(pat, topo, "standard")
    fn = coll.bind("cpu")

    def data_index(x):
        idx = x[..., 0].long()              # an index read from the data
        return fn(x)[:, idx[0]]

    with pytest.raises(VerifyError, match="depends on the data"):
        trace_indexing(data_index, torch.zeros(4, 3, 1))

    def off_plan(x):
        out = fn(x)
        return torch.gather(out, 1, torch.zeros_like(out, dtype=torch.long))

    with pytest.raises(VerifyError, match="off-plan"):
        trace_indexing(off_plan, torch.zeros(4, 3, 1))

    def wrong_shape(x):
        return fn(x[:, :2])

    with pytest.raises(VerifyError, match="bound to another plan"):
        audit_executor(wrong_shape, coll.device_plan, "cpu")
