"""Planning parity: the port's plans, cost model, selector, device plan,
fingerprints and rank-stacked executor against ``repro``'s on the patterns
of ``test_core_plan.py``.

Host planning must match exactly (same messages, counts, selected strategy,
index arrays, digests); the executor is a pure copy, so its ghosts must
equal ``CommPlan.execute_numpy``'s bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cache as ref_cache
from repro.core import collectives as ref_coll
from repro.core import costmodel as ref_cost
from repro.core import locality as ref_loc
from repro.core import plan as ref_plan
from repro.core import selection as ref_sel
from repro_torch.core import (
    LASSEN,
    NeighborAlltoallV,
    PlanCache,
    build_device_plan,
    build_plan,
    pattern_fingerprint,
    plan_time,
    select_plan,
)
from repro_torch.core import plan as port_plan
from repro_torch.core.collectives import pack_local_values, unpack_ghosts

STRATEGIES = ("standard", "partial", "full")


def random_needs(rng, n_procs=8, n_per=16, ghosts_per=10):
    """Block-partitioned values; each proc needs random remote+local
    indices (the generator of test_core_plan.random_pattern)."""
    offsets = np.arange(n_procs + 1) * n_per
    n_global = n_procs * n_per
    needs = []
    for _ in range(n_procs):
        k = rng.integers(0, ghosts_per + 1)
        needs.append(np.sort(rng.choice(n_global, size=k, replace=False)))
    return needs, offsets


def patterns():
    """(label, needs, offsets, n_procs, procs_per_region) cases."""
    out = []
    for seed in range(4):
        needs, offs = random_needs(np.random.default_rng(seed))
        out.append((f"random8-seed{seed}", needs, offs, 8, 4))
    needs, offs = random_needs(np.random.default_rng(5), 12, 16, 12)
    out.append(("random12", needs, offs, 12, 4))
    needs, offs = random_needs(np.random.default_rng(3), 16, 32, 24)
    out.append(("random16", needs, offs, 16, 4))
    offs = np.arange(9) * 8
    shared = np.arange(4)
    out.append(("max-dup", [np.array([], dtype=np.int64)] * 4
                + [shared.copy() for _ in range(4)], offs, 8, 4))
    out.append(("empty", [np.array([], dtype=np.int64)] * 8,
                np.arange(9) * 4, 8, 4))
    offs = np.arange(5) * 8
    out.append(("local-only", [offs[p] + np.array([1, 3]) for p in range(4)],
                offs, 4, 2))
    return out


CASES = patterns()
IDS = [c[0] for c in CASES]


def both(case):
    _, needs, offs, P, ppr = case
    return (
        ref_plan.CommPattern.from_block_partition(needs, offs),
        ref_plan.Topology(P, ppr),
        port_plan.CommPattern.from_block_partition(needs, offs),
        port_plan.Topology(P, ppr),
    )


def _assert_plans_equal(got, want):
    assert got.strategy == want.strategy
    assert len(got.steps) == len(want.steps)
    for gs, ws in zip(got.steps, want.steps):
        assert (gs.name, gs.reads_local, gs.writes_ghost) == \
            (ws.name, ws.reads_local, ws.writes_ghost)
        np.testing.assert_array_equal(gs.in_sizes, ws.in_sizes)
        np.testing.assert_array_equal(gs.out_sizes, ws.out_sizes)
        assert len(gs.messages) == len(ws.messages)
        for gm, wm in zip(gs.messages, ws.messages):
            assert (gm.src, gm.dst) == (wm.src, wm.dst)
            np.testing.assert_array_equal(gm.src_idx, wm.src_idx)
            np.testing.assert_array_equal(gm.dst_idx, wm.dst_idx)
    for gs, ws in zip(got.stats.steps, want.stats.steps):
        for f in ("intra_msgs", "inter_msgs", "intra_vals", "inter_vals"):
            np.testing.assert_array_equal(getattr(gs, f), getattr(ws, f))
    assert got.stats.totals() == want.stats.totals()


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_plans_messages_and_bytes_equal(case, strategy):
    rp, rt, pp, pt = both(case)
    _assert_plans_equal(build_plan(pp, pt, strategy),
                        ref_loc.build_plan(rp, rt, strategy))


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("machine", ["LASSEN", "TPU_V5E"])
def test_selector_and_modeled_times_equal(case, machine):
    """The same explicit machine model gives the same modeled times and the
    same selected strategy (the reference's figures are passed in)."""
    rp, rt, pp, pt = both(case)
    ref_params = getattr(ref_cost, machine)
    params = LASSEN if machine == "LASSEN" else ref_params
    got, rep = select_plan(pp, pt, params=params)
    want, ref_rep = ref_sel.select_plan(rp, rt, params=ref_params)
    assert rep.chosen == ref_rep.chosen
    assert rep.modeled_times == pytest.approx(ref_rep.modeled_times,
                                              rel=0, abs=0)
    _assert_plans_equal(got, want)
    assert plan_time(got, params) == ref_cost.plan_time(want, ref_params)


def test_lassen_is_the_papers_machine_model():
    import dataclasses

    assert dataclasses.asdict(LASSEN) == dataclasses.asdict(ref_cost.LASSEN)


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_device_plan_equal_field_by_field(case, strategy):
    rp, rt, pp, pt = both(case)
    got = build_device_plan(build_plan(pp, pt, strategy))
    want = ref_coll.build_device_plan(ref_loc.build_plan(rp, rt, strategy))
    assert (got.strategy, got.n_procs, got.n_local_pad, got.ghost_pad) == \
        (want.strategy, want.n_procs, want.n_local_pad, want.ghost_pad)
    assert (got.n_rounds, got.padded_wire_values) == \
        (want.n_rounds, want.padded_wire_values)
    assert len(got.steps) == len(want.steps)
    for gs, ws in zip(got.steps, want.steps):
        assert (gs.name, gs.reads_local, gs.writes_ghost, gs.in_pad,
                gs.out_pad) == (ws.name, ws.reads_local, ws.writes_ghost,
                                ws.in_pad, ws.out_pad)
        np.testing.assert_array_equal(gs.local_gather, ws.local_gather)
        np.testing.assert_array_equal(gs.local_scatter, ws.local_scatter)
        assert len(gs.rounds) == len(ws.rounds)
        for gr, wr in zip(gs.rounds, ws.rounds):
            assert gr.perm == wr.perm and gr.width == wr.width
            assert gr.gather.dtype == wr.gather.dtype
            np.testing.assert_array_equal(gr.gather, wr.gather)
            np.testing.assert_array_equal(gr.scatter, wr.scatter)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_pattern_fingerprint_equal(case):
    rp, _, pp, _ = both(case)
    assert pattern_fingerprint(pp) == ref_cache.pattern_fingerprint(rp)


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("d", [1, 3])
def test_executor_ghosts_equal_execute_numpy(case, strategy, d):
    """The rank-stacked executor on the CPU delivers exactly the host
    oracle's ghosts (also the reference plan's oracle)."""
    rp, rt, pp, pt = both(case)
    coll = NeighborAlltoallV.init(pp, pt, strategy)
    rng = np.random.default_rng(17)
    local = [rng.normal(size=(int(n), d)) for n in pp.n_local]
    x = torch.as_tensor(pack_local_values(coll.plan, local))
    got = unpack_ghosts(coll.plan, coll.bind("cpu")(x))
    want = coll(local)
    oracle = ref_loc.build_plan(rp, rt, strategy).execute_numpy(local)
    for g, w, o in zip(got, want, oracle):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, o)


def test_executor_rejects_wrong_shape():
    _, needs, offs, P, ppr = CASES[0]
    pattern = port_plan.CommPattern.from_block_partition(needs, offs)
    coll = NeighborAlltoallV.init(pattern, port_plan.Topology(P, ppr),
                                  "full")
    with pytest.raises(ValueError, match="expected"):
        coll.bind("cpu")(torch.zeros(P, 3, 1, dtype=torch.float64))


def test_plan_cache_hits_and_lru():
    """A repeated init re-plans nothing; executors are cached per device;
    the LRU bound evicts the least recently used entry."""
    cache = PlanCache(max_entries=2)
    cases = [both(c) for c in CASES[:3]]
    colls = [cache.collective(pp, pt, "auto") for _, _, pp, pt in cases[:2]]
    assert (cache.misses, cache.hits) == (2, 0)
    again = cache.collective(cases[0][2], cases[0][3], "auto")
    assert again is colls[0] and cache.hits == 1
    assert cache.init_seconds_saved > 0.0
    fn = cache.executor(cases[0][2], cases[0][3], "cpu", "auto")
    assert cache.executor(cases[0][2], cases[0][3], "cpu", "auto") is fn
    assert (cache.exec_misses, cache.exec_hits) == (1, 1)
    cache.collective(cases[2][2], cases[2][3], "auto")   # evicts case 1
    assert cache.evictions == 1
    cache.collective(cases[1][2], cases[1][3], "auto")
    assert cache.misses == 4
    stats = cache.stats()
    assert stats["namespaces"]["collective"]["entries"] == 2
    assert stats["namespaces"]["executor"]["entries"] == 1
