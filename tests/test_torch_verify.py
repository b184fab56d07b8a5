"""The port's static verifier (``repro_torch.verify``) against ``repro``'s.

Every planted fault of ``tests/test_verify.py`` is refused by both
packages, with the same rank, slot or bucket named, and every valid object
is accepted by both: patterns, plans (all three strategies), frozen device
plans, partitions, the flat and blocked ELL layouts, K4's bucket maps, the
kernel-budget estimators, the ``PlanCache`` insertion hooks under
``REPRO_VERIFY``, MoE plans and dispatch, and ``ServeEngine.verify()``.
The executor audit (``repro``'s jaxpr audit on a 4-device mesh, run in one
subprocess on 8 virtual devices; the port's rank-stacked audit in-process)
accepts each strategy's bound executor over the same rounds and refuses a
foreign plan.

Beyond ``repro``: a fault of the bucket-major ``[P, C, R, K]`` operands
that ``repro``'s ``[P, R, C*K]`` layout cannot express (the host form
reshaped instead of transposed), the card-limit checks of
``kernel_budget`` on recorded attributes, and the dense plans' verifier.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as rc
import repro.sparse as rs
import repro.verify as rv
from repro.core.costmodel import TPU_V5E
from repro.sparse.device import row_block_bucket_map as ref_bucket_map
from repro.sparse.device import select_spmv_kernel as ref_select
import repro_torch.core as pc
import repro_torch.sparse as ps
import repro_torch.verify as pv
from repro_torch.sparse.device import row_block_bucket_map
from repro_torch.sparse.device import select_spmv_kernel

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
NAMED = ("rank", "slot", "bucket", "ghost_slot", "row", "row_block", "src",
         "dst", "step", "round")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ objects


def small_pattern(core):
    needs = [np.array([4, 5, 9]), np.array([0, 8]), np.array([2]),
             np.array([1, 6])]
    return core.CommPattern.from_block_partition(needs, np.arange(5) * 3)


def small_partition(sparse, seed=0, n=24, n_procs=3):
    rng = np.random.default_rng(seed)
    nnz = 4 * n
    A = sparse.CSR.from_coo(rng.integers(0, n, nnz), rng.integers(0, n, nnz),
                            rng.normal(size=nnz), (n, n))
    return sparse.partition_csr(A, n_procs)


def both_refuse(ref_fn, port_fn, match=None):
    """Both calls raise their package's VerifyError naming the same
    rank / slot / bucket; returns the port's context."""
    with pytest.raises(rv.VerifyError, match=match) as want:
        ref_fn()
    with pytest.raises(pv.VerifyError, match=match) as got:
        port_fn()
    keys = [k for k in NAMED if k in want.value.context]
    assert keys, want.value
    for k in keys:
        assert got.value.context.get(k) == want.value.context[k], (
            k, got.value, want.value)
    return got.value.context


# ----------------------------------------------------------------- patterns


def test_pattern_accepts_valid():
    rv.verify_pattern(small_pattern(rc))
    pv.verify_pattern(small_pattern(pc))


def test_pattern_rejects_broken_ownership():
    pats = [small_pattern(rc), small_pattern(pc)]
    for pat in pats:
        pat.owner_slot[4] = pat.owner_slot[5]  # two values share one slot
    both_refuse(lambda: rv.verify_pattern(pats[0]),
                lambda: pv.verify_pattern(pats[1]), "share one local slot")


def test_pattern_rejects_out_of_range_need():
    pats = [small_pattern(rc), small_pattern(pc)]
    for pat in pats:
        pat.needs[2] = np.array([99])
    ctx = both_refuse(lambda: rv.verify_pattern(pats[0]),
                      lambda: pv.verify_pattern(pats[1]))
    assert ctx["rank"] == 2


# -------------------------------------------------------------------- plans


@pytest.mark.parametrize("strategy", ["standard", "partial", "full"])
def test_plan_accepts_all_strategies(strategy):
    rv.verify_plan(rc.build_plan(small_pattern(rc), rc.Topology(4, 2),
                                 strategy))
    pv.verify_plan(pc.build_plan(small_pattern(pc), pc.Topology(4, 2),
                                 strategy))


def _wire(plan, min_size=0):
    return [m for s in plan.steps for m in s.messages
            if m.src != m.dst and m.size > min_size]


def test_plan_rejects_dropped_delivery():
    plans = [rc.build_plan(small_pattern(rc), rc.Topology(4, 2), "standard"),
             pc.build_plan(small_pattern(pc), pc.Topology(4, 2), "standard")]
    for plan in plans:
        m = _wire(plan)[0]
        m.src_idx, m.dst_idx = m.src_idx[:-1], m.dst_idx[:-1]
    both_refuse(lambda: rv.verify_plan(plans[0]),
                lambda: pv.verify_plan(plans[1]), "never written")


def test_plan_rejects_duplicated_delivery():
    plans = [rc.build_plan(small_pattern(rc), rc.Topology(4, 2), "standard"),
             pc.build_plan(small_pattern(pc), pc.Topology(4, 2), "standard")]
    for plan in plans:
        m = _wire(plan, 1)[0]
        m.dst_idx = m.dst_idx.copy()
        m.dst_idx[1] = m.dst_idx[0]
    both_refuse(lambda: rv.verify_plan(plans[0]),
                lambda: pv.verify_plan(plans[1]), "same slot|more than once")


def test_collective_accepts_and_device_plan_checked():
    colls = [rc.NeighborAlltoallV.init(small_pattern(rc), rc.Topology(4, 2),
                                       "partial"),
             pc.NeighborAlltoallV.init(small_pattern(pc), pc.Topology(4, 2),
                                       "partial")]
    rv.verify_collective(colls[0])
    pv.verify_collective(colls[1])
    for coll in colls:
        step = next(s for s in coll.device_plan.steps if s.rounds)
        step.rounds[0].gather[0, 0] = 10 ** 6
    with pytest.raises(rv.VerifyError, match="sentinel"):
        rv.verify_collective(colls[0])
    with pytest.raises(pv.VerifyError, match="sentinel"):
        pv.verify_collective(colls[1])


# ---------------------------------------------------- partitions + layouts


def test_partition_and_layouts_accept():
    rpart, ppart = small_partition(rs), small_partition(ps)
    rv.verify_partition(rpart)
    pv.verify_partition(ppart)
    rv.verify_device_ell(rs.partitioned_to_ell(rpart), rpart)
    pv.verify_device_ell(ps.partitioned_to_ell(ppart), ppart)
    rb = rs.partitioned_to_ell_blocked(rpart, block_cols=8)
    pb = ps.partitioned_to_ell_blocked(ppart, block_cols=8)
    rv.verify_ell_blocked(rb, rpart)
    pv.verify_ell_blocked(pb, ppart)
    rv.verify_bucket_map(rb, block_rows=8)
    pv.verify_bucket_map(pb, block_rows=8)


def test_partition_rejects_dropped_ghost_column():
    parts = [small_partition(rs), small_partition(ps)]
    for part in parts:
        part.needs[0] = part.needs[0][:-1]
    ctx = both_refuse(lambda: rv.verify_partition(parts[0]),
                      lambda: pv.verify_partition(parts[1]))
    assert ctx["rank"] == 0


def test_ell_rejects_moved_nonzero():
    rpart, ppart = small_partition(rs), small_partition(ps)
    ells = [rs.partitioned_to_ell(rpart), ps.partitioned_to_ell(ppart)]
    for ell in ells:
        r, k = np.argwhere(ell.local_vals[0] != 0)[0]
        ell.local_vals[0, r, k] *= 2.0
    ctx = both_refuse(lambda: rv.verify_device_ell(ells[0], rpart),
                      lambda: pv.verify_device_ell(ells[1], ppart))
    assert ctx["rank"] == 0


def test_blocked_ell_rejects_nonzero_moved_across_buckets():
    """A nonzero moved into another bucket of its row: both layouts name
    the rank, the row and the slot (the port also the bucket)."""
    rpart, ppart = small_partition(rs), small_partition(ps)
    ells = [rs.partitioned_to_ell_blocked(rpart, block_cols=8),
            ps.partitioned_to_ell_blocked(ppart, block_cols=8)]
    for ell in ells:
        C, K = ell.n_buckets, ell.K
        v = ell.vals[1].reshape(ell.row_pad, C, K)
        r, b, k = np.argwhere(v != 0)[0]
        Cl = ell.n_local_buckets
        b2 = next(c for c in range(C) if c != b and v[r, c, K - 1] == 0
                  and (c < Cl) == (b < Cl))
        v[r, b2, K - 1], v[r, b, k] = v[r, b, k], 0.0
    ctx = both_refuse(lambda: rv.verify_ell_blocked(ells[0], rpart),
                      lambda: pv.verify_ell_blocked(ells[1], ppart))
    assert ctx["rank"] == 1 and "bucket" in ctx


def test_bucket_major_operands_reshaped_not_transposed_are_refused():
    """The port's own layout fault: the card's ``[P, C, R, K]`` operands
    made by reshaping the host ``[P, R, C*K]`` form instead of transposing
    it.  The same bytes are ``repro``'s correct layout, so only the
    bucket-major check can see it; it names the rank, row and bucket."""
    part = small_partition(ps)
    ell = ps.partitioned_to_ell_blocked(part, block_cols=8)
    shape = (ell.n_procs, ell.n_buckets, ell.row_pad, ell.K)
    good_c = ps.device.to_bucket_major(ell.cols, ell.n_buckets, "cpu")
    good_v = ps.device.to_bucket_major(ell.vals, ell.n_buckets, "cpu")
    pv.verify_ell_blocked(ell, part, good_c, good_v)
    bad_c = torch.as_tensor(ell.cols).reshape(shape)
    bad_v = torch.as_tensor(ell.vals).reshape(shape)
    with pytest.raises(pv.VerifyError) as err:
        pv.verify_ell_blocked(ell, part, bad_c, bad_v)
    assert {"rank", "row"} <= set(err.value.context) or \
        {"rank", "bucket"} <= set(err.value.context)
    rv.verify_ell_blocked(ell, part)          # the host form is right


def test_bucket_map_rejects_duplicated_bucket():
    maps = []
    for sparse, bmap in ((rs, ref_bucket_map), (ps, row_block_bucket_map)):
        ell = sparse.partitioned_to_ell_blocked(small_partition(sparse),
                                                block_cols=8)
        lists, counts = bmap(ell, block_rows=8)
        lists = np.concatenate([lists, np.zeros_like(lists[:, :, :1])], 2)
        p, rb = np.argwhere(counts > 0)[0]
        n = int(counts[p, rb])
        lists[p, rb, n] = lists[p, rb, n - 1]
        counts = counts.copy()
        counts[p, rb] = n + 1
        maps.append((ell, lists, counts))
    ctx = both_refuse(
        lambda: rv.check_bucket_map(*maps[0], block_rows=8),
        lambda: pv.check_bucket_map(*maps[1], block_rows=8),
        "accumulated twice")
    assert "bucket" in ctx


def test_bucket_map_rejects_missing_bucket():
    maps = []
    for sparse, bmap in ((rs, ref_bucket_map), (ps, row_block_bucket_map)):
        ell = sparse.partitioned_to_ell_blocked(small_partition(sparse),
                                                block_cols=8)
        lists, counts = bmap(ell, block_rows=8)
        p, rb = np.argwhere(counts > 0)[0]
        counts = counts.copy()
        counts[p, rb] -= 1                    # hide the last live bucket
        lists = lists.copy()
        lists[p, rb, int(counts[p, rb])] = 0  # restore padding invariant
        maps.append((ell, lists, counts))
    ctx = both_refuse(
        lambda: rv.check_bucket_map(*maps[0], block_rows=8),
        lambda: pv.check_bucket_map(*maps[1], block_rows=8), "dropped")
    assert "bucket" in ctx


def test_bucket_map_windows_accept():
    ell = ps.partitioned_to_ell_blocked(small_partition(ps), block_cols=8)
    assert ell.n_ghost_buckets
    for window in ({}, {"bucket_hi": ell.n_local_buckets},
                   {"bucket_lo": ell.n_local_buckets}):
        pv.verify_bucket_map(ell, block_rows=8, **window)


# ----------------------------------------------------------- kernel budgets


def test_kernel_budget_accepts_both_layouts():
    rpart, ppart = small_partition(rs), small_partition(ps)
    rv.verify_kernel_budget(rs.partitioned_to_ell(rpart), ref_select(rpart))
    rv.verify_kernel_budget(
        rs.partitioned_to_ell_blocked(rpart, block_cols=8),
        ref_select(rpart, block_cols=8))
    flat = pv.verify_kernel_budget(ps.partitioned_to_ell(ppart),
                                   select_spmv_kernel(ppart))
    blocked = pv.verify_kernel_budget(
        ps.partitioned_to_ell_blocked(ppart, block_cols=8),
        select_spmv_kernel(ppart, block_cols=8))
    assert flat["variant"] == "flat" and blocked["variant"] == "blocked"


def test_kernel_budget_rejects_underreported_selection():
    rpart, ppart = small_partition(rs), small_partition(ps)
    rsel = dataclasses.replace(ref_select(rpart, block_cols=8),
                               blocked_bytes=1)
    psel = dataclasses.replace(select_spmv_kernel(ppart, block_cols=8),
                               blocked_bytes=1)
    with pytest.raises(rv.VerifyError, match="under-reports"):
        rv.verify_kernel_budget(
            rs.partitioned_to_ell_blocked(rpart, block_cols=8), rsel)
    with pytest.raises(pv.VerifyError, match="under-reports"):
        pv.verify_kernel_budget(
            ps.partitioned_to_ell_blocked(ppart, block_cols=8), psel)


def test_kernel_budget_rejects_drifted_estimator(monkeypatch):
    """A launch retiled without its estimator (K1's thread block made 4x
    larger here) trips the check."""
    from repro_torch.verify import kernel_budget

    ell = ps.partitioned_to_ell(small_partition(ps, n=4096, n_procs=2))
    pv.verify_kernel_budget(ell)
    monkeypatch.setattr(kernel_budget, "K1_ROWS_PER_BLOCK", 4096)
    with pytest.raises(pv.VerifyError, match="drifted"):
        pv.verify_kernel_budget(ell, block_rows=256)


# ------------------------------------------------------ card limits (pure)

LIMITS = dict(regs_per_sm=65536, smem_per_block_optin=232448,
              smem_per_sm=233472, threads_per_sm=2048, sm_count=132,
              regs_per_block=65536)


def attrs(**kw):
    base = dict(name="combine_lanes_kernel<bf16,8>", source="moe_pack.cu",
                num_regs=40, static_smem=0, max_threads_per_block=128,
                local_bytes=0, threads=128, dyn_smem=16384, blocks_per_sm=12,
                min_blocks=12, max_dyn_smem=49152)
    return dict(base, **kw)


def test_kernel_attributes_accept_and_refuse():
    k7 = pv.flash_prefill_smem_bytes(2, 192)
    assert k7 == 4 * 64 * (192 + 8) * 2
    # float32 (attn_fwd_f32.cuh): Q's 32 rows, K and V of a 64-key step at
    # d 64, rows of d + 4 floats, and P's 32 rows of 64 + 8
    k7f = pv.flash_prefill_smem_bytes(4, 64)
    assert k7f == 4 * ((32 + 2 * 64) * (64 + 4) + 32 * (64 + 8))
    good = [attrs(), attrs(name="attn_prefill_kernel<bf16,192>",
                           source="flash_attention.cu", dyn_smem=k7,
                           max_dyn_smem=k7, blocks_per_sm=2, min_blocks=1),
            attrs(name="attn_prefill_f32_kernel<64>",
                  source="flash_attention.cu", dyn_smem=k7f,
                  max_dyn_smem=k7f, blocks_per_sm=4, min_blocks=4)]
    assert pv.check_kernel_attributes(good, LIMITS) == {
        "kernels": 3, "k7_head_dims": 2}
    faults = {
        "register file": attrs(num_regs=255, threads=512,
                               max_threads_per_block=512),
        "shared memory": attrs(dyn_smem=LIMITS["smem_per_block_optin"],
                               static_smem=64,
                               max_dyn_smem=LIMITS["smem_per_block_optin"]),
        "promises": attrs(blocks_per_sm=11),
        "larger than": attrs(threads=256),
        "dynamic shared memory than the kernel": attrs(max_dyn_smem=1024),
        "tiles": dict(good[1], dyn_smem=k7 + 16, max_dyn_smem=k7 + 16),
        "other dynamic shared memory": dict(good[2], dyn_smem=k7f - 16),
    }
    for match, bad in faults.items():
        with pytest.raises(pv.VerifyError, match=match) as err:
            pv.check_kernel_attributes([good[0], bad], LIMITS)
        assert err.value.context["kernel"] == bad["name"]


def test_build_log_registers_cross_check():
    log = ("ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z1av\n"
           "ptxas info    : Used 40 registers, 380 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'\n"
           "ptxas info    : Used 32 registers, 380 bytes cmem[0]\n")
    both = [attrs(num_regs=32, symbol="_Z1bv"),
            attrs(num_regs=40, name="gather", symbol="_Z1av")]
    assert pv.check_build_log_registers(both, "moe_pack.cu", log) == 2
    # a lost log is refused, not skipped
    with pytest.raises(pv.VerifyError, match="no ptxas") as err:
        pv.check_build_log_registers(both, "moe_pack.cu", "")
    assert err.value.context["source"] == "moe_pack.cu"
    with pytest.raises(pv.VerifyError, match="disagree") as err:
        pv.check_build_log_registers([attrs(num_regs=33, symbol="_Z1bv"),
                                      both[1]], "moe_pack.cu", log)
    assert err.value.context["kernel"] == both[0]["name"]
    # swapped counts keep the multiset but not the kernels' own counts
    with pytest.raises(pv.VerifyError, match="disagree"):
        pv.check_build_log_registers([dict(both[0], num_regs=40),
                                      dict(both[1], num_regs=32)],
                                     "moe_pack.cu", log)
    # a kernel of the build that the table does not list
    with pytest.raises(pv.VerifyError, match="missing from the kernel "
                       "table") as err:
        pv.check_build_log_registers(both[1:], "moe_pack.cu", log)
    assert err.value.context["symbol"] == "_Z1bv"
    # a table entry the build does not have
    with pytest.raises(pv.VerifyError, match="not in the build log"):
        pv.check_build_log_registers(
            both + [attrs(name="extra", symbol="_Z1cv")], "moe_pack.cu",
            log)


# -------------------------------------------------------------- dense plans


@pytest.mark.parametrize("collective", ["allreduce", "allgatherv",
                                        "reduce_scatter"])
def test_dense_plans_verify_and_refuse_a_dropped_round(collective):
    topo = pc.Topology(8, 4)
    counts = np.arange(1, 9)
    for variant in pc.dense_variants(collective, topo):
        rplan = rc.build_dense_plan(collective, counts,
                                    rc.Topology(8, 4), variant)
        pplan = pc.build_dense_plan(collective, counts, topo, variant)
        rv.verify_dense_plan(rplan)
        pv.verify_dense_plan(pplan)
        for plan in (rplan, pplan):
            plan.rounds = plan.rounds[:-1]
        both_refuse(lambda: rv.verify_dense_plan(rplan),
                    lambda: pv.verify_dense_plan(pplan))


# --------------------------------------------------------- executor audit

REFERENCE_AUDIT = r"""
import json, sys
import jax
import numpy as np
assert jax.device_count() == 8, jax.devices()
from repro.core import CommPattern, NeighborAlltoallV, Topology
from repro.verify import VerifyError, audit_executor
needs = [np.array([4, 5, 9]), np.array([0, 8]), np.array([2]),
         np.array([1, 6])]
pat = CommPattern.from_block_partition(needs, np.arange(5) * 3)
mesh = jax.make_mesh((4,), ("proc",), devices=jax.devices()[:4])
out = {}
for strategy in ("standard", "partial", "full"):
    coll = NeighborAlltoallV.init(pat, Topology(4, 2), strategy)
    fn = coll.bind(mesh, "proc")
    recs = audit_executor(fn, coll.device_plan, "proc")
    other = "standard" if strategy != "standard" else "partial"
    foreign = NeighborAlltoallV.init(pat, Topology(4, 2), other)
    try:
        audit_executor(fn, foreign.device_plan, "proc")
        refused = ""
    except VerifyError as e:
        refused = str(e)
    try:
        audit_executor(fn, coll.device_plan, "wrong_axis")
        axis = ""
    except VerifyError as e:
        axis = str(e)
    out[strategy] = dict(records=len(recs), rounds=coll.device_plan.n_rounds,
                         foreign=refused, axis=axis)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_audit():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    out = subprocess.run([sys.executable, "-c", REFERENCE_AUDIT], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("strategy", ["standard", "partial", "full"])
def test_audit_accepts_bound_executor_and_rejects_foreign_plan(
        reference_audit, strategy):
    want = reference_audit[strategy]
    assert want["foreign"] and "axis" in want["axis"]
    coll = pc.NeighborAlltoallV.init(small_pattern(pc), pc.Topology(4, 2),
                                     strategy)
    fn = coll.bind("cpu")
    recs = pv.audit_executor(fn, coll.device_plan, "cpu")
    # the same wire rounds as repro's ppermutes: four indexing ops a round
    # (gather, permutation read and write, scatter), two a local copy
    dplan = coll.device_plan
    local = sum(1 for st in dplan.steps if st.local_gather.shape[1])
    assert dplan.n_rounds == want["rounds"] == want["records"]
    assert len(recs) == 4 * dplan.n_rounds + 2 * local
    other = "standard" if strategy != "standard" else "partial"
    foreign = pc.NeighborAlltoallV.init(small_pattern(pc), pc.Topology(4, 2),
                                        other)
    with pytest.raises(pv.VerifyError):
        pv.audit_executor(fn, foreign.device_plan, "cpu")


# ------------------------------------------------------- PlanCache wiring


def test_cache_insertion_verifies_under_env(monkeypatch):
    monkeypatch.setenv("REPRO_VERIFY", "1")
    assert pv.verify_enabled() and rv.verify_enabled()
    for core, verify, params in ((rc, rv, TPU_V5E), (pc, pv, pc.LASSEN)):
        pat = small_pattern(core)
        cache = core.PlanCache()
        cache.collective(pat, core.Topology(4, 2), "partial")   # inserts
        bad = core.NeighborAlltoallV.init(pat, core.Topology(4, 2),
                                          "standard")
        m = [m for s in bad.plan.steps for m in s.messages if m.size > 0][0]
        m.src_idx, m.dst_idx = m.src_idx[:-1], m.dst_idx[:-1]
        key = core.cache.plan_cache_key(pat, core.Topology(4, 2), "corrupt",
                                        8, params)
        with pytest.raises(verify.VerifyError):
            cache._insert(cache._colls, key, bad, "collective")
        monkeypatch.setenv("REPRO_VERIFY", "0")
        assert not verify.verify_enabled()
        cache._insert(cache._colls, key, bad, "collective")   # no check
        monkeypatch.setenv("REPRO_VERIFY", "1")


def test_cache_executor_and_dense_executor_audited_under_env(monkeypatch):
    from repro_torch.obs import default_obs

    monkeypatch.setenv("REPRO_VERIFY", "1")
    obs = default_obs()
    obs.reset()
    obs.enable()
    try:
        cache = pc.PlanCache()
        pat = small_pattern(pc)
        fn = cache.executor(pat, pc.Topology(4, 2), "cpu", "partial")
        assert fn is cache.executor(pat, pc.Topology(4, 2), "cpu", "partial")
        plan, _sel = cache.dense_collective(
            "allgatherv", np.arange(1, 9), pc.Topology(8, 4), "hier",
            params=TPU_V5E)
        assert cache.dense_executor(plan, "cpu") is \
            cache.dense_executor(plan, "cpu")
        series = obs.snapshot()["histograms"]["plan_cache/verify_seconds"]
        by_ns = {r["labels"]["ns"]: r["count"] for r in series["series"]}
        assert by_ns == {"collective": 1, "executor": 1,
                         "executor_audit": 1, "dense_plan": 1,
                         "dense_executor": 1, "dense_executor_audit": 1}
    finally:
        obs.disable()
        obs.reset()


# ---------------------------------------------------------------------- MoE


def moe_meshes(*shape):
    from repro_torch.models import Mesh

    names = ("pod", "data", "model")[-len(shape):] if len(shape) > 2 \
        else ("data", "model")[-len(shape):]
    return (SimpleNamespace(axis_names=names, devices=np.empty(shape)),
            Mesh(names, shape))


def moe_cfgs():
    from repro.configs import reduced as ref_reduced
    from repro_torch.configs import reduced

    return ref_reduced("deepseek-v2-lite-16b"), reduced("deepseek-v2-lite-16b")


@pytest.mark.parametrize("mode", ["a2a", "hier", "hier_dedup"])
@pytest.mark.parametrize("shape", [(1, 8), (2, 1, 4)])
def test_moe_dispatch_verifies(mode, shape):
    from repro.models.moe import make_moe_plan as ref_make
    from repro_torch.models.moe import make_moe_plan

    (rcfg, pcfg), (rmesh, pmesh) = moe_cfgs(), moe_meshes(*shape)
    rv.verify_moe_dispatch(ref_make(rcfg, rmesh, 32, mode=mode), 32)
    pv.verify_moe_dispatch(make_moe_plan(pcfg, pmesh, 32, mode=mode), 32)


def test_moe_plan_rejects_broken_geometry():
    from repro.models.moe import make_moe_plan as ref_make
    from repro_torch.models.moe import make_moe_plan

    (rcfg, pcfg), (rmesh, pmesh) = moe_cfgs(), moe_meshes(1, 8)
    plans = [ref_make(rcfg, rmesh, 32, mode="hier"),
             make_moe_plan(pcfg, pmesh, 32, mode="hier")]
    bad = [dataclasses.replace(p, e_per_dev=p.e_per_dev + 1) for p in plans]
    for verify, plan in ((rv, bad[0]), (pv, bad[1])):
        with pytest.raises(verify.VerifyError, match="e_per_dev") as err:
            verify.verify_moe_plan(plan)
    assert err.value.context["e_per_dev"] == plans[1].e_per_dev + 1


def test_serve_engine_verify():
    from repro_torch.models import Model
    from repro_torch.serve import ServeEngine

    _rcfg, cfg = moe_cfgs()
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    model = Model(cfg, moe_mode="auto", moe_cap_factor=8.0,
                  machine_params=TPU_V5E, device="cpu")
    eng = ServeEngine(model, model.init_params(seed=0), batch_slots=2,
                      max_len=32)
    assert eng.verify() == {"moe_plans": 2}
    eng.moe_plan = dataclasses.replace(eng.moe_plan, capacity=0)
    with pytest.raises(pv.VerifyError, match="capacity"):
        eng.verify()
