"""The port's device SpMV layer against ``repro.sparse``: ELL conversions,
bucket maps and the flat-vs-blocked and overlap selectors must be equal;
the rank-stacked distributed SpMV must equal the host product at 1e-12.

The selectors carry device figures as explicit arguments in the port; the
tests pass the reference's own figures to both sides.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.amg import diffusion_2d
from repro.core import costmodel as ref_cost
from repro.sparse import device as ref_dev
from repro.sparse import partition as ref_part
from repro_torch.core import NeighborAlltoallV, Topology, plan_time
from repro_torch.sparse import device as dev
from repro_torch.sparse import partition as port_part
from repro_torch.sparse.csr import CSR

# the reference's figures, passed explicitly to the port's selectors
REF_LIMIT = ref_dev.VMEM_BYTES_PER_CORE // 2
REF_FIGURES = dict(hbm_bw=ref_cost.V5E_HBM_BW,
                   vpu_flops=ref_cost.V5E_VPU_FLOPS,
                   launch_s=ref_cost.KERNEL_LAUNCH_S)


def _parts(shape=(24, 40), n_procs=4):
    A = diffusion_2d(*shape)
    port_A = CSR(A.shape, A.indptr, A.indices, A.data)
    return (ref_part.partition_csr(A, n_procs),
            port_part.partition_csr(port_A, n_procs), A)


@pytest.fixture(scope="module")
def parts():
    return _parts()


def _assert_fields_equal(got, want, fields):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, f


def test_partition_equal(parts):
    rp, pp, _ = parts
    np.testing.assert_array_equal(pp.offsets, rp.offsets)
    for a, b in zip(pp.needs, rp.needs):
        np.testing.assert_array_equal(a, b)
    for blocks in ("local", "ghost"):
        for a, b in zip(getattr(pp, blocks), getattr(rp, blocks)):
            np.testing.assert_array_equal(a.indptr, b.indptr)
            np.testing.assert_array_equal(a.indices, b.indices)
            np.testing.assert_array_equal(a.data, b.data)


def test_flat_ell_equal(parts):
    rp, pp, _ = parts
    _assert_fields_equal(
        dev.partitioned_to_ell(pp), ref_dev.partitioned_to_ell(rp),
        ("n_procs", "row_pad", "in_pad", "ghost_pad", "local_cols",
         "local_vals", "ghost_cols", "ghost_vals"))


@pytest.mark.parametrize("block_cols", [16, 64])
def test_blocked_ell_and_bucket_maps_equal(parts, block_cols):
    rp, pp, _ = parts
    got = dev.partitioned_to_ell_blocked(pp, block_cols)
    want = ref_dev.partitioned_to_ell_blocked(rp, block_cols)
    _assert_fields_equal(got, want, (
        "n_procs", "row_pad", "in_pad", "ghost_pad", "block_cols",
        "n_local_buckets", "n_ghost_buckets", "K", "cols", "vals",
        "bucket_K"))
    C, Cl = got.n_buckets, got.n_local_buckets
    for window in ({}, {"bucket_hi": Cl}, {"bucket_lo": Cl}):
        for br in (16, 256):
            g = dev.row_block_bucket_map(got, block_rows=br, **window)
            w = ref_dev.row_block_bucket_map(want, block_rows=br, **window)
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    assert C == want.n_buckets


@pytest.mark.parametrize("variant", ["auto", "flat", "blocked"])
@pytest.mark.parametrize("limit", [REF_LIMIT, 4096])
def test_kernel_selection_equal(parts, variant, limit):
    rp, pp, _ = parts
    got = dev.select_spmv_kernel(pp, variant=variant, vmem_limit_bytes=limit)
    want = ref_dev.select_spmv_kernel(rp, variant=variant,
                                      vmem_limit_bytes=limit)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert str(got) == str(want)


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
@pytest.mark.parametrize("exchange_s", [0.0, 1e-7, 3e-5])
def test_overlap_selection_equal(parts, mode, exchange_s):
    rp, pp, _ = parts
    got = dev.select_spmv_overlap(pp, exchange_s, mode=mode, **REF_FIGURES)
    want = ref_dev.select_spmv_overlap(rp, exchange_s, mode=mode)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert str(got) == str(want)


def test_selectors_need_explicit_figures(parts):
    _, pp, _ = parts
    with pytest.raises(ValueError, match="vmem_limit_bytes"):
        dev.select_spmv_kernel(pp, variant="auto")
    with pytest.raises(ValueError, match="hbm_bw"):
        dev.select_spmv_overlap(pp, 1e-5, mode="auto")
    forced = dev.select_spmv_overlap(pp, 1e-5, mode="on")
    assert forced.mode == "on" and forced.forced
    assert np.isnan(forced.local_s) and np.isnan(forced.overhead_s)


def test_pack_unpack_round_trip(parts):
    _, pp, A = parts
    x = np.random.default_rng(0).normal(size=A.ncols)
    pad = int(np.diff(pp.col_offsets).max())
    packed = dev.pack_vector(pp.col_offsets, pad, x)
    np.testing.assert_array_equal(
        packed, ref_dev.pack_vector(pp.col_offsets, pad, x))
    np.testing.assert_array_equal(dev.unpack_vector(pp.col_offsets, packed),
                                  x)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("layout", ["flat", "blocked16", "blocked512"])
@pytest.mark.parametrize("strategy", ["standard", "partial", "full"])
def test_distributed_spmv_matches_host_product(strategy, layout, overlap):
    """Every layout x schedule x strategy on a rectangular operator (the
    restriction of a two-level hierarchy) and on the square operator."""
    from repro_torch.amg import build_hierarchy

    A = diffusion_2d(32, 48)
    h = build_hierarchy(CSR(A.shape, A.indptr, A.indices, A.data),
                        max_levels=2)
    rng = np.random.default_rng(3)
    topo = Topology(8, 4)
    for mat in (h.levels[0].A, h.levels[0].R):
        rows = port_part.block_offsets(mat.nrows, 8)
        cols = port_part.block_offsets(mat.ncols, 8)
        part = port_part.partition_rect_csr(mat, rows, cols)
        if layout == "flat":
            ell = dev.partitioned_to_ell(part)
        else:
            ell = dev.partitioned_to_ell_blocked(part, int(layout[7:]))
        coll = NeighborAlltoallV.init(part.pattern, topo, strategy)
        assert plan_time(coll.plan, ref_cost.LASSEN) >= 0.0
        fn = dev.make_distributed_spmv(ell, coll.bind("cpu"),
                                       overlap=overlap, device="cpu")
        x = rng.normal(size=mat.ncols)
        xg = torch.as_tensor(dev.pack_vector(part.col_offsets, ell.in_pad,
                                             x))
        y = dev.unpack_vector(part.offsets, fn(xg).numpy())
        np.testing.assert_allclose(y, mat.matvec(x), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("block_cols", [16, 512])
def test_distributed_spmv_blocked_takes_bucket_major_operands(
        monkeypatch, block_cols, overlap):
    """The blocked layouts of the test above reach K2-K4 bucket-major:
    every product reads one [P, C, R, K] copy of the operator, made when
    the function was built, equal to ``to_bucket_major`` of the host
    layout."""
    from repro_torch.amg import build_hierarchy
    from repro_torch.kernels.spmv_ell.ops import to_bucket_major

    A = diffusion_2d(32, 48)
    h = build_hierarchy(CSR(A.shape, A.indptr, A.indices, A.data),
                        max_levels=2)
    mat = h.levels[0].A
    part = port_part.partition_csr(mat, 8)
    ell = dev.partitioned_to_ell_blocked(part, block_cols)
    coll = NeighborAlltoallV.init(part.pattern, Topology(8, 4), "standard")
    seen = []
    for name in ("spmv_blocked", "spmv_blocked_partial",
                 "spmv_blocked_skip"):
        def record(cols, vals, *args, _fn=getattr(dev, name), **kw):
            seen.append((cols, vals))
            return _fn(cols, vals, *args, **kw)
        monkeypatch.setattr(dev, name, record)
    fn = dev.make_distributed_spmv(ell, coll.bind("cpu"), overlap=overlap,
                                   device="cpu")
    x = np.random.default_rng(5).normal(size=mat.ncols)
    xg = torch.as_tensor(dev.pack_vector(part.col_offsets, ell.in_pad, x))
    for _ in range(2):
        y = dev.unpack_vector(part.offsets, fn(xg).numpy())
        np.testing.assert_allclose(y, mat.matvec(x), rtol=1e-12, atol=1e-12)
    assert len(seen) == 2 * len(fn.kernels)
    want = [to_bucket_major(a, ell.n_buckets) for a in (ell.cols, ell.vals)]
    for cols, vals in seen:
        assert cols.shape == (8, ell.n_buckets, ell.row_pad, ell.K)
        assert cols.data_ptr() == seen[0][0].data_ptr()
        assert vals.data_ptr() == seen[0][1].data_ptr()
        for got, w in zip((cols, vals), want):
            assert torch.equal(got, w)


def test_distributed_spmv_requires_exchange_for_ghosts(parts):
    _, pp, _ = parts
    with pytest.raises(ValueError, match="exchange required"):
        dev.make_distributed_spmv(dev.partitioned_to_ell(pp), None,
                                  device="cpu")


@pytest.mark.parametrize("nnz,rows,x_len", [(0, 1, 1), (3663874, 65536, 65537),
                                           (1000, 10, 4000)])
@pytest.mark.parametrize("value_bytes", [4, 8])
def test_compute_and_overlap_terms_equal(nnz, rows, x_len, value_bytes):
    from repro_torch.core import costmodel as port_cost

    assert port_cost.spmv_compute_time(
        nnz, rows, x_len, hbm_bw=REF_FIGURES["hbm_bw"],
        vpu_flops=REF_FIGURES["vpu_flops"], value_bytes=value_bytes,
    ) == ref_cost.spmv_compute_time(nnz, rows, x_len,
                                    value_bytes=value_bytes)
    assert port_cost.overlap_split_overhead(
        rows, hbm_bw=REF_FIGURES["hbm_bw"],
        launch_s=REF_FIGURES["launch_s"], value_bytes=value_bytes,
    ) == ref_cost.overlap_split_overhead(rows, value_bytes=value_bytes)
    for tx, tl in ((0.0, 1e-6), (5e-6, 1e-6), (1e-4, 3e-4)):
        for mode in ("auto", "on", "off"):
            for has_ghost in (True, False):
                got = dev.overlap_decision(
                    tx, tl, rows=rows, value_bytes=value_bytes, mode=mode,
                    has_ghost=has_ghost, hbm_bw=REF_FIGURES["hbm_bw"],
                    launch_s=REF_FIGURES["launch_s"])
                want = ref_dev.overlap_decision(
                    tx, tl, rows=rows, value_bytes=value_bytes, mode=mode,
                    has_ghost=has_ghost)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("overlap", ["off", "on", "auto"])
@pytest.mark.parametrize("variant", ["flat", "blocked", "auto"])
def test_one_shot_distributed_spmv_matches_host_product(parts, variant,
                                                        overlap):
    """``distributed_spmv``: the one-shot product of a global vector, with
    the reference's figures passed for ``auto``."""
    _, pp, A = parts
    coll = NeighborAlltoallV.init(pp.pattern, Topology(4, 2), "auto")
    x = np.random.default_rng(5).normal(size=A.ncols)
    y = dev.distributed_spmv(pp, coll, x, variant=variant, block_cols=16,
                             overlap=overlap, vmem_limit_bytes=REF_LIMIT,
                             params=ref_cost.TPU_V5E, device="cpu",
                             **REF_FIGURES)
    np.testing.assert_allclose(y, A.matvec(x), rtol=1e-12, atol=1e-12)


def test_one_shot_distributed_spmv_needs_figures_for_auto(parts):
    _, pp, A = parts
    coll = NeighborAlltoallV.init(pp.pattern, Topology(4, 2), "standard")
    x = np.zeros(A.ncols)
    with pytest.raises(ValueError, match="vmem_limit_bytes"):
        dev.distributed_spmv(pp, coll, x, variant="auto", device="cpu")
    with pytest.raises(ValueError, match="hbm_bw"):
        dev.distributed_spmv(pp, coll, x, overlap="auto", device="cpu")
    with pytest.raises(ValueError, match="overlap mode"):
        dev.distributed_spmv(pp, coll, x, overlap="maybe", device="cpu")
