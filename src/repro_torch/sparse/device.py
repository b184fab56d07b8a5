"""Device-resident distributed SpMV: padded ELL blocks + plan executor.

This is the device half of the paper's workload: the persistent neighborhood
collective (``core.collectives``) delivers ghost values and the ``spmv_ell``
kernels multiply the per-rank local and ghost blocks.  The ranks are stacked
along the leading dim of every tensor on one device, and each rank's blocks
are padded to uniform sizes so one kernel launch serves all ranks.

Two device layouts:

* **flat** (:class:`DeviceEll`): ``cols``/``vals`` ``[P, row_pad, K]`` with
  padding entries pointing at a sentinel slot (index ``in_pad`` resp.
  ``ghost_pad``) that the product materializes as an appended zero.

* **column-blocked** (:class:`DeviceEllBlocked`): each row's nonzeros are
  reordered into column buckets of ``block_cols`` x entries; local columns
  fill the leading buckets, ghost columns the *trailing* buckets, so the
  halo-dependent partial products come last.  Per-bucket nonzero widths
  (``bucket_K``) are padded to one uniform K; padding entries are
  (in-bucket col 0, val 0.0).  The host form keeps the reference's
  ``[P, R, C*K]``; the card holds it bucket-major, ``[P, C, R, K]``
  (:func:`~repro_torch.kernels.spmv_ell.ops.to_bucket_major`), made once
  when :func:`make_distributed_spmv` moves it there.

Vectors are ``[P, pad]`` tensors as produced from :func:`pack_vector`,
zero-padded per block.

Entry points:

* :func:`partitioned_to_ell` / :func:`partitioned_to_ell_blocked`:
  ``PartitionedCSR ->`` device form conversions (numpy);
* :func:`select_spmv_kernel`: modeled-footprint flat-vs-blocked choice,
  against a limit the caller supplies;
* :func:`make_distributed_spmv`: build ``fn(x [P, in_pad]) -> y [P,
  row_pad]`` composing exchange + ELL matvec(s) for either layout.  With
  ``overlap=True`` the exchange runs on a side CUDA stream while the local
  buckets (which do not depend on it) accumulate on the current stream,
  and a carried-output kernel consumes the ghost buckets once the current
  stream has waited for the side stream;
* :func:`select_spmv_overlap`: cost-model overlap on/off choice
  (:class:`OverlapSelection`), from figures the caller supplies;
* :func:`row_block_bucket_map`: per-row-block live-bucket lists for the
  bucket-skipping kernel (shared by the fused and overlapped schedules);
* :func:`distributed_spmv`: the one-shot product of a global numpy vector.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..core.costmodel import (
    LASSEN,
    exposed_exchange_seconds,
    hidden_fraction,
    overlap_split_overhead,
    plan_time,
    spmv_compute_time,
)
from ..kernels.spmv_ell import DEFAULT_BLOCK_COLS, DEFAULT_BLOCK_ROWS
from ..kernels.spmv_ell.ops import (
    spmv,
    spmv_blocked,
    spmv_blocked_partial,
    spmv_blocked_skip,
    to_bucket_major,
)
from .csr import CSR
from .partition import PartitionedCSR


@dataclass
class DeviceEll:
    """Stacked per-process padded-ELL blocks of a partitioned operator."""

    n_procs: int
    row_pad: int     # uniform padded rows per process (== output vector pad)
    in_pad: int      # uniform padded input-vector block size
    ghost_pad: int   # uniform padded ghost count (0 => no exchange needed)
    local_cols: np.ndarray   # [P, row_pad, Kl] int32; pad -> in_pad sentinel
    local_vals: np.ndarray   # [P, row_pad, Kl]
    ghost_cols: np.ndarray   # [P, row_pad, Kg] int32; pad -> ghost_pad
    ghost_vals: np.ndarray   # [P, row_pad, Kg]


def _ell_block(
    m: CSR, row_pad: int, K: int, pad_col: int, dtype
) -> tuple:
    cols = np.full((row_pad, K), pad_col, dtype=np.int32)
    vals = np.zeros((row_pad, K), dtype=dtype)
    if m.nnz:
        rows = m.row_indices()
        pos = np.arange(m.nnz, dtype=np.int64) - m.indptr[rows]
        cols[rows, pos] = m.indices
        vals[rows, pos] = m.data
    return cols, vals


def partitioned_to_ell(part: PartitionedCSR, dtype=np.float64) -> DeviceEll:
    """Convert each process's local/ghost CSR blocks to uniformly padded ELL.

    Row padding matches the owning vector layout (max block size), so the
    output of the matvec IS the next op's input vector — no repacking
    between levels of a solve.
    """
    P_ = part.n_procs
    row_pad = int(np.diff(part.offsets).max())
    in_pad = int(np.diff(part.col_offsets).max())
    ghost_pad = int(max((len(n) for n in part.needs), default=0))
    Kl = max(
        max((int(np.diff(m.indptr).max()) for m in part.local if m.nnz),
            default=0), 1,
    )
    Kg = max(
        max((int(np.diff(m.indptr).max()) for m in part.ghost if m.nnz),
            default=0), 1,
    )
    lc = np.empty((P_, row_pad, Kl), dtype=np.int32)
    lv = np.empty((P_, row_pad, Kl), dtype=dtype)
    gc = np.empty((P_, row_pad, Kg), dtype=np.int32)
    gv = np.empty((P_, row_pad, Kg), dtype=dtype)
    for p in range(P_):
        lc[p], lv[p] = _ell_block(part.local[p], row_pad, Kl, in_pad, dtype)
        gc[p], gv[p] = _ell_block(part.ghost[p], row_pad, Kg, ghost_pad, dtype)
    return DeviceEll(P_, row_pad, in_pad, ghost_pad, lc, lv, gc, gv)


@dataclass
class DeviceEllBlocked:
    """Column-bucketed padded-ELL blocks for the blocked SpMV kernel.

    One structure covers local *and* ghost columns: the per-device gather
    space is ``[local values | zero-fill to bucket edge | ghost values |
    zero-fill]`` of length ``n_buckets * block_cols``; bucket ``j`` of
    ``cols``/``vals`` (columns [j*K, (j+1)*K)) holds in-bucket indices into
    x slice ``j``.  Ghost columns occupy the trailing ``n_ghost_buckets``
    buckets, so halo-dependent work runs in the kernel's last accumulation
    steps.
    """

    n_procs: int
    row_pad: int     # uniform padded rows per process (== output vector pad)
    in_pad: int      # uniform padded input-vector block size
    ghost_pad: int   # uniform padded ghost count (0 => no exchange needed)
    block_cols: int
    n_local_buckets: int
    n_ghost_buckets: int
    K: int                   # uniform per-bucket padded width (max bucket_K)
    cols: np.ndarray         # [P, row_pad, n_buckets*K] int32 in-bucket idx
    vals: np.ndarray         # [P, row_pad, n_buckets*K]
    bucket_K: np.ndarray     # [n_buckets] max nnz of each bucket pre-padding

    @property
    def n_buckets(self) -> int:
        return self.n_local_buckets + self.n_ghost_buckets

    @property
    def x_len(self) -> int:
        return self.n_buckets * self.block_cols


def _bucket_positions(rows: np.ndarray, buckets: np.ndarray, n_buckets: int):
    """Occurrence index of each entry within its (row, bucket) group."""
    key = rows.astype(np.int64) * n_buckets + buckets
    order = np.argsort(key, kind="stable")
    ks = key[order]
    new = np.concatenate([[True], ks[1:] != ks[:-1]])
    starts = np.flatnonzero(new)
    group = np.cumsum(new) - 1
    pos_sorted = np.arange(len(key)) - starts[group]
    pos = np.empty(len(key), dtype=np.int64)
    pos[order] = pos_sorted
    return pos


def _bucketed(m: CSR, bc: int, bucket0: int):
    """CSR block entries as (rows, buckets, in-bucket cols, vals)."""
    if not m.nnz:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, np.zeros(0)
    rows = m.row_indices().astype(np.int64)
    cols = m.indices.astype(np.int64)
    return rows, bucket0 + cols // bc, cols % bc, m.data


def partitioned_to_ell_blocked(
    part: PartitionedCSR,
    block_cols: int = DEFAULT_BLOCK_COLS,
    dtype=np.float64,
) -> DeviceEllBlocked:
    """Convert a partition to the column-bucketed blocked-ELL device form.

    Row padding matches :func:`partitioned_to_ell` so the two layouts are
    interchangeable level by level.  Each row's nonzeros are reordered into
    column buckets (local buckets first, ghost buckets trailing); per-bucket
    widths are recorded in ``bucket_K`` and padded to their max so every
    bucket has the same width K.
    """
    P_ = part.n_procs
    bc = int(block_cols)
    assert bc > 0, bc
    row_pad = int(np.diff(part.offsets).max())
    in_pad = int(np.diff(part.col_offsets).max())
    ghost_pad = int(max((len(n) for n in part.needs), default=0))
    Cl = max(-(-in_pad // bc), 1)
    Cg = -(-ghost_pad // bc)
    C = Cl + Cg

    entries = []
    bucket_K = np.zeros(C, dtype=np.int64)
    for p in range(P_):
        rows_l, b_l, c_l, v_l = _bucketed(part.local[p], bc, 0)
        rows_g, b_g, c_g, v_g = _bucketed(part.ghost[p], bc, Cl)
        rows = np.concatenate([rows_l, rows_g])
        buckets = np.concatenate([b_l, b_g])
        incols = np.concatenate([c_l, c_g])
        vals = np.concatenate([v_l, v_g])
        entries.append((rows, buckets, incols, vals))
        if len(rows):
            cnt = np.bincount(rows * C + buckets, minlength=row_pad * C)
            bucket_K = np.maximum(bucket_K, cnt.reshape(row_pad, C).max(0))
    K = max(int(bucket_K.max()), 1)

    cols = np.zeros((P_, row_pad, C * K), dtype=np.int32)
    vals_out = np.zeros((P_, row_pad, C * K), dtype=dtype)
    for p, (rows, buckets, incols, vals) in enumerate(entries):
        if not len(rows):
            continue
        pos = _bucket_positions(rows, buckets, C)
        slot = buckets * K + pos
        cols[p, rows, slot] = incols
        vals_out[p, rows, slot] = vals
    return DeviceEllBlocked(
        P_, row_pad, in_pad, ghost_pad, bc, Cl, Cg, K, cols, vals_out,
        bucket_K,
    )


# --------------------------------------------------------------- selection
_IDX_BYTES = 4  # int32 column indices


def spmv_flat_vmem_bytes(
    *,
    in_pad: int,
    ghost_pad: int,
    k_local: int,
    k_ghost: int,
    value_bytes: int = 8,
    rows: Optional[int] = None,
    block_rows: int = DEFAULT_BLOCK_ROWS,
) -> int:
    """Modeled per-rank fast-memory residency of the flat SpMV path.

    The flat path is two products (local + ghost); the budget sums both:
    both x vectors and both double-buffered cols/vals streams resident at
    once.  ``rows`` clamps the row block (``min(block_rows, R)``).
    """
    br = min(int(block_rows), int(rows)) if rows else int(block_rows)
    x_bytes = (in_pad + 1 + ghost_pad + (1 if ghost_pad else 0)) * value_bytes
    stream = 2 * br * (k_local + k_ghost) * (_IDX_BYTES + value_bytes)
    out = br * value_bytes
    return int(x_bytes + stream + out)


def spmv_blocked_vmem_bytes(
    *,
    bucket_k: int,
    value_bytes: int = 8,
    rows: Optional[int] = None,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    block_cols: int = DEFAULT_BLOCK_COLS,
) -> int:
    """Modeled per-rank fast-memory residency of the column-blocked SpMV
    path: one x bucket + one cols/vals bucket block, double-buffered,
    independent of the x length."""
    br = min(int(block_rows), int(rows)) if rows else int(block_rows)
    bc = int(block_cols)
    x_bytes = 2 * bc * value_bytes
    stream = 2 * br * bucket_k * (_IDX_BYTES + value_bytes)
    out = br * value_bytes
    return int(x_bytes + stream + out)


@dataclass(frozen=True)
class KernelSelection:
    """The flat-vs-blocked choice for one operator, recorded alongside the
    plan's Section-5 transport choice so both selections are inspectable."""

    variant: str            # "flat" | "blocked"
    flat_bytes: int         # modeled flat footprint
    blocked_bytes: int      # modeled blocked footprint (bucket-K upper bound)
    limit_bytes: Optional[int]  # threshold of an auto choice (None if forced
    #                             without one)
    forced: bool = False    # True when the variant was pinned, not selected

    def __str__(self) -> str:
        how = "forced" if self.forced else "auto"
        limit = ("none" if self.limit_bytes is None
                 else f"{self.limit_bytes / 2**10:.0f}KiB")
        return (
            f"kernel={self.variant} ({how}) "
            f"flat={self.flat_bytes / 2**10:.0f}KiB "
            f"blocked={self.blocked_bytes / 2**10:.0f}KiB "
            f"limit={limit}"
        )


def _ell_widths(part: PartitionedCSR) -> tuple:
    kl = max(
        max((int(np.diff(m.indptr).max()) for m in part.local if m.nnz),
            default=0), 1,
    )
    kg = max(
        max((int(np.diff(m.indptr).max()) for m in part.ghost if m.nnz),
            default=0), 1,
    )
    return kl, kg


def select_spmv_kernel(
    part: PartitionedCSR,
    *,
    variant: str = "flat",
    vmem_limit_bytes: Optional[int] = None,
    value_bytes: int = 8,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    block_cols: int = DEFAULT_BLOCK_COLS,
) -> KernelSelection:
    """Choose the SpMV device layout for one partitioned operator.

    ``variant="auto"`` compares the modeled flat footprint (whole x
    resident) against ``vmem_limit_bytes``, which the caller must supply,
    and falls over to the blocked kernel when it does not fit;
    ``"flat"``/``"blocked"`` pin the choice (recorded as forced).  The
    blocked estimate uses the max row width as a bucket-K upper bound.
    """
    if variant not in ("auto", "flat", "blocked"):
        raise ValueError(f"unknown spmv variant {variant!r}")
    if variant == "auto" and vmem_limit_bytes is None:
        raise ValueError("spmv variant 'auto' needs vmem_limit_bytes")
    limit = None if vmem_limit_bytes is None else int(vmem_limit_bytes)
    row_pad = int(np.diff(part.offsets).max())
    in_pad = int(np.diff(part.col_offsets).max())
    ghost_pad = int(max((len(n) for n in part.needs), default=0))
    kl, kg = _ell_widths(part)
    flat = spmv_flat_vmem_bytes(
        in_pad=in_pad, ghost_pad=ghost_pad, k_local=kl, k_ghost=kg,
        value_bytes=value_bytes, rows=row_pad, block_rows=block_rows,
    )
    blocked = spmv_blocked_vmem_bytes(
        bucket_k=max(kl, kg), value_bytes=value_bytes,
        rows=row_pad, block_rows=block_rows, block_cols=block_cols,
    )
    if variant == "auto":
        return KernelSelection(
            "flat" if flat <= limit else "blocked", flat, blocked, limit
        )
    return KernelSelection(variant, flat, blocked, limit, forced=True)


def row_block_bucket_map(
    ell: DeviceEllBlocked,
    *,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    bucket_lo: int = 0,
    bucket_hi: Optional[int] = None,
) -> tuple:
    """Per-row-block live-bucket lists for the bucket-skipping kernel.

    Returns ``(lists [P, NRB, M] int32, counts [P, NRB] int32)`` where row
    block ``i`` of process ``p`` touches exactly the buckets
    ``lists[p, i, :counts[p, i]]`` (absolute bucket ids, ascending) within
    the window [bucket_lo, bucket_hi).  ``M`` is the global max count
    (min 1); padding entries hold ``bucket_lo`` and add nothing.  The row
    blocking mirrors the kernel's thread blocks (``min(block_rows,
    row_pad)`` rows, the trailing block ragged), so the lists line up with
    them.  The overlap schedule builds one map per
    phase from the same call with the phase's bucket window.
    """
    C, K = ell.n_buckets, ell.K
    lo = int(bucket_lo)
    hi = C if bucket_hi is None else int(bucket_hi)
    assert 0 <= lo < hi <= C, (lo, hi, C)
    R = ell.row_pad
    br = min(int(block_rows), R)
    pad = (-R) % br
    nrb = (R + pad) // br
    W = hi - lo
    live = (ell.vals.reshape(ell.n_procs, R, C, K) != 0).any(-1)[:, :, lo:hi]
    if pad:
        live = np.concatenate(
            [live, np.zeros((ell.n_procs, pad, W), bool)], axis=1
        )
    live_rb = live.reshape(ell.n_procs, nrb, br, W).any(2)   # [P, NRB, W]
    counts = live_rb.sum(-1).astype(np.int32)
    M = max(int(counts.max()), 1)
    lists = np.full((ell.n_procs, nrb, M), lo, dtype=np.int32)
    for p in range(ell.n_procs):
        for rb in range(nrb):
            idx = np.flatnonzero(live_rb[p, rb])
            lists[p, rb, : len(idx)] = idx + lo
    return lists, counts


@dataclass(frozen=True)
class OverlapSelection:
    """The exchange/compute-overlap choice for one operator, recorded on
    ``DistOp`` next to the Section-5 transport and flat-vs-blocked kernel
    selections.  Times are cost-model estimates (NaN where the caller gave
    no device figures)."""

    mode: str              # "on" | "off"
    exchange_s: float      # exchange time tx (full collective)
    local_s: float         # local-bucket compute time tl
    exposed_s: float       # exchange time left exposed by this choice
    hidden_frac: float     # fraction of tx hidden behind local compute
    overhead_s: float      # split cost (carried-y traffic + extra launch)
    forced: bool = False   # True when the mode was pinned, not selected

    def __str__(self) -> str:
        how = "forced" if self.forced else "auto"
        return (
            f"overlap={self.mode} ({how}) "
            f"tx={self.exchange_s * 1e6:.1f}us "
            f"local={self.local_s * 1e6:.1f}us "
            f"exposed={self.exposed_s * 1e6:.1f}us "
            f"hidden={self.hidden_frac:.0%} "
            f"overhead={self.overhead_s * 1e6:.1f}us"
        )


def overlap_decision(
    exchange_s: float,
    local_s: float,
    *,
    rows: int,
    value_bytes: int = 8,
    mode: str = "off",
    has_ghost: bool = True,
    hbm_bw: Optional[float] = None,
    launch_s: Optional[float] = None,
) -> OverlapSelection:
    """Decide overlap on/off from an exchange time and a local compute time.

    The split schedule hides ``min(tx, tl)`` of the exchange but pays
    ``overlap_split_overhead`` (the carried output makes one extra memory
    round trip at ``hbm_bw``, plus a kernel launch of ``launch_s``).
    ``auto`` turns overlap on iff the hidden time beats that overhead, and
    needs both figures; a fully local operator (no ghosts) has nothing to
    hide and is always ``off``.
    """
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"unknown overlap mode {mode!r}")
    if hbm_bw is None or launch_s is None:
        if mode == "auto":
            raise ValueError("overlap 'auto' needs hbm_bw and launch_s")
        overhead = math.nan
    else:
        overhead = overlap_split_overhead(
            rows, hbm_bw=hbm_bw, launch_s=launch_s, value_bytes=value_bytes
        )
    tx, tl = float(exchange_s), float(local_s)
    if mode == "auto":
        on = has_ghost and (tx - exposed_exchange_seconds(tx, tl)) > overhead
    else:
        on = mode == "on" and has_ghost
    if on:
        return OverlapSelection(
            "on", tx, tl, exposed_exchange_seconds(tx, tl),
            hidden_fraction(tx, tl), overhead, forced=(mode != "auto"),
        )
    return OverlapSelection(
        "off", tx, tl, tx if has_ghost else 0.0, 0.0, overhead,
        forced=(mode != "auto"),
    )


def select_spmv_overlap(
    part: PartitionedCSR,
    exchange_seconds: float,
    *,
    mode: str = "off",
    value_bytes: int = 8,
    hbm_bw: Optional[float] = None,
    vpu_flops: Optional[float] = None,
    launch_s: Optional[float] = None,
) -> OverlapSelection:
    """Choose the overlap schedule for one partitioned operator.

    ``exchange_seconds`` is the modeled (``core.costmodel.plan_time``) or
    measured full-exchange time; the local compute time comes from the
    roofline compute model over the worst per-rank local block, at the
    device figures ``hbm_bw`` (B/s) and ``vpu_flops`` (flop/s).
    """
    row_pad = int(np.diff(part.offsets).max())
    in_pad = int(np.diff(part.col_offsets).max())
    ghost_pad = int(max((len(n) for n in part.needs), default=0))
    nnz_local = max((m.nnz for m in part.local), default=0)
    if hbm_bw is None or vpu_flops is None:
        local_s = math.nan
    else:
        local_s = spmv_compute_time(
            nnz_local, row_pad, in_pad, hbm_bw=hbm_bw, vpu_flops=vpu_flops,
            value_bytes=value_bytes,
        )
    return overlap_decision(
        float(exchange_seconds), local_s, rows=row_pad,
        value_bytes=value_bytes, mode=mode, has_ghost=ghost_pad > 0,
        hbm_bw=hbm_bw, launch_s=launch_s,
    )


def partitioned_to_device(
    part: PartitionedCSR,
    selection: KernelSelection,
    dtype=np.float64,
    block_cols: int = DEFAULT_BLOCK_COLS,
) -> Union[DeviceEll, "DeviceEllBlocked"]:
    """Convert a partition to the device form the selection calls for."""
    if selection.variant == "blocked":
        return partitioned_to_ell_blocked(part, block_cols, dtype)
    return partitioned_to_ell(part, dtype)


def pack_vector(offsets: np.ndarray, pad: int, x: np.ndarray) -> np.ndarray:
    """Global vector -> [P, pad] block layout (zero padding)."""
    P_ = len(offsets) - 1
    out = np.zeros((P_, pad), dtype=x.dtype)
    for p in range(P_):
        lo, hi = int(offsets[p]), int(offsets[p + 1])
        out[p, : hi - lo] = x[lo:hi]
    return out


def unpack_vector(offsets: np.ndarray, y: np.ndarray) -> np.ndarray:
    """[P, pad] block layout -> global vector."""
    P_ = len(offsets) - 1
    return np.concatenate(
        [
            np.asarray(y[p, : int(offsets[p + 1]) - int(offsets[p])])
            for p in range(P_)
        ]
    )




# ------------------------------------------------------------ distributed SpMV


def _overlapped(x: torch.Tensor, exchange: Callable, side,
                local_phase: Callable, ghost_phase: Callable) -> torch.Tensor:
    """Exchange on the side stream while the local phase runs on the
    current one; the ghost phase starts once the current stream has waited
    for the exchange.  On the CPU (no side stream) the phases run in
    sequence, in the same order."""
    if side is None:
        gh = exchange(x[..., None])[..., 0]
        return ghost_phase(local_phase(x), gh)
    main = torch.cuda.current_stream(x.device)
    side.wait_stream(main)                 # x is ready before the exchange
    with torch.cuda.stream(side):
        gh = exchange(x[..., None])[..., 0]
    x.record_stream(side)
    y = local_phase(x)                     # no data dependence on gh
    main.wait_stream(side)
    gh.record_stream(main)
    return ghost_phase(y, gh)


def make_distributed_spmv(
    ell: Union[DeviceEll, DeviceEllBlocked],
    exchange: Optional[Callable] = None,
    overlap: bool = False,
    device=None,
) -> Callable:
    """Build the distributed SpMV ``fn(x [P, in_pad]) -> [P, row_pad]``.

    The ELL blocks move to ``device`` (default ``cuda``).  ``exchange`` is
    a bound plan executor (``NeighborAlltoallV.bind`` /
    ``PlanCache.executor``) mapping ``[P, in_pad, 1] -> [P, ghost_pad, 1]``;
    required unless ``ell.ghost_pad == 0`` (fully local operator).  The
    products go through ``kernels.spmv_ell.ops``, hence the CUDA kernels on
    the card and their plain versions on the CPU.  A
    :class:`DeviceEllBlocked` selects the column-blocked kernels: local and
    ghost values are concatenated into the bucketed gather space and one
    accumulating product covers both (ghost buckets trail).

    ``overlap=True`` splits the schedule into (local product || exchange)
    followed by a carried-output ghost product (see :func:`_overlapped`).
    Both phases accumulate buckets in the same ascending order as the fused
    schedule.  No-ghost operators ignore the flag.

    The returned function carries ``kernels``: the names of the kernels it
    launches, in order; a blocked one also ``operands``, the bucket-major
    ``(cols, vals)`` on ``device`` that K2-K4 read.
    """
    if ell.ghost_pad and exchange is None:
        raise ValueError("operator has ghost columns: exchange required")
    device = resolve_device(device)
    overlap = bool(overlap) and ell.ghost_pad > 0
    side = (torch.cuda.Stream(device) if overlap and device.type == "cuda"
            else None)
    if isinstance(ell, DeviceEllBlocked):
        return _make_distributed_spmv_blocked(ell, exchange, overlap, side,
                                              device)

    lc, lv, gc, gv = (
        torch.as_tensor(a, device=device)
        for a in (ell.local_cols, ell.local_vals,
                  ell.ghost_cols, ell.ghost_vals)
    )

    def local_phase(x):
        return spmv(lc, lv, F.pad(x, (0, 1)))   # sentinel slot at in_pad

    def ghost_phase(y, gh):
        return y + spmv(gc, gv, F.pad(gh, (0, 1)))

    if not ell.ghost_pad:
        fn = local_phase
        fn.kernels = ("spmv_ell",)
        return fn

    def spmv_fn(x):
        if overlap:
            return _overlapped(x, exchange, side, local_phase, ghost_phase)
        gh = exchange(x[..., None])[..., 0]
        return ghost_phase(local_phase(x), gh)

    spmv_fn.kernels = ("spmv_ell", "spmv_ell")
    return spmv_fn


def _make_distributed_spmv_blocked(
    ell: DeviceEllBlocked,
    exchange: Optional[Callable],
    overlap: bool,
    side,
    device: torch.device,
) -> Callable:
    """Blocked-layout counterpart of :func:`make_distributed_spmv`.

    Both the fused and the overlapped schedule go through the
    bucket-skipping kernel whenever :func:`row_block_bucket_map` shows at
    least one row block skipping at least one bucket of its window (banded
    operators touch few buckets per row block); otherwise the dense
    blocked/partial kernels stream every bucket.  The operator goes to
    ``device`` bucket-major, once: every product of the returned function
    reads that one copy.
    """
    bc = ell.block_cols
    C, Cl = ell.n_buckets, ell.n_local_buckets
    cols = to_bucket_major(ell.cols, C, device)
    vals = to_bucket_major(ell.vals, C, device)
    local_fill = Cl * bc - ell.in_pad
    ghost_fill = ell.n_ghost_buckets * bc - ell.ghost_pad

    def skip_map(**window):
        lists, counts = row_block_bucket_map(ell, **window)
        width = window.get("bucket_hi", C) - window.get("bucket_lo", 0)
        if lists.shape[2] >= width:
            return None
        return (torch.as_tensor(lists, device=device),
                torch.as_tensor(counts, device=device))

    if overlap:
        lskip = skip_map(bucket_hi=Cl)
        gskip = skip_map(bucket_lo=Cl)

        def local_phase(x):
            xl = F.pad(x, (0, local_fill))
            if lskip is not None:
                return spmv_blocked_skip(
                    cols, vals, xl, *lskip, n_buckets=C, block_cols=bc,
                )
            y0 = x.new_zeros((ell.n_procs, ell.row_pad))
            return spmv_blocked_partial(
                cols, vals, xl, y0,
                bucket_lo=0, bucket_hi=Cl, n_buckets=C, block_cols=bc,
            )

        def ghost_phase(y, gh):
            xg = F.pad(gh, (0, ghost_fill))
            if gskip is not None:
                return spmv_blocked_skip(
                    cols, vals, xg, *gskip, n_buckets=C, block_cols=bc,
                    bucket_base=Cl, y0=y,
                )
            return spmv_blocked_partial(
                cols, vals, xg, y,
                bucket_lo=Cl, bucket_hi=C, n_buckets=C, block_cols=bc,
            )

        def spmv_fn(x):
            return _overlapped(x, exchange, side, local_phase, ghost_phase)

        spmv_fn.kernels = tuple(
            "spmv_ell_blocked_skip" if sk is not None
            else "spmv_ell_blocked_partial" for sk in (lskip, gskip)
        )
        spmv_fn.operands = (cols, vals)
        return spmv_fn

    skip = skip_map()
    has_ghost = ell.ghost_pad > 0

    def spmv_fn(x):
        parts = [x, x.new_zeros((ell.n_procs, local_fill))]
        if has_ghost:
            gh = exchange(x[..., None])[..., 0]
            parts += [gh, x.new_zeros((ell.n_procs, ghost_fill))]
        xcat = torch.cat(parts, dim=1)        # [P, n_buckets * block_cols]
        if skip is not None:
            return spmv_blocked_skip(
                cols, vals, xcat, *skip, n_buckets=C, block_cols=bc,
            )
        return spmv_blocked(cols, vals, xcat, bc)

    spmv_fn.kernels = ("spmv_ell_blocked_skip" if skip is not None
                       else "spmv_ell_blocked",)
    spmv_fn.operands = (cols, vals)
    return spmv_fn


def distributed_spmv(
    part: PartitionedCSR,
    coll,
    x: np.ndarray,
    dtype=np.float64,
    variant: str = "flat",
    block_cols: int = DEFAULT_BLOCK_COLS,
    overlap: str = "off",
    *,
    vmem_limit_bytes: Optional[int] = None,
    params=LASSEN,
    hbm_bw: Optional[float] = None,
    vpu_flops: Optional[float] = None,
    launch_s: Optional[float] = None,
    device=None,
) -> np.ndarray:
    """One-shot distributed SpMV of a global numpy vector on ``device``
    (default ``cuda``), through the collective ``coll``
    (a ``NeighborAlltoallV`` for ``part.pattern``).

    ``variant`` is ``"flat"``, ``"blocked"`` or ``"auto"`` (modeled
    footprint against ``vmem_limit_bytes``, which it then needs);
    ``overlap`` is ``"on"``, ``"off"`` or ``"auto"`` (the split schedule
    when the exchange time modeled under ``params`` hides more than the
    split costs, at the device figures ``hbm_bw``, ``vpu_flops`` and
    ``launch_s``, which it then needs).  For repeated products build the
    function once with :func:`make_distributed_spmv`.
    """
    device = resolve_device(device)
    sel = select_spmv_kernel(part, variant=variant, block_cols=block_cols,
                             vmem_limit_bytes=vmem_limit_bytes)
    ell = partitioned_to_device(part, sel, dtype, block_cols)
    exchange = coll.bind(device) if ell.ghost_pad else None
    if overlap == "auto":
        osel = select_spmv_overlap(
            part, plan_time(coll.plan, params), mode="auto",
            hbm_bw=hbm_bw, vpu_flops=vpu_flops, launch_s=launch_s,
        )
        ov = osel.mode == "on"
    else:
        if overlap not in ("on", "off"):
            raise ValueError(f"unknown overlap mode {overlap!r}")
        ov = overlap == "on" and ell.ghost_pad > 0
    fn = make_distributed_spmv(ell, exchange, overlap=ov, device=device)
    xg = torch.as_tensor(
        pack_vector(part.col_offsets, ell.in_pad, x.astype(dtype)),
        device=device,
    )
    return unpack_vector(part.offsets, fn(xg).cpu().numpy())
