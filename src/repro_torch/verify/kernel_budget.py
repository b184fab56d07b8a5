"""Kernel budgets on the card and bucket-map coverage.

Ported from ``repro.verify.kernel_budget``, with the TPU's VMEM wall
replaced by the card's own limits.  Three contracts, each checked without
running a kernel:

* **Honest footprint estimators.**  ``select_spmv_kernel`` picks flat vs
  blocked from ``spmv_flat_vmem_bytes`` / ``spmv_blocked_vmem_bytes``
  against a limit the caller gives (an eighth of the card's L2 on the main
  path: the flat kernel gathers from a whole x, which the 8 stacked ranks
  share the L2 for).  Those numbers are only trustworthy while they track
  what the K1-K4 launches read at a time.  :func:`flat_kernel_actual_bytes`
  and :func:`blocked_kernel_actual_bytes` recompute that from the operands
  ``kernels/spmv_ell/cuda.py`` passes (x as padded by the product, the
  cols / vals tile a thread block reads, the y it writes) and the launch
  geometry of ``csrc/spmv_ell.cu``, and :func:`verify_kernel_budget` holds
  the estimator within ``rtol`` of them.  A relaunch on other tiles that
  the estimator does not follow trips it.

* **The card's limits per kernel.**  Every CUDA source reports its
  kernels' ``cudaFuncGetAttributes`` and the occupancy of their launch
  (``csrc/kernel_attrs.cuh``; :func:`read_kernel_attributes`).
  :func:`check_kernel_attributes` is a pure function of those numbers:
  one block's registers fit the SM's register file, its static + dynamic
  shared memory fits the card's opt-in limit a block, the launch's block
  fits the kernel, the blocks an SM that ``__launch_bounds__`` promises
  are reached, and K7's requested dynamic shared memory is the bytes of
  its staged tiles (:func:`flash_prefill_smem_bytes`) for every head dim
  it is built for.  ``nvcc``'s ``-Xptxas -v`` log, kept beside the built
  library, cross-checks the register counts kernel by kernel and that the
  hand-written kernel table lists every kernel of the build
  (:func:`check_build_log_registers`).

* **Bucket-map exhaustiveness.**  K4 trusts ``row_block_bucket_map`` to
  list, per row block, exactly the buckets holding nonzeros: a missing
  bucket silently drops values from the product, a duplicated one adds
  them twice.  :func:`check_bucket_map` proves every nonzero is covered
  exactly once.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..kernels.flash_attention.cuda import FWD_ROWS, FWD_STEP
from ..kernels.spmv_ell import DEFAULT_BLOCK_ROWS
from ..sparse.device import (
    _IDX_BYTES,
    row_block_bucket_map,
    spmv_blocked_vmem_bytes,
    spmv_flat_vmem_bytes,
)
from .invariants import VerifyError, _fail

# csrc/spmv_ell.cu: K1's rows a thread block (kThreads)
K1_ROWS_PER_BLOCK = 256
# thread blocks of one rank's launch the card runs at once, counted in the
# stream term: the row block being read and the one beside it (an SM holds
# several 256-thread blocks)
BLOCKS_IN_FLIGHT = 2


# ---------------------------------------------------------------------------
# what the SpMV launches read (from their operands)
# ---------------------------------------------------------------------------


def flat_kernel_actual_bytes(ell, *, value_bytes: int = 8) -> int:
    """Bytes the flat path's K1 launches read at a time, per rank.

    ``make_distributed_spmv`` launches K1 twice, on the local block and on
    the ghost block, each with the x it gathers from padded by one sentinel
    slot (``in_pad + 1`` and ``ghost_pad + 1`` values; the whole x, since
    a row may gather any column).  A thread block holds
    ``min(K1_ROWS_PER_BLOCK, R)`` rows and reads their cols (int32) and
    vals ``[rows, K]``; ``BLOCKS_IN_FLIGHT`` of them run at once; one y
    block of ``rows`` values is written.
    """
    R = ell.local_cols.shape[1]
    rows = min(K1_ROWS_PER_BLOCK, R) if R else K1_ROWS_PER_BLOCK
    kl = ell.local_cols.shape[2]
    x_bytes = (ell.in_pad + 1) * value_bytes
    k = kl
    if ell.ghost_pad:
        x_bytes += (ell.ghost_pad + 1) * value_bytes
        k += ell.ghost_cols.shape[2]
    tiles = BLOCKS_IN_FLIGHT * rows * k * (_IDX_BYTES + value_bytes)
    return int(x_bytes + tiles + rows * value_bytes)


def blocked_kernel_actual_bytes(
    ell, *, value_bytes: int = 8, block_rows: int = DEFAULT_BLOCK_ROWS
) -> int:
    """Bytes the blocked path's K2 / K4 launch reads at a time, per rank.

    The launch walks the buckets of the bucket-major ``[P, C, R, K]``
    cols / vals: a thread block of ``min(block_rows, R)`` rows (K4's row
    block, the rows of ``row_block_bucket_map``) reads, a bucket step, its
    rows' ``K`` entries of the bucket and the bucket's slice of x
    (``block_cols`` values); ``BLOCKS_IN_FLIGHT`` blocks run at once; one
    y block is written.  ``K`` is the packed width the operands carry.
    """
    R = ell.row_pad
    rows = min(int(block_rows), R) if R else int(block_rows)
    K = ell.cols.shape[2] // max(ell.n_buckets, 1)
    step = rows * K * (_IDX_BYTES + value_bytes) \
        + ell.block_cols * value_bytes
    return int(BLOCKS_IN_FLIGHT * step + rows * value_bytes)


def verify_kernel_budget(
    ell,
    selection=None,
    *,
    value_bytes: int = 8,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    rtol: float = 0.5,
) -> Dict[str, int]:
    """Estimator honesty for one device operator.

    ``ell`` is a ``DeviceEll`` (flat) or ``DeviceEllBlocked`` (blocked),
    dispatched by its fields.  Checks:

    1. the modeled estimator agrees with the bytes the launch reads
       (:func:`flat_kernel_actual_bytes` / :func:`blocked_kernel_actual_bytes`)
       within ``rtol`` of the latter;
    2. for blocked layouts, the selector's recorded ``blocked_bytes`` is an
       upper bound on what the launch reads (packing may shrink ``K``,
       never grow it): a selector that under-reports would steer operators
       into a layout that does not fit its limit.

    Returns the two numbers and the variant's name.
    """
    blocked = hasattr(ell, "bucket_K")
    if blocked:
        actual = blocked_kernel_actual_bytes(
            ell, value_bytes=value_bytes, block_rows=block_rows)
        modeled = spmv_blocked_vmem_bytes(
            bucket_k=ell.K, value_bytes=value_bytes, rows=ell.row_pad,
            block_rows=block_rows, block_cols=ell.block_cols)
        variant = "blocked"
    else:
        actual = flat_kernel_actual_bytes(ell, value_bytes=value_bytes)
        modeled = spmv_flat_vmem_bytes(
            in_pad=ell.in_pad, ghost_pad=ell.ghost_pad,
            k_local=ell.local_cols.shape[2],
            k_ghost=ell.ghost_cols.shape[2],
            value_bytes=value_bytes, rows=ell.row_pad,
            block_rows=block_rows)
        variant = "flat"
    if abs(modeled - actual) > rtol * max(actual, 1):
        _fail("modeled footprint estimator drifted from what the launch "
              "reads", variant=variant, modeled=modeled, actual=actual,
              rtol=rtol)
    if blocked and selection is not None and \
            selection.blocked_bytes < actual:
        _fail("kernel selection under-reports the blocked footprint",
              recorded=selection.blocked_bytes, actual=actual)
    return {"variant": variant, "modeled": modeled, "actual": actual}


# ---------------------------------------------------------------------------
# the card's limits per kernel
# ---------------------------------------------------------------------------


def flash_prefill_smem_bytes(elem_bytes: int, head_dim: int) -> int:
    """Dynamic shared memory K7's prefill kernel needs at ``head_dim``.
    bf16 (``csrc/flash_attention.cu``, ``Prefill``): four staged key /
    value tiles (two stages of K and V) of 64 rows of ``head_dim``
    elements plus 16 bytes of row padding.  float32
    (``csrc/attn_fwd_f32.cuh``, ``Tiles``): Q's 32 rows, K and V of one
    step of 64 keys at head dim 64 and 32 above, each row ``head_dim + 4``
    floats, and P, 32 rows of step + 8 floats.  The rows and steps are
    ``kernels/flash_attention/cuda.py``'s mirrors (``FWD_ROWS``,
    ``FWD_STEP``)."""
    dtype = torch.bfloat16 if elem_bytes == 2 else torch.float32
    rows, step = FWD_ROWS[dtype], FWD_STEP[dtype][head_dim]
    if elem_bytes == 2:
        return 4 * step * (head_dim + 8) * 2
    return 4 * ((rows + 2 * step) * (head_dim + 4) + rows * (step + 8))


_K7_PREFILL = re.compile(
    r"attn_prefill_kernel<bf16,(\d+)>|attn_prefill_f32_kernel<(\d+)>")


def check_kernel_attributes(attrs: Sequence[Dict],
                            limits: Dict[str, int]) -> Dict[str, int]:
    """Hold every kernel's attributes (``CudaLibrary.kernel_attributes``)
    to the card's ``limits`` (``CudaLibrary.device_limits``); raises
    :class:`VerifyError` naming the kernel on the first violation, returns
    counts of the kernels checked and of K7's head dims."""
    n_k7 = 0
    for a in attrs:
        name = a["name"]
        threads = int(a["threads"])
        if threads > a["max_threads_per_block"]:
            _fail("launch block larger than the kernel can run", kernel=name,
                  threads=threads, max_threads=a["max_threads_per_block"])
        regs = int(a["num_regs"]) * threads
        if regs > limits["regs_per_sm"] or regs > limits["regs_per_block"]:
            _fail("one block's registers exceed the register file",
                  kernel=name, registers=regs,
                  limit=min(limits["regs_per_sm"], limits["regs_per_block"]))
        smem = int(a["static_smem"]) + int(a["dyn_smem"])
        if smem > limits["smem_per_block_optin"]:
            _fail("one block's shared memory exceeds the card's limit",
                  kernel=name, smem=smem,
                  limit=limits["smem_per_block_optin"])
        if a["dyn_smem"] > a["max_dyn_smem"]:
            _fail("launch asks more dynamic shared memory than the kernel "
                  "allows", kernel=name, dyn_smem=a["dyn_smem"],
                  max_dyn_smem=a["max_dyn_smem"])
        promised = max(1, int(a["min_blocks"]))
        if a["blocks_per_sm"] < promised:
            _fail("blocks an SM below what the launch needs or "
                  "__launch_bounds__ promises", kernel=name,
                  blocks=a["blocks_per_sm"], promised=promised)
        m = _K7_PREFILL.fullmatch(name)
        if m:
            want = (flash_prefill_smem_bytes(2, int(m[1])) if m[1]
                    else flash_prefill_smem_bytes(4, int(m[2])))
            if a["dyn_smem"] != want:
                _fail("K7 requests other dynamic shared memory than its "
                      "tiles need", kernel=name, dyn_smem=a["dyn_smem"],
                      tiles=want)
            n_k7 += 1
    return {"kernels": len(attrs), "k7_head_dims": n_k7}


def read_kernel_attributes(device=None):
    """``(attributes of every kernel of the five CUDA sources, the card's
    limits)``, read on the card (each source is built if it is not)."""
    from ..kernels.flash_attention import cuda as fa_cuda
    from ..kernels.moe_pack import cuda as mp_cuda
    from ..kernels.spmv_ell import cuda as sp_cuda
    from ..kernels.ssd_scan import cuda as ssd_cuda

    libs = (sp_cuda.LIBRARY, mp_cuda.LIBRARY, fa_cuda.LIBRARY,
            fa_cuda.BWD_LIBRARY, ssd_cuda.LIBRARY)
    attrs: List[Dict] = []
    for lib in libs:
        attrs += lib.kernel_attributes(device)
    return attrs, libs[0].device_limits(device)


def registers_from_build_log(log: str) -> Dict[str, int]:
    """Registers a thread of each entry function, from ``ptxas -v``."""
    regs: Dict[str, int] = {}
    current: Optional[str] = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m[1]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            regs[current] = int(m[1])
            current = None
    return regs


def check_build_log_registers(attrs: Sequence[Dict], source: str,
                              log: str) -> int:
    """Cross-check one source's kernel table against its ``ptxas -v`` log,
    kernel by kernel under the mangled symbol (``cudaFuncGetName``): every
    entry function of the log is a kernel of the table, and every kernel of
    the table has the registers a thread the log gives its symbol.  A log
    without entry functions (lost, or never written) is refused too.
    Raises :class:`VerifyError` naming the source and the kernel; returns
    the number of kernels compared."""
    logged = registers_from_build_log(log)
    if not logged:
        _fail("no ptxas entry functions in the build log", source=source)
    mine = [a for a in attrs if a["source"] == source]
    listed = {a["symbol"] for a in mine}
    missing = sorted(set(logged) - listed)
    if missing:
        _fail("a kernel of the build log is missing from the kernel table",
              source=source, symbol=missing[0])
    for a in mine:
        want = logged.get(a["symbol"])
        if want is None:
            _fail("a kernel of the table is not in the build log",
                  source=source, kernel=a["name"], symbol=a["symbol"])
        if int(a["num_regs"]) != want:
            _fail("register counts of the card disagree with the build log",
                  source=source, kernel=a["name"], card=int(a["num_regs"]),
                  build_log=want)
    return len(mine)


# ---------------------------------------------------------------------------
# bucket-map coverage (K4)
# ---------------------------------------------------------------------------


def check_bucket_map(
    ell,
    lists: np.ndarray,
    counts: np.ndarray,
    *,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    bucket_lo: int = 0,
    bucket_hi: Optional[int] = None,
    live: Optional[np.ndarray] = None,
) -> None:
    """Prove a (lists, counts) pair covers every nonzero exactly once.

    K4 visits, for row block ``i``, exactly the buckets
    ``lists[p, i, :counts[p, i]]``: a live bucket absent from its list is
    dropped from the product; a bucket listed twice is added twice.  Checks
    shapes against the kernel's row blocking, ascending unique in-window
    entries, inert ``bucket_lo`` padding, and exact agreement with the live
    set recomputed from ``ell.vals`` (``live``: :func:`live_buckets`, when
    the caller has it).
    """
    lists = np.asarray(lists).astype(np.int64)
    counts = np.asarray(counts).astype(np.int64)
    P, C = ell.n_procs, ell.n_buckets
    lo = int(bucket_lo)
    hi = C if bucket_hi is None else int(bucket_hi)
    R = ell.row_pad
    br = min(int(block_rows), R)
    nrb = (R + (-R) % br) // br
    if counts.shape != (P, nrb):
        _fail("bucket-map counts shape disagrees with the kernel grid",
              shape=counts.shape, expected=(P, nrb))
    if lists.shape[:2] != (P, nrb):
        _fail("bucket-map lists shape disagrees with the kernel grid",
              shape=lists.shape, expected_leading=(P, nrb))
    M = lists.shape[2]

    def first(mask) -> tuple:
        return tuple(int(v) for v in np.argwhere(mask)[0])

    bad = (counts < 0) | (counts > M)
    if bad.any():
        p, rb = first(bad)
        _fail("bucket count outside the list capacity", rank=p,
              row_block=rb, count=int(counts[p, rb]), capacity=M)
    inlist = np.arange(M)[None, None, :] < counts[:, :, None]
    bad = inlist & ((lists < lo) | (lists >= hi))
    if bad.any():
        p, rb, j = first(bad)
        _fail("listed bucket outside the kernel's window", rank=p,
              row_block=rb, bucket=int(lists[p, rb, j]), window=(lo, hi))
    step = np.diff(lists, axis=2)
    both = inlist[:, :, 1:]
    if (both & (step == 0)).any():
        p, rb, j = first(both & (step == 0))
        _fail("duplicated bucket in a row-block list (its values would be "
              "accumulated twice)", rank=p, row_block=rb,
              bucket=int(lists[p, rb, j]))
    if (both & (step < 0)).any():
        p, rb, _j = first(both & (step < 0))
        _fail("bucket list not ascending", rank=p, row_block=rb)
    bad = ~inlist & (lists != lo)
    if bad.any():
        p, rb, j = first(bad)
        _fail("bucket-list padding is not the inert bucket_lo value",
              rank=p, row_block=rb, slot=j)
    if live is None:
        live = live_buckets(ell)
    pad = nrb * br - R
    if pad:
        live = np.concatenate([live, np.zeros((P, pad, C), bool)], axis=1)
    want = live.reshape(P, nrb, br, C).any(2)
    want[:, :, :lo] = False
    want[:, :, hi:] = False
    listed = np.zeros((P, nrb, C), bool)
    p_i, rb_i, j_i = np.nonzero(inlist)
    listed[p_i, rb_i, lists[p_i, rb_i, j_i]] = True
    if (want & ~listed).any():
        p, rb, b = first(want & ~listed)
        _fail("live bucket missing from the row-block list (its nonzeros "
              "would be dropped)", rank=p, row_block=rb, bucket=b)
    if (listed & ~want).any():
        p, rb, b = first(listed & ~want)
        _fail("dead bucket listed for a row block", rank=p, row_block=rb,
              bucket=b)


def live_buckets(ell) -> np.ndarray:
    """``[P, R, C]``: whether row r of rank p has a nonzero in bucket c."""
    nz = ell.vals.reshape(ell.n_procs, ell.row_pad, ell.n_buckets,
                          ell.K) != 0
    live = nz[..., 0].copy()
    for k in range(1, ell.K):      # K is small: an OR a slot beats any(-1)
        live |= nz[..., k]
    return live


def verify_bucket_map(
    ell,
    *,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    bucket_lo: int = 0,
    bucket_hi: Optional[int] = None,
    live: Optional[np.ndarray] = None,
) -> None:
    """Build the map K4 would use and prove it exhaustive."""
    lists, counts = row_block_bucket_map(
        ell, block_rows=block_rows, bucket_lo=bucket_lo,
        bucket_hi=bucket_hi,
    )
    check_bucket_map(
        ell, lists, counts, block_rows=block_rows, bucket_lo=bucket_lo,
        bucket_hi=bucket_hi, live=live,
    )


__all__ = [
    "VerifyError",
    "flat_kernel_actual_bytes",
    "blocked_kernel_actual_bytes",
    "verify_kernel_budget",
    "flash_prefill_smem_bytes",
    "check_kernel_attributes",
    "read_kernel_attributes",
    "registers_from_build_log",
    "check_build_log_registers",
    "check_bucket_map",
    "live_buckets",
    "verify_bucket_map",
]
