"""Row partitioning of sparse matrices + communication-pattern extraction.

This is the bridge from the workload (a sparse matrix) to the paper's
collective: in a distributed SpMV y = A x with block row partition, process
``p`` owns rows/vector entries [off[p], off[p+1]) and must *receive* x-values
for every nonzero column outside its block — exactly a CommPattern over
globally-indexed values (column index = global value index).

Square operators (:func:`partition_csr`) and rectangular ones
(:func:`partition_rect_csr` — AMG restriction/prolongation, whose row and
column ownerships differ) share the same machinery; the pattern is always
over the *input* (column) vector.  The device-resident ELL form and the
device SpMV live in :mod:`repro_torch.sparse.device`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..core.plan import CommPattern
from .csr import CSR


def block_offsets(n: int, n_procs: int) -> np.ndarray:
    """Balanced contiguous row offsets, len n_procs+1."""
    base, rem = divmod(n, n_procs)
    sizes = np.full(n_procs, base, dtype=np.int64)
    sizes[:rem] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


@dataclass
class PartitionedCSR:
    """A partitioned CSR: per-process row blocks split into on-process
    (columns within the owned column block) and off-process (ghost) parts,
    Hypre-style.  ``offsets`` is row ownership; ``col_offsets`` is input
    vector ownership (identical for square SpMV operators)."""

    n_procs: int
    offsets: np.ndarray            # [P+1] row ownership
    col_offsets: np.ndarray        # [P+1] column / input-vector ownership
    local: List[CSR]               # per-proc on-process block (local cols)
    ghost: List[CSR]               # per-proc off-process block (ghost cols)
    needs: List[np.ndarray]        # per-proc sorted unique off-proc columns
    pattern: CommPattern

    @property
    def shape(self):
        return (int(self.offsets[-1]), int(self.col_offsets[-1]))


def split_rows(A: CSR, row_offsets: np.ndarray) -> List[CSR]:
    """Cut a CSR into contiguous row blocks that keep GLOBAL column indices.

    This is the on-rank storage of a block row distribution (Hypre's
    ParCSR before the local/ghost split): block ``p`` holds global rows
    [row_offsets[p], row_offsets[p+1]) as local rows 0..m_p-1.
    """
    row_offsets = np.asarray(row_offsets, dtype=np.int64)
    assert int(row_offsets[-1]) == A.nrows, (row_offsets[-1], A.nrows)
    blocks = []
    for p in range(len(row_offsets) - 1):
        rlo, rhi = int(row_offsets[p]), int(row_offsets[p + 1])
        sl = slice(int(A.indptr[rlo]), int(A.indptr[rhi]))
        blocks.append(
            CSR(
                (rhi - rlo, A.ncols),
                A.indptr[rlo:rhi + 1] - A.indptr[rlo],
                A.indices[sl].copy(),
                A.data[sl].copy(),
            )
        )
    return blocks


def stack_blocks(blocks: List[CSR], ncols: int | None = None) -> CSR:
    """Vertically stack row blocks (global columns) back into one CSR.

    The inverse of :func:`split_rows`; used to validate distributed setup
    products against their host counterparts.
    """
    ncols = int(blocks[0].ncols if ncols is None else ncols)
    indptrs = [np.asarray(b.indptr, dtype=np.int64) for b in blocks]
    offs = np.concatenate([[0], np.cumsum([ip[-1] for ip in indptrs])])
    indptr = np.concatenate(
        [[0]] + [ip[1:] + off for ip, off in zip(indptrs, offs)]
    ).astype(np.int64)
    return CSR(
        (int(sum(b.nrows for b in blocks)), ncols),
        indptr,
        np.concatenate([b.indices for b in blocks]).astype(np.int32)
        if indptr[-1] else np.zeros(0, dtype=np.int32),
        np.concatenate([b.data for b in blocks])
        if indptr[-1] else np.zeros(0),
    )


def partitioned_from_blocks(
    blocks: List[CSR], row_offsets: np.ndarray, col_offsets: np.ndarray
) -> PartitionedCSR:
    """Build a :class:`PartitionedCSR` from per-rank row blocks directly.

    The block form (global column indices, as produced by distributed setup
    or :func:`split_rows`) is split into on-process / ghost parts without
    ever assembling the global operator — the entry point that keeps the
    distributed AMG setup's products device-bound end to end.
    """
    row_offsets = np.asarray(row_offsets, dtype=np.int64)
    col_offsets = np.asarray(col_offsets, dtype=np.int64)
    n_procs = len(blocks)
    assert len(row_offsets) == n_procs + 1
    assert len(col_offsets) == n_procs + 1
    local, ghost, needs = [], [], []
    for p, blk in enumerate(blocks):
        assert blk.nrows == int(row_offsets[p + 1] - row_offsets[p])
        clo, chi = int(col_offsets[p]), int(col_offsets[p + 1])
        rows = blk.row_indices()
        cols = blk.indices.astype(np.int64)
        vals = blk.data
        on = (cols >= clo) & (cols < chi)
        loc = CSR.from_coo(rows[on], cols[on] - clo, vals[on],
                           (blk.nrows, chi - clo))
        uniq = np.unique(cols[~on])
        gcols = np.searchsorted(uniq, cols[~on])
        gh = CSR.from_coo(rows[~on], gcols, vals[~on], (blk.nrows, len(uniq)))
        local.append(loc)
        ghost.append(gh)
        needs.append(uniq)
    pattern = CommPattern.from_block_partition(needs, col_offsets)
    return PartitionedCSR(
        n_procs, row_offsets, col_offsets, local, ghost, needs, pattern
    )


def partitioned_to_global(part: PartitionedCSR) -> CSR:
    """Reassemble the global CSR from a :class:`PartitionedCSR`.

    The inverse of :func:`partition_rect_csr`: merges each rank's local
    (column-shifted back by ``col_offsets[p]``) and ghost (columns mapped
    back through ``needs[p]``) blocks and stacks the row blocks.  Values
    are carried bit-exactly; used by the elastic path to repartition a
    hierarchy that was built distributed (``setup_partitioned``) and so
    never had a global operator to begin with.
    """
    blocks: List[CSR] = []
    for p in range(part.n_procs):
        clo = int(part.col_offsets[p])
        loc, gh = part.local[p], part.ghost[p]
        rows = np.concatenate([loc.row_indices(), gh.row_indices()])
        cols = np.concatenate([
            loc.indices.astype(np.int64) + clo,
            part.needs[p][gh.indices.astype(np.int64)]
            if len(gh.indices) else np.zeros(0, dtype=np.int64),
        ])
        vals = np.concatenate([loc.data, gh.data])
        blocks.append(
            CSR.from_coo(rows, cols, vals,
                         (loc.nrows, int(part.col_offsets[-1])))
        )
    return stack_blocks(blocks, ncols=int(part.col_offsets[-1]))


def partition_rect_csr(
    A: CSR, row_offsets: np.ndarray, col_offsets: np.ndarray
) -> PartitionedCSR:
    """Partition a (possibly rectangular) CSR operator.

    Process ``p`` owns output rows [row_offsets[p], row_offsets[p+1]) and
    input vector entries [col_offsets[p], col_offsets[p+1]).  The returned
    pattern describes the halo exchange of input values.
    """
    row_offsets = np.asarray(row_offsets, dtype=np.int64)
    col_offsets = np.asarray(col_offsets, dtype=np.int64)
    n_procs = len(row_offsets) - 1
    assert len(col_offsets) == n_procs + 1
    assert int(col_offsets[-1]) == A.ncols, (col_offsets[-1], A.ncols)
    return partitioned_from_blocks(
        split_rows(A, row_offsets), row_offsets, col_offsets
    )


def partition_csr(A: CSR, n_procs: int) -> PartitionedCSR:
    """Square-operator partition: rows and input entries share one blocking."""
    assert A.nrows == A.ncols, "use partition_rect_csr for rectangular ops"
    off = block_offsets(A.nrows, n_procs)
    return partition_rect_csr(A, off, off)


def distributed_spmv_numpy(
    part: PartitionedCSR, plan, x: np.ndarray
) -> np.ndarray:
    """Host-oracle distributed SpMV using a CommPlan for the halo exchange."""
    xs = [
        x[int(part.col_offsets[p]): int(part.col_offsets[p + 1])]
        for p in range(part.n_procs)
    ]
    ghosts = plan.execute_numpy(xs)
    ys = []
    for p in range(part.n_procs):
        y = part.local[p].matvec(xs[p])
        if part.ghost[p].ncols:
            y = y + part.ghost[p].matvec(ghosts[p])
        ys.append(y)
    return np.concatenate(ys)
