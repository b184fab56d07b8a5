"""Distributed SpGEMM building blocks: remote-row gather + local merge products.

The AMG setup's Galerkin triple product ``A_c = R @ A @ P`` is the
irregular-communication SpGEMM the paper targets in Hypre BoomerAMG: with a
block row distribution, a rank multiplying its local ``R`` rows references
``A`` (and then ``P``) rows owned elsewhere.  The remote rows are fetched by

1. *partner discovery*, ``core.dynexchange.SparseDynamicExchange.discover``
   (allreduce-on-counts, arXiv 2308.13869): owners learn who requests what;
2. a *metadata exchange* over the row-index space (row length + global nnz
   start per requested row), through a cached ``NeighborAlltoallV``;
3. the *payload exchange* over the global nnz-slot space ((column, value)
   pairs), through a second cached ``NeighborAlltoallV`` whose plan is keyed
   by pattern fingerprint in :class:`~repro_torch.core.cache.PlanCache`, so a
   repeated setup on the same grid re-plans nothing.

The local half is merge-based SpGEMM on CSR blocks (:func:`spgemm_local`),
and :func:`spgemm_rap` composes gather + multiply into the distributed
``R @ A @ P`` by coarse row blocks.  Host numpy over simulated ranks; the
exchanges run through ``NeighborAlltoallV.__call__``
(``CommPlan.execute_numpy``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.cache import PlanCache, default_plan_cache
from ..core.costmodel import LASSEN, MachineParams
from ..core.dynexchange import DiscoveryStats, SparseDynamicExchange
from ..core.plan import CommPattern, Topology
from .csr import CSR
from .partition import stack_blocks


@dataclass
class RowGather:
    """Result of one distributed remote-row fetch.

    ``rows[p]`` holds the rows ``needs[p]`` (sorted global ids) with global
    column indices; the two patterns are the cached-collective keys of the
    metadata and payload exchanges, exposed so that a caller can re-plan
    them under other strategies (standard vs aggregated setup exchange).
    """

    rows: List[CSR]
    needs: List[np.ndarray]
    row_pattern: CommPattern
    payload_pattern: CommPattern
    discovery: DiscoveryStats

    @property
    def total_rows(self) -> int:
        return int(sum(len(n) for n in self.needs))

    @property
    def total_values(self) -> int:
        return self.payload_pattern.total_ghosts()


def gather_remote_rows(
    blocks: Sequence[CSR],
    row_offsets: np.ndarray,
    needs: Sequence[np.ndarray],
    topo: Topology,
    cache: Optional[PlanCache] = None,
    strategy: str = "auto",
    value_bytes: int = 8,
    params: MachineParams = LASSEN,
) -> RowGather:
    """Fetch remote CSR rows of a block row-distributed operator.

    ``blocks[p]`` are rank ``p``'s rows (global columns), ``needs[p]`` the
    sorted unique global row ids it must fetch (all outside its own block).
    Both exchanges run through ``cache.collective`` so their plans are
    persistent across AMG levels and repeated setups.
    """
    row_offsets = np.asarray(row_offsets, dtype=np.int64)
    n_procs = len(blocks)
    cache = cache if cache is not None else default_plan_cache()
    needs = [np.asarray(n, dtype=np.int64) for n in needs]

    # 1. partner discovery (the dynamic part)
    row_pattern, disc = SparseDynamicExchange.discover(needs, row_offsets)
    meta_coll = cache.collective(
        row_pattern, topo, strategy, value_bytes=value_bytes, params=params
    )

    # 2. metadata exchange: (row length, global nnz start) per owned row.
    # Global nnz slots are contiguously block-partitioned by construction:
    # rank p owns slots [nnz_offsets[p], nnz_offsets[p+1]).
    nnz_offsets = np.concatenate(
        [[0], np.cumsum([b.nnz for b in blocks])]
    ).astype(np.int64)
    meta_local = [
        np.stack(
            [np.diff(b.indptr).astype(np.float64),
             (nnz_offsets[p] + b.indptr[:-1]).astype(np.float64)],
            axis=-1,
        )
        for p, b in enumerate(blocks)
    ]
    meta_ghost = meta_coll(meta_local)

    # 3. payload exchange over nnz slots: (column, value) pairs.
    needs_nnz: List[np.ndarray] = []
    row_lens: List[np.ndarray] = []
    for p in range(n_procs):
        lens = meta_ghost[p][:, 0].astype(np.int64)
        starts = meta_ghost[p][:, 1].astype(np.int64)
        row_lens.append(lens)
        total = int(lens.sum())
        if total == 0:
            needs_nnz.append(np.zeros(0, dtype=np.int64))
            continue
        seg_off = np.concatenate([[0], np.cumsum(lens)[:-1]])
        needs_nnz.append(
            np.repeat(starts, lens)
            + np.arange(total, dtype=np.int64)
            - np.repeat(seg_off, lens)
        )
    payload_pattern = CommPattern.from_block_partition(needs_nnz, nnz_offsets)
    payload_coll = cache.collective(
        payload_pattern, topo, strategy, value_bytes=value_bytes, params=params
    )
    payload_local = [
        np.stack([b.indices.astype(np.float64), b.data], axis=-1)
        for b in blocks
    ]
    payload_ghost = payload_coll(payload_local)

    ncols = int(blocks[0].ncols)
    rows: List[CSR] = []
    for p in range(n_procs):
        lens = row_lens[p]
        got = payload_ghost[p]
        indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        rows.append(
            CSR(
                (len(needs[p]), ncols),
                indptr,
                got[:, 0].astype(np.int64).astype(np.int32),
                got[:, 1].copy(),
            )
        )
    return RowGather(rows, needs, row_pattern, payload_pattern, disc)


# ---------------------------------------------------------------------------
# local merge-based SpGEMM on row subsets
# ---------------------------------------------------------------------------


def merge_row_sets(
    ids_a: np.ndarray, rows_a: CSR, ids_b: np.ndarray, rows_b: CSR
) -> Tuple[np.ndarray, CSR]:
    """Merge two disjoint row subsets into one sorted-by-global-id subset."""
    ids = np.concatenate(
        [np.asarray(ids_a, dtype=np.int64), np.asarray(ids_b, dtype=np.int64)]
    )
    stacked = stack_blocks([rows_a, rows_b])
    order = np.argsort(ids, kind="stable")
    return ids[order], stacked.take_rows(order)


def spgemm_local(left: CSR, avail_ids: np.ndarray, avail: CSR) -> CSR:
    """Merge-based product of a local block against a row subset.

    ``left`` is an ``(m, N)`` block with global column indices; ``avail``
    holds rows ``avail_ids`` (sorted global ids) of the right operand, with
    the right operand's global columns.  Every column of ``left`` must be in
    ``avail_ids`` — i.e. the gather already fetched everything referenced.
    """
    avail_ids = np.asarray(avail_ids, dtype=np.int64)
    if left.nnz:
        pos = np.searchsorted(avail_ids, left.indices)
        pos_c = np.minimum(pos, max(len(avail_ids) - 1, 0))
        if len(avail_ids) == 0 or np.any(avail_ids[pos_c] != left.indices):
            missing = (
                left.indices[avail_ids[pos_c] != left.indices]
                if len(avail_ids) else left.indices
            )
            raise ValueError(
                f"spgemm_local: {len(np.unique(missing))} referenced rows "
                "missing from the gathered set"
            )
    else:
        pos = np.zeros(0, dtype=np.int64)
    remapped = CSR(
        (left.nrows, len(avail_ids)),
        left.indptr.copy(),
        pos.astype(np.int32),
        left.data,
    )
    return remapped.matmat(avail)


@dataclass
class RapResult:
    """Distributed Galerkin product output + its exchange accounting."""

    Ac_blocks: List[CSR]
    gather_A: RowGather
    gather_P: RowGather


def spgemm_rap(
    R_blocks: Sequence[CSR],
    A_blocks: Sequence[CSR],
    P_blocks: Sequence[CSR],
    fine_offsets: np.ndarray,
    topo: Topology,
    cache: Optional[PlanCache] = None,
    strategy: str = "auto",
    value_bytes: int = 8,
    params: MachineParams = LASSEN,
) -> RapResult:
    """Distributed ``A_c = (R @ A) @ P`` by coarse row blocks.

    Rank ``p`` owns the coarse rows matching its ``R`` block: it fetches the
    remote ``A`` rows referenced by its local ``R`` column indices, forms
    ``R_p @ A`` by merge-based SpGEMM, then fetches the remote ``P`` rows
    referenced by the intermediate product and completes ``A_c``'s block.
    No rank ever materializes a global operator.
    """
    fine_offsets = np.asarray(fine_offsets, dtype=np.int64)
    n_procs = len(R_blocks)
    cache = cache if cache is not None else default_plan_cache()

    def ghost_cols(blk: CSR, p: int) -> np.ndarray:
        lo, hi = int(fine_offsets[p]), int(fine_offsets[p + 1])
        cols = blk.indices.astype(np.int64)
        return np.unique(cols[(cols < lo) | (cols >= hi)])

    needs_A = [ghost_cols(R_blocks[p], p) for p in range(n_procs)]
    ga = gather_remote_rows(
        A_blocks, fine_offsets, needs_A, topo, cache,
        strategy=strategy, value_bytes=value_bytes, params=params,
    )
    RA_blocks: List[CSR] = []
    for p in range(n_procs):
        own_ids = np.arange(fine_offsets[p], fine_offsets[p + 1])
        avail_ids, avail = merge_row_sets(
            own_ids, A_blocks[p], ga.needs[p], ga.rows[p]
        )
        RA_blocks.append(spgemm_local(R_blocks[p], avail_ids, avail))

    needs_P = [ghost_cols(RA_blocks[p], p) for p in range(n_procs)]
    gp = gather_remote_rows(
        P_blocks, fine_offsets, needs_P, topo, cache,
        strategy=strategy, value_bytes=value_bytes, params=params,
    )
    Ac_blocks: List[CSR] = []
    for p in range(n_procs):
        own_ids = np.arange(fine_offsets[p], fine_offsets[p + 1])
        avail_ids, avail = merge_row_sets(
            own_ids, P_blocks[p], gp.needs[p], gp.rows[p]
        )
        Ac_blocks.append(spgemm_local(RA_blocks[p], avail_ids, avail))
    return RapResult(Ac_blocks, ga, gp)
