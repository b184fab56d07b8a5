"""Distributed AMG *setup* on persistent neighborhood collectives.

The setup phase is the irregular-communication-heavy stage the paper
targets in Hypre BoomerAMG.  Each rank owns a contiguous row block of the
fine operator and the whole pipeline (strength graph, PMIS coarsening,
direct interpolation, ``R = P^T``, the Galerkin product ``A_c = R A P``)
runs block-local with every exchange routed through the plan machinery:

* **halo exchanges** (PMIS states/weights, splitting, coarse numbering,
  rho power iteration) execute a per-level persistent ``NeighborAlltoallV``
  over the level's row index space, cached in
  :class:`~repro_torch.core.cache.PlanCache` by pattern fingerprint; for
  structurally symmetric operators this is the *same* pattern the solve
  uses, so setup and solve share one plan;
* **transpose pushes** (reverse strength edges, ``P^T``) use the sparse
  dynamic data exchange (``core.dynexchange``, arXiv 2308.13869): the
  receivers discover their partners from an allreduce on counts;
* the **Galerkin SpGEMM** fetches remote ``A``/``P`` rows through
  ``sparse.spgemm.gather_remote_rows`` (discovery + two cached
  ``NeighborAlltoallV`` exchanges) and multiplies with local merge-based
  SpGEMM; no rank ever materializes a global operator.

Host numpy over simulated ranks: each exchange runs through
``NeighborAlltoallV.__call__`` (``CommPlan.execute_numpy``).  The result
reproduces the host :func:`~repro_torch.amg.hierarchy.build_hierarchy`
level by level: identical C/F splittings (the PMIS rounds run in lock-step
with halo'd neighbor states, on the same weight stream) and coarse
operators equal to 1e-12 (the only drift is Galerkin association order and
the reduction order of global norms in the rho estimate).

Entry points: :func:`distributed_build_hierarchy` (from per-rank blocks),
:meth:`DistributedSetup.to_host_hierarchy` (assembled view for validation),
and ``DistributedHierarchy.setup_partitioned`` in
:mod:`repro_torch.amg.distributed` (lowering straight to the device solve).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..core.cache import PlanCache, default_plan_cache
from ..core.costmodel import LASSEN, MachineParams
from ..core.dynexchange import DiscoveryStats, SparseDynamicExchange
from ..core.neighborhood import NeighborAlltoallV
from ..core.plan import CommPattern, Topology
from ..sparse.csr import CSR
from ..sparse.partition import block_offsets, split_rows, stack_blocks
from ..sparse.spgemm import spgemm_rap
from .hierarchy import Hierarchy, Level

UNDECIDED, CPT, FPT = 0, 1, 2


# ---------------------------------------------------------------------------
# exchange bookkeeping
# ---------------------------------------------------------------------------


@dataclass
class ExchangeRecord:
    """One setup-phase exchange: what moved, at which level, through what."""

    level: int
    phase: str                 # halo | strength_transpose | p_transpose |
    #                            gather_A | gather_P
    values: int                # values delivered (pattern ghosts / pushed rows)
    pattern: Optional[CommPattern] = None   # None for one-shot pushes
    discovery: Optional[DiscoveryStats] = None


# ---------------------------------------------------------------------------
# per-level halo: one persistent collective for every setup vector exchange
# ---------------------------------------------------------------------------


@dataclass
class _Halo:
    offsets: np.ndarray
    needs: List[np.ndarray]        # per rank: sorted unique ghost global ids
    coll: NeighborAlltoallV
    pattern: CommPattern

    def exchange(self, blocks: List[np.ndarray]) -> List[np.ndarray]:
        """Per-rank extended arrays [own block; delivered ghosts]."""
        vals = [np.asarray(b, dtype=np.float64) for b in blocks]
        ghosts = self.coll(vals)
        return [np.concatenate([v, g]) for v, g in zip(vals, ghosts)]

    def localize(self, cols: np.ndarray, p: int) -> np.ndarray:
        """Global column ids -> indices into this rank's extended array."""
        lo, hi = int(self.offsets[p]), int(self.offsets[p + 1])
        own = (cols >= lo) & (cols < hi)
        ghost_pos = np.searchsorted(self.needs[p], cols)
        return np.where(own, cols - lo, (hi - lo) + ghost_pos)


def _build_halo(
    col_sources: List[List[CSR]],
    offsets: np.ndarray,
    topo: Topology,
    cache: PlanCache,
    strategy: str,
    value_bytes: int,
    params: MachineParams,
) -> _Halo:
    """Halo over the union of ghost columns of the given per-rank blocks."""
    n_procs = len(col_sources[0])
    needs = []
    for p in range(n_procs):
        lo, hi = int(offsets[p]), int(offsets[p + 1])
        cols = np.concatenate(
            [src[p].indices.astype(np.int64) for src in col_sources]
        )
        needs.append(np.unique(cols[(cols < lo) | (cols >= hi)]))
    pattern = CommPattern.from_block_partition(needs, offsets)
    coll = cache.collective(
        pattern, topo, strategy, value_bytes=value_bytes, params=params
    )
    return _Halo(np.asarray(offsets, dtype=np.int64), needs, coll, pattern)


# ---------------------------------------------------------------------------
# distributed setup kernels (block-local + exchanges)
# ---------------------------------------------------------------------------


def _strength_block(Ab: CSR, row_base: int, theta: float) -> CSR:
    """Block-local classical strength graph (same arithmetic as the host
    ``coarsen.strength_graph``; rows are local, columns stay global)."""
    rows = Ab.row_indices()
    gcols = Ab.indices.astype(np.int64)
    offd = (rows + row_base) != gcols
    neg = np.where(offd, -Ab.data, 0.0)
    row_max = np.zeros(Ab.nrows)
    np.maximum.at(row_max, rows, neg)
    keep = offd & (neg >= theta * row_max[rows]) & (neg > 0)
    return CSR.from_coo(
        rows[keep], gcols[keep], np.ones(int(keep.sum())), Ab.shape
    )


def _symmetrize_blocks(
    S_blocks: List[CSR], offsets: np.ndarray
) -> Tuple[List[CSR], DiscoveryStats]:
    """G = S + S^T by row blocks: reverse edges are *pushed* to the owner of
    their target row via the sparse dynamic data exchange (receivers cannot
    know their senders in advance — the SDDE's defining situation)."""
    dest, payload = [], []
    for p, Sb in enumerate(S_blocks):
        rows_g = Sb.row_indices() + int(offsets[p])
        cols_g = Sb.indices.astype(np.int64)
        owner = np.searchsorted(offsets, cols_g, side="right") - 1
        dest.append(owner)
        payload.append(
            np.stack([cols_g.astype(np.float64), rows_g.astype(np.float64)],
                     axis=-1)
        )
    received, _src, stats = SparseDynamicExchange.push(dest, payload)
    G_blocks = []
    for p, Sb in enumerate(S_blocks):
        rev_rows = received[p][:, 0].astype(np.int64) - int(offsets[p])
        rev_cols = received[p][:, 1].astype(np.int64)
        rows = np.concatenate([Sb.row_indices(), rev_rows])
        cols = np.concatenate([Sb.indices.astype(np.int64), rev_cols])
        G_blocks.append(
            CSR.from_coo(rows, cols, np.ones(len(rows)), Sb.shape)
        )
    return G_blocks, stats


def _distributed_pmis(
    G_blocks: List[CSR], offsets: np.ndarray, halo: _Halo, seed: int
) -> List[np.ndarray]:
    """PMIS in lock-step with the host ``coarsen.pmis``: every round halos
    the active weights and the fresh C flags, so each rank takes exactly
    the decisions the host takes on the global graph."""
    n = int(offsets[-1])
    n_procs = len(G_blocks)
    # One global weight stream (deterministic across ranks — stands in for
    # a counter-based RNG), sliced per block: identical to the host's
    # ``deg + rng.random(n)``.
    w_rand = np.random.default_rng(seed).random(n)
    states, ws, g_rows, g_cols_ext = [], [], [], []
    for p, Gb in enumerate(G_blocks):
        deg = np.diff(Gb.indptr).astype(np.float64)
        lo, hi = int(offsets[p]), int(offsets[p + 1])
        ws.append(deg + w_rand[lo:hi])
        state = np.full(Gb.nrows, UNDECIDED, dtype=np.int8)
        state[deg == 0] = FPT
        states.append(state)
        g_rows.append(Gb.row_indices())
        g_cols_ext.append(halo.localize(Gb.indices.astype(np.int64), p))

    while any(np.any(s == UNDECIDED) for s in states):
        active = [
            np.where(s == UNDECIDED, w, -1.0) for s, w in zip(states, ws)
        ]
        ext_w = halo.exchange(active)
        new_c = []
        for p in range(n_procs):
            m = G_blocks[p].nrows
            nbr_max = np.zeros(m)
            edge_active = states[p][g_rows[p]] == UNDECIDED
            np.maximum.at(
                nbr_max, g_rows[p][edge_active],
                ext_w[p][g_cols_ext[p][edge_active]],
            )
            new_c.append(
                (states[p] == UNDECIDED) & (active[p] > nbr_max)
            )
        if not any(c.any() for c in new_c):
            # global deterministic tie-break: first undecided point
            # (allreduce-min of the per-rank candidates)
            firsts = [
                int(offsets[p]) + int(np.flatnonzero(states[p] == UNDECIDED)[0])
                for p in range(n_procs)
                if np.any(states[p] == UNDECIDED)
            ]
            g = min(firsts)
            owner = int(np.searchsorted(offsets, g, side="right") - 1)
            new_c[owner][g - int(offsets[owner])] = True
        for p in range(n_procs):
            states[p][new_c[p]] = CPT
        ext_c = halo.exchange([c.astype(np.float64) for c in new_c])
        for p in range(n_procs):
            hit = (
                (ext_c[p][g_cols_ext[p]] > 0.0)
                & (states[p][g_rows[p]] == UNDECIDED)
            )
            states[p][g_rows[p][hit]] = FPT
    return [(s == CPT).astype(np.int8) for s in states]


def _distributed_interpolation(
    A_blocks: List[CSR],
    S_blocks: List[CSR],
    splitting: List[np.ndarray],
    offsets: np.ndarray,
    halo: _Halo,
) -> Tuple[List[CSR], List[np.ndarray], np.ndarray]:
    """Direct interpolation with halo'd splitting / coarse numbering;
    mirrors ``coarsen.direct_interpolation`` row for row."""
    n = int(offsets[-1])
    n_procs = len(A_blocks)
    splitting = [s.copy() for s in splitting]

    arows, acols_g, acols_ext, avals, strong, deg_strong = [], [], [], [], [], []
    for p, Ab in enumerate(A_blocks):
        r = Ab.row_indices()
        c = Ab.indices.astype(np.int64)
        arows.append(r)
        acols_g.append(c)
        acols_ext.append(halo.localize(c, p))
        avals.append(Ab.data)
        # membership of A edges in the strength pattern: CSR order makes the
        # (row, col) keys already sorted, so a searchsorted probes suffice
        Sb = S_blocks[p]
        key_s = Sb.row_indices() * n + Sb.indices.astype(np.int64)
        key_a = r * n + c
        if len(key_s):
            pos = np.minimum(np.searchsorted(key_s, key_a), len(key_s) - 1)
            strong.append(key_s[pos] == key_a)
        else:
            strong.append(np.zeros(len(key_a), dtype=bool))
        deg_strong.append(np.diff(Sb.indptr))

    for _pass in range(30):  # promote until every F has a strong C neighbor
        ext_split = halo.exchange([s.astype(np.float64) for s in splitting])
        updates = []
        for p in range(n_procs):
            interp_edge = strong[p] & (ext_split[p][acols_ext[p]] == 1.0)
            has_c = np.zeros(A_blocks[p].nrows, dtype=bool)
            has_c[arows[p][interp_edge]] = True
            bad_f = (splitting[p] == 0) & ~has_c & (deg_strong[p] > 0)
            updates.append(bad_f)
        if not any(u.any() for u in updates):
            break
        for p in range(n_procs):
            splitting[p][updates[p]] = 1

    # global coarse numbering: exclusive scan of per-rank C counts
    counts = np.array([int((s == 1).sum()) for s in splitting], dtype=np.int64)
    coff = np.concatenate([[0], np.cumsum(counts)])
    n_coarse = int(coff[-1])
    cmaps = []
    for p in range(n_procs):
        cmap = -np.ones(A_blocks[p].nrows)
        cmap[splitting[p] == 1] = coff[p] + np.arange(counts[p])
        cmaps.append(cmap)
    ext_split = halo.exchange([s.astype(np.float64) for s in splitting])
    ext_cmap = halo.exchange(cmaps)

    P_blocks = []
    for p in range(n_procs):
        Ab = A_blocks[p]
        m = Ab.nrows
        base = int(offsets[p])
        r, c, v = arows[p], acols_g[p], avals[p]
        diag = np.zeros(m)
        on_diag = c == (r + base)
        diag[r[on_diag]] = v[on_diag]
        offd = ~on_diag
        neg = np.where(offd & (v < 0), v, 0.0)
        row_neg_sum = np.zeros(m)
        np.add.at(row_neg_sum, r, neg)
        split_at_col = ext_split[p][acols_ext[p]]
        interp_edge = strong[p] & (split_at_col == 1.0) & (v < 0)
        row_cneg_sum = np.zeros(m)
        np.add.at(row_cneg_sum, r[interp_edge], v[interp_edge])

        fmask = interp_edge & (splitting[p][r] == 0)
        ri, vi = r[fmask], v[fmask]
        pcol_f = ext_cmap[p][acols_ext[p][fmask]].astype(np.int64)
        alpha = np.where(
            row_cneg_sum[ri] != 0, row_neg_sum[ri] / row_cneg_sum[ri], 0.0
        )
        w = -alpha * vi / diag[ri]

        local_c = np.flatnonzero(splitting[p] == 1)
        prow = np.concatenate([ri, local_c])
        pcol = np.concatenate(
            [pcol_f, coff[p] + np.arange(counts[p], dtype=np.int64)]
        )
        pval = np.concatenate([w, np.ones(counts[p])])
        P_blocks.append(CSR.from_coo(prow, pcol, pval, (m, n_coarse)))
    return P_blocks, splitting, coff


def _transpose_blocks(
    P_blocks: List[CSR], fine_offsets: np.ndarray, coarse_offsets: np.ndarray
) -> Tuple[List[CSR], DiscoveryStats]:
    """R = P^T by coarse row blocks: each P entry is pushed to the owner of
    its coarse row (sparse dynamic data exchange — the owner cannot know
    which ranks interpolate from its C-points)."""
    n_fine = int(fine_offsets[-1])
    dest, payload = [], []
    for p, Pb in enumerate(P_blocks):
        rows_g = Pb.row_indices() + int(fine_offsets[p])
        cols_g = Pb.indices.astype(np.int64)
        owner = np.searchsorted(coarse_offsets, cols_g, side="right") - 1
        dest.append(owner)
        payload.append(
            np.stack(
                [cols_g.astype(np.float64), rows_g.astype(np.float64), Pb.data],
                axis=-1,
            )
        )
    received, _src, stats = SparseDynamicExchange.push(dest, payload)
    R_blocks = []
    for q in range(len(P_blocks)):
        got = received[q]
        rows = got[:, 0].astype(np.int64) - int(coarse_offsets[q])
        cols = got[:, 1].astype(np.int64)
        m = int(coarse_offsets[q + 1] - coarse_offsets[q])
        R_blocks.append(CSR.from_coo(rows, cols, got[:, 2], (m, n_fine)))
    return R_blocks, stats


def _block_inv_diag(Ab: CSR, row_base: int) -> np.ndarray:
    """Guarded inverse diagonal of a row block (matches ``hierarchy.inv_diag``)."""
    r = Ab.row_indices()
    c = Ab.indices.astype(np.int64)
    d = np.zeros(Ab.nrows)
    on_diag = c == (r + row_base)
    d[r[on_diag]] = Ab.data[on_diag]
    return np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)


def _distributed_rho(
    A_blocks: List[CSR],
    offsets: np.ndarray,
    halo: _Halo,
    iters: int = 12,
    seed: int = 0,
) -> float:
    """Power iteration on D^-1 A with halo'd matvecs (same stream as the
    host ``estimate_rho``; global norms reduce block partials, so the
    estimate drifts from the host's only by summation order)."""
    n = int(offsets[-1])
    n_procs = len(A_blocks)
    A_loc = []
    dinvs = []
    for p, Ab in enumerate(A_blocks):
        cols_ext = halo.localize(Ab.indices.astype(np.int64), p)
        width = Ab.nrows + len(halo.needs[p])
        A_loc.append(
            CSR((Ab.nrows, max(width, 1)), Ab.indptr,
                cols_ext.astype(np.int32), Ab.data)
        )
        dinvs.append(_block_inv_diag(Ab, int(offsets[p])))
    x_glob = np.random.default_rng(seed).normal(size=n)
    xs = [x_glob[int(offsets[p]):int(offsets[p + 1])] for p in range(n_procs)]

    def gnorm(blocks):
        return float(np.sqrt(sum(float(np.dot(b, b)) for b in blocks)))

    nx = gnorm(xs) + 1e-300
    xs = [b / nx for b in xs]
    rho = 1.0
    for _ in range(iters):
        ext = halo.exchange(xs)
        ys = [
            dinvs[p] * A_loc[p].matvec(ext[p][: A_loc[p].ncols])
            for p in range(n_procs)
        ]
        nrm = gnorm(ys)
        if nrm == 0:
            return 1.0
        rho = nrm
        xs = [y / nrm for y in ys]
    return float(rho)


# ---------------------------------------------------------------------------
# the distributed setup entry point
# ---------------------------------------------------------------------------


@dataclass
class SetupLevel:
    """One level of the distributed hierarchy, stored as per-rank blocks."""

    row_offsets: np.ndarray
    A_blocks: List[CSR]
    rho: float = 0.0
    splitting_blocks: Optional[List[np.ndarray]] = None
    coarse_offsets: Optional[np.ndarray] = None
    P_blocks: Optional[List[CSR]] = None
    R_blocks: Optional[List[CSR]] = None

    @property
    def nrows(self) -> int:
        return int(self.row_offsets[-1])

    @property
    def nnz(self) -> int:
        return int(sum(b.nnz for b in self.A_blocks))

    def splitting(self) -> Optional[np.ndarray]:
        if self.splitting_blocks is None:
            return None
        return np.concatenate(self.splitting_blocks)


@dataclass
class DistributedSetup:
    """A hierarchy built end-to-end from a partitioned fine-grid matrix."""

    levels: List[SetupLevel]
    topo: Topology
    cache: PlanCache
    records: List[ExchangeRecord] = field(default_factory=list)

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def to_host_hierarchy(self) -> Hierarchy:
        """Assembled (global) view — validation / host-solver interop only;
        the device lowering goes straight from the blocks."""
        out = []
        for sl in self.levels:
            lvl = Level(
                A=stack_blocks(sl.A_blocks),
                rho=sl.rho,
                splitting=sl.splitting(),
            )
            if sl.P_blocks is not None:
                lvl.P = stack_blocks(sl.P_blocks)
                lvl.R = stack_blocks(sl.R_blocks)
            out.append(lvl)
        return Hierarchy(out)

    def exchange_summary(self) -> dict:
        """Total setup-phase traffic by phase: values moved + discovery cost."""
        out: dict = {}
        for rec in self.records:
            d = out.setdefault(
                rec.phase, {"values": 0, "exchanges": 0, "allreduce_ints": 0}
            )
            d["values"] += rec.values
            d["exchanges"] += 1
            if rec.discovery is not None:
                d["allreduce_ints"] += rec.discovery.allreduce_ints
        return out

    def describe(self) -> str:
        lines = [
            f"Distributed AMG setup: {self.n_levels} levels on "
            f"{self.topo.n_procs} ranks ({self.topo.n_regions} regions), "
            f"plan cache: {self.cache.stats()}"
        ]
        for k, sl in enumerate(self.levels):
            sizes = np.diff(sl.row_offsets)
            lines.append(
                f"  L{k}: n={sl.nrows:>8,d} nnz={sl.nnz:>9,d} "
                f"rows/rank [{int(sizes.min())},{int(sizes.max())}]"
            )
        for phase, d in sorted(self.exchange_summary().items()):
            lines.append(
                f"  exchange {phase:20s}: {d['exchanges']:3d} exchanges, "
                f"{d['values']:8d} values, allreduce {d['allreduce_ints']} ints"
            )
        return "\n".join(lines)


def distributed_build_hierarchy(
    A_blocks: List[CSR],
    row_offsets: np.ndarray,
    topo: Topology,
    cache: Optional[PlanCache] = None,
    max_levels: int = 25,
    min_coarse: int = 64,
    strength_theta: float = 0.25,
    seed: int = 0,
    strategy: str = "auto",
    value_bytes: int = 8,
    params: MachineParams = LASSEN,
) -> DistributedSetup:
    """Build the AMG hierarchy from per-rank row blocks of the fine matrix.

    Mirrors the host :func:`~repro_torch.amg.hierarchy.build_hierarchy` decision
    for decision (same thresholds, same seeds, same promote rules) while
    running block-local with all exchanges through cached persistent
    collectives; see the module docstring for the exchange inventory.
    """
    row_offsets = np.asarray(row_offsets, dtype=np.int64)
    assert len(A_blocks) == topo.n_procs, (len(A_blocks), topo.n_procs)
    cache = cache if cache is not None else default_plan_cache()
    records: List[ExchangeRecord] = []
    levels = [SetupLevel(row_offsets, list(A_blocks))]
    halos: List[_Halo] = []

    def halo_for(level_idx: int, col_sources) -> _Halo:
        sl = levels[level_idx]
        halo = _build_halo(
            col_sources, sl.row_offsets, topo, cache,
            strategy, value_bytes, params,
        )
        records.append(
            ExchangeRecord(
                level_idx, "halo", halo.pattern.total_ghosts(), halo.pattern
            )
        )
        return halo

    while levels[-1].nrows > min_coarse and len(levels) < max_levels:
        k = len(levels) - 1
        sl = levels[-1]
        offs = sl.row_offsets
        S_blocks = [
            _strength_block(Ab, int(offs[p]), strength_theta)
            for p, Ab in enumerate(sl.A_blocks)
        ]
        if sum(b.nnz for b in S_blocks) == 0:
            break
        G_blocks, sym_stats = _symmetrize_blocks(S_blocks, offs)
        records.append(
            ExchangeRecord(
                k, "strength_transpose", sym_stats.request_ints,
                discovery=sym_stats,
            )
        )
        halo = halo_for(k, [sl.A_blocks, G_blocks])
        halos.append(halo)

        splitting = _distributed_pmis(
            G_blocks, offs, halo, seed=seed + len(levels)
        )
        P_blocks, splitting, coff = _distributed_interpolation(
            sl.A_blocks, S_blocks, splitting, offs, halo
        )
        n_coarse = int(coff[-1])
        if n_coarse >= sl.nrows or n_coarse == 0:
            break
        R_blocks, t_stats = _transpose_blocks(P_blocks, offs, coff)
        records.append(
            ExchangeRecord(
                k, "p_transpose", t_stats.request_ints, discovery=t_stats
            )
        )
        rap = spgemm_rap(
            R_blocks, sl.A_blocks, P_blocks, offs, topo, cache,
            strategy=strategy, value_bytes=value_bytes, params=params,
        )
        records.append(
            ExchangeRecord(
                k, "gather_A", rap.gather_A.total_values,
                rap.gather_A.payload_pattern, rap.gather_A.discovery,
            )
        )
        records.append(
            ExchangeRecord(
                k, "gather_P", rap.gather_P.total_values,
                rap.gather_P.payload_pattern, rap.gather_P.discovery,
            )
        )
        sl.splitting_blocks = splitting
        sl.coarse_offsets = coff
        sl.P_blocks = P_blocks
        sl.R_blocks = R_blocks
        levels.append(
            SetupLevel(coff, [b.prune(1e-14) for b in rap.Ac_blocks])
        )

    # rho estimates: reuse each coarsened level's halo; the last level (and
    # a level that broke out early) gets an A-pattern halo of its own
    for k, sl in enumerate(levels):
        if k < len(halos):
            halo = halos[k]
        else:
            halo = halo_for(k, [sl.A_blocks])
        sl.rho = _distributed_rho(sl.A_blocks, sl.row_offsets, halo)
    return DistributedSetup(levels, topo, cache, records)


def partition_fine_matrix(A: CSR, n_procs: int) -> Tuple[List[CSR], np.ndarray]:
    """Convenience: balanced contiguous row blocks of a fine-grid operator."""
    offsets = block_offsets(A.nrows, n_procs)
    return split_rows(A, offsets), offsets
