"""Sparse dynamic data exchange: partner discovery for irregular patterns.

A rank knows which remote values it must fetch, or where its own rows must
go, but the other side does not know who will contact it ("A More Scalable
Sparse Dynamic Data Exchange", arXiv 2308.13869).  Every rank contributes a
length-``P`` vector of per-partner counts; one allreduce(sum) of the
``P x P`` matrix tells each rank who will contact it and with how much, and
the result is a :class:`~repro_torch.core.plan.CommPattern` that the
Section-5 selector scores and ``PlanCache.collective`` turns into a
persistent exchange.

* :meth:`SparseDynamicExchange.discover`: pull; each rank names the global
  indices it needs (the distributed Galerkin product's remote rows,
  ``sparse.spgemm.gather_remote_rows``).
* :meth:`SparseDynamicExchange.push_pattern` / :meth:`push`: push; rows
  with known destinations (the AMG setup's transposes, MoE token routing).

Host-side numpy over simulated ranks, ported from ``repro.core.dynexchange``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .plan import CommPattern


@dataclass
class DiscoveryStats:
    """Cost accounting of one allreduce-on-counts discovery: the reduced
    ``P x P`` count matrix's size, the request indices that crossed the
    wire after it, and each rank's number of partners."""

    n_procs: int
    allreduce_ints: int
    request_ints: int
    request_partners: np.ndarray   # per rank: # owners it requests from
    serve_partners: np.ndarray     # per rank: # requesters it must serve

    @property
    def max_request_partners(self) -> int:
        return int(self.request_partners.max()) if self.n_procs else 0

    @property
    def max_serve_partners(self) -> int:
        return int(self.serve_partners.max()) if self.n_procs else 0


def _stats_from_counts(counts: np.ndarray) -> DiscoveryStats:
    """DiscoveryStats of one round, from the reduced ``P x P`` count matrix
    (row = sender, col = receiver)."""
    n_procs = counts.shape[0]
    return DiscoveryStats(
        n_procs=n_procs,
        allreduce_ints=n_procs * n_procs,
        request_ints=int(counts.sum()),
        request_partners=(counts > 0).sum(axis=1),
        serve_partners=(counts > 0).sum(axis=0),
    )


class SparseDynamicExchange:
    """Allreduce-on-counts partner discovery (arXiv 2308.13869)."""

    @staticmethod
    def discover(
        needs: Sequence[np.ndarray], proc_offsets: np.ndarray
    ) -> Tuple[CommPattern, DiscoveryStats]:
        """Pull side: ``needs[p]`` are the global indices rank ``p`` must
        fetch; ownership is contiguous by ``proc_offsets``.  Rank ``p``
        forms its count row ``counts[p, q] = |{g in needs[p] : owner(g) =
        q}|``, the rows are allreduced, and owners read their column."""
        proc_offsets = np.asarray(proc_offsets, dtype=np.int64)
        n_procs = len(proc_offsets) - 1
        needs = [np.asarray(n, dtype=np.int64) for n in needs]
        counts = np.zeros((n_procs, n_procs), dtype=np.int64)
        for p, need in enumerate(needs):
            if len(need):
                owners = np.searchsorted(proc_offsets, need, side="right") - 1
                np.add.at(counts[p], owners, 1)
        pattern = CommPattern.from_block_partition(needs, proc_offsets)
        return pattern, _stats_from_counts(counts)

    @staticmethod
    def push_pattern(
        dest: Sequence[np.ndarray],
        local_ids: Optional[Sequence[np.ndarray]] = None,
        n_local: Optional[Sequence[int]] = None,
    ) -> Tuple[CommPattern, DiscoveryStats]:
        """Rank ``p`` owns ``n_local[p]`` values; entry ``i`` of ``dest[p]``
        pushes its value ``local_ids[p][i]`` (default: ``i``) to rank
        ``dest[p][i]``.  The receiver's ghost order is ascending source
        rank, original order within a source.  A value pushed to several
        destinations (MoE top-k fan-out) appears once per push: the
        duplication the ``full`` planner removes."""
        n_procs = len(dest)
        dest = [np.asarray(d, dtype=np.int64) for d in dest]
        if local_ids is None:
            local_ids = [np.arange(len(d), dtype=np.int64) for d in dest]
        else:
            local_ids = [np.asarray(i, dtype=np.int64) for i in local_ids]
        if n_local is None:
            n_local = [
                max(len(d), int(i.max()) + 1 if len(i) else 0)
                for d, i in zip(dest, local_ids)
            ]
        offsets = np.zeros(n_procs + 1, dtype=np.int64)
        offsets[1:] = np.cumsum(n_local)
        counts = np.zeros((n_procs, n_procs), dtype=np.int64)
        for p, d in enumerate(dest):
            if len(d):
                np.add.at(counts[p], d, 1)
        needs: List[np.ndarray] = []
        for q in range(n_procs):
            chunks = [
                offsets[p] + local_ids[p][dest[p] == q]
                for p in range(n_procs)
                if len(dest[p])
            ]
            needs.append(
                np.concatenate(chunks) if chunks
                else np.zeros(0, dtype=np.int64)
            )
        pattern = CommPattern.from_block_partition(needs, offsets)
        return pattern, _stats_from_counts(counts)

    @staticmethod
    def push(
        dest: Sequence[np.ndarray], payload: Sequence[np.ndarray]
    ) -> Tuple[List[np.ndarray], List[np.ndarray], DiscoveryStats]:
        """Push side with payload: row ``i`` of ``payload[p]`` (``[k, ...]``)
        is bound for rank ``dest[p][i]``.  Returns ``(received, sources,
        stats)``: ``received[q]`` stacks the rows delivered to ``q`` in
        ascending source rank, original order within a source, and
        ``sources[q]`` their source ranks."""
        n_procs = len(dest)
        dest = [np.asarray(d, dtype=np.int64) for d in dest]
        payload = [np.asarray(v) for v in payload]
        counts = np.zeros((n_procs, n_procs), dtype=np.int64)
        for p, d in enumerate(dest):
            if len(d):
                np.add.at(counts[p], d, 1)
        trailing = next(
            (v.shape[1:] for v in payload if v.ndim > 1), ()
        )
        # an empty receiver's buffer carries the senders' dtype: the first
        # non-empty payload's, else any payload's, else float64
        dtype = next(
            (v.dtype for v in payload if len(v)),
            next((v.dtype for v in payload), np.float64),
        )
        # one stable sort per sender groups its rows by destination; each
        # receiver then concatenates in ascending source rank
        parts: List[List[np.ndarray]] = [[] for _ in range(n_procs)]
        srcs: List[List[np.ndarray]] = [[] for _ in range(n_procs)]
        for p, d in enumerate(dest):
            if not len(d):
                continue
            order = np.argsort(d, kind="stable")
            sorted_d = d[order]
            bounds = np.flatnonzero(np.diff(sorted_d)) + 1
            for chunk in np.split(order, bounds):
                q = int(d[chunk[0]])
                parts[q].append(payload[p][chunk])
                srcs[q].append(np.full(len(chunk), p, dtype=np.int64))
        received: List[np.ndarray] = []
        sources: List[np.ndarray] = []
        for q in range(n_procs):
            if parts[q]:
                received.append(np.concatenate(parts[q]))
                sources.append(np.concatenate(srcs[q]))
            else:
                received.append(np.zeros((0,) + trailing, dtype=dtype))
                sources.append(np.zeros(0, dtype=np.int64))
        return received, sources, _stats_from_counts(counts)
