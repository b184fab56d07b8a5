"""Push-side sparse dynamic data exchange: the routing pattern of MoE dispatch.

Ported from ``repro.core.dynexchange`` (``DiscoveryStats``,
``SparseDynamicExchange.push_pattern``; the pull-side ``discover`` and the
payload ``push`` are still to port, ROADMAP Queue 1 item 4).  Every rank
contributes a length-``P`` vector of per-destination counts; one
allreduce(sum) of the ``P x P`` matrix tells each rank who will push to it,
and the result is a :class:`~repro_torch.core.plan.CommPattern` that the
Section-5 selector scores.  Host-side numpy over simulated ranks.
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
