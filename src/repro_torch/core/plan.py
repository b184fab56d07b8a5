"""Communication patterns and persistent-collective plans.

This module is the host-side (numpy) half of the paper's contribution: the
data structures behind ``MPI_Neighbor_alltoallv_init``.  A :class:`CommPattern`
describes *what* must move (which process needs which globally-indexed values);
a :class:`CommPlan` describes *how* it moves (an ordered list of
:class:`CommStep` s, each a set of point-to-point :class:`Message` s between
staging buffers).  Building a plan is the expensive, once-per-pattern
"init" of the persistent collective; executing it every iteration is cheap
(``core.collectives`` compiles the plan into rank-stacked gather / permute /
scatter rounds; :meth:`CommPlan.execute_numpy` is the host oracle).

Value identity is a *global index*, which is exactly the API extension the
paper proposes (Section 3.3): with indices available, the planner can remove
duplicate values from inter-region traffic.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Topology: the machine's locality structure (regions of processes).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Topology:
    """Processes grouped into regions of uniform size.

    A *region* is the locality domain inside which communication is cheap:
    a NUMA domain / CPU / node in the paper; a group of ranks here.
    """

    n_procs: int
    procs_per_region: int

    def __post_init__(self):
        if self.n_procs % self.procs_per_region != 0:
            raise ValueError(
                f"n_procs={self.n_procs} not divisible by "
                f"procs_per_region={self.procs_per_region}"
            )

    @property
    def n_regions(self) -> int:
        return self.n_procs // self.procs_per_region

    def region(self, proc: int) -> int:
        return proc // self.procs_per_region

    def local_rank(self, proc: int) -> int:
        return proc % self.procs_per_region

    def procs_in_region(self, region: int) -> range:
        base = region * self.procs_per_region
        return range(base, base + self.procs_per_region)

    def same_region(self, p: int, q: int) -> bool:
        return self.region(p) == self.region(q)


# ---------------------------------------------------------------------------
# Pattern: what must be communicated.
# ---------------------------------------------------------------------------


class CommPattern:
    """An irregular communication pattern over globally-indexed values.

    Every value has a unique global index ``g``; ``owner_proc[g]`` holds it at
    slot ``owner_slot[g]`` of that process's local value array.  Process ``q``
    must end up with the values listed in ``needs[q]`` (its "ghost" slots, in
    order).  This is the information carried by the send/recv argument lists
    of ``MPI_Neighbor_alltoallv_init`` *plus* the paper's proposed index
    extension (needed for de-duplication).
    """

    def __init__(
        self,
        owner_proc: np.ndarray,
        owner_slot: np.ndarray,
        needs: Sequence[np.ndarray],
        n_local: np.ndarray,
    ):
        self.owner_proc = np.asarray(owner_proc, dtype=np.int64)
        self.owner_slot = np.asarray(owner_slot, dtype=np.int64)
        self.needs = [np.asarray(n, dtype=np.int64) for n in needs]
        self.n_local = np.asarray(n_local, dtype=np.int64)
        self.n_procs = len(self.needs)
        self.n_global = len(self.owner_proc)

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_block_partition(
        needs: Sequence[np.ndarray], proc_offsets: np.ndarray
    ) -> "CommPattern":
        """Pattern where global indices are contiguously block-partitioned.

        ``proc_offsets`` has length n_procs+1; proc ``p`` owns global indices
        ``[proc_offsets[p], proc_offsets[p+1])``.
        """
        proc_offsets = np.asarray(proc_offsets, dtype=np.int64)
        n_procs = len(proc_offsets) - 1
        n_global = int(proc_offsets[-1])
        owner_proc = np.zeros(n_global, dtype=np.int64)
        owner_slot = np.zeros(n_global, dtype=np.int64)
        for p in range(n_procs):
            lo, hi = int(proc_offsets[p]), int(proc_offsets[p + 1])
            owner_proc[lo:hi] = p
            owner_slot[lo:hi] = np.arange(hi - lo)
        n_local = np.diff(proc_offsets)
        return CommPattern(owner_proc, owner_slot, list(needs), n_local)

    # -- derived ------------------------------------------------------------

    def sends_for(self, q: int) -> Dict[int, np.ndarray]:
        """Group ``needs[q]`` by owner: {src_proc: global indices}."""
        need = self.needs[q]
        if len(need) == 0:
            return {}
        owners = self.owner_proc[need]
        order = np.argsort(owners, kind="stable")
        out: Dict[int, np.ndarray] = {}
        sorted_owners = owners[order]
        bounds = np.flatnonzero(np.diff(sorted_owners)) + 1
        for chunk in np.split(order, bounds):
            out[int(owners[chunk[0]])] = need[chunk]
        return out

    def total_ghosts(self) -> int:
        return int(sum(len(n) for n in self.needs))


# ---------------------------------------------------------------------------
# Plan: how it is communicated.
# ---------------------------------------------------------------------------


@dataclass
class Message:
    """One point-to-point message between staging buffers.

    ``src_idx[i]`` (index into ``src``'s input buffer of this step) is
    delivered to ``dst_idx[i]`` (index into ``dst``'s output buffer).
    ``src == dst`` denotes a local copy (no wire traffic).
    """

    src: int
    dst: int
    src_idx: np.ndarray
    dst_idx: np.ndarray

    def __post_init__(self):
        self.src_idx = np.asarray(self.src_idx, dtype=np.int64)
        self.dst_idx = np.asarray(self.dst_idx, dtype=np.int64)
        assert len(self.src_idx) == len(self.dst_idx)

    @property
    def size(self) -> int:
        return len(self.src_idx)


@dataclass
class CommStep:
    """One step of a plan: a set of messages input-buffer -> output-buffer.

    ``in_sizes[p]`` / ``out_sizes[p]`` are the per-process buffer sizes.
    Step inputs chain: step k's output buffer is step k+1's input buffer,
    except steps flagged ``reads_local=True`` which read the original local
    values, and ``writes_ghost=True`` which write the final ghost buffer.
    """

    name: str
    messages: List[Message]
    in_sizes: np.ndarray
    out_sizes: np.ndarray
    reads_local: bool = False
    writes_ghost: bool = False


@dataclass
class StepStats:
    """Exact (unpadded) per-process traffic of one step, split by locality."""

    name: str
    # per-proc counts of *sent* messages / values (excluding local copies)
    intra_msgs: np.ndarray
    inter_msgs: np.ndarray
    intra_vals: np.ndarray
    inter_vals: np.ndarray

    @staticmethod
    def from_messages(name: str, msgs: List[Message], topo: Topology) -> "StepStats":
        P = topo.n_procs
        im = np.zeros(P, dtype=np.int64)
        xm = np.zeros(P, dtype=np.int64)
        iv = np.zeros(P, dtype=np.int64)
        xv = np.zeros(P, dtype=np.int64)
        for m in msgs:
            if m.src == m.dst or m.size == 0:
                continue
            if topo.same_region(m.src, m.dst):
                im[m.src] += 1
                iv[m.src] += m.size
            else:
                xm[m.src] += 1
                xv[m.src] += m.size
        return StepStats(name, im, xm, iv, xv)


@dataclass
class PlanStats:
    """Aggregated over steps; the quantities behind the paper's Figs 8-10."""

    steps: List[StepStats]
    value_bytes: int

    def _sum(self, attr: str) -> np.ndarray:
        return np.sum([getattr(s, attr) for s in self.steps], axis=0)

    @property
    def intra_msgs(self) -> np.ndarray:
        return self._sum("intra_msgs")

    @property
    def inter_msgs(self) -> np.ndarray:
        return self._sum("inter_msgs")

    @property
    def intra_bytes(self) -> np.ndarray:
        return self._sum("intra_vals") * self.value_bytes

    @property
    def inter_bytes(self) -> np.ndarray:
        return self._sum("inter_vals") * self.value_bytes

    def max_intra_msgs(self) -> int:
        return int(self.intra_msgs.max()) if len(self.steps) else 0

    def max_inter_msgs(self) -> int:
        return int(self.inter_msgs.max()) if len(self.steps) else 0

    def max_inter_bytes(self) -> int:
        return int(self.inter_bytes.max()) if len(self.steps) else 0

    def max_intra_bytes(self) -> int:
        return int(self.intra_bytes.max()) if len(self.steps) else 0

    def totals(self) -> Dict[str, int]:
        return {
            "intra_msgs": int(self.intra_msgs.sum()),
            "inter_msgs": int(self.inter_msgs.sum()),
            "intra_bytes": int(self.intra_bytes.sum()),
            "inter_bytes": int(self.inter_bytes.sum()),
        }


@dataclass
class CommPlan:
    """A fully-resolved persistent neighborhood collective.

    Produced once per pattern by ``core.locality`` planners (the "init");
    executed every iteration either on host (:meth:`execute_numpy`, the
    oracle) or on device (``core.collectives.build_executor``).
    """

    strategy: str
    topo: Topology
    pattern: CommPattern
    steps: List[CommStep]
    stats: PlanStats

    # ------------------------------------------------------------------ exec

    def execute_numpy(self, local_vals: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Host-side reference execution. ``local_vals[p]``: [n_local_p, ...]."""
        P = self.topo.n_procs
        trailing = local_vals[0].shape[1:] if local_vals[0].ndim > 1 else ()
        dtype = local_vals[0].dtype
        ghosts: List[np.ndarray] = [
            np.zeros((len(self.pattern.needs[p]),) + trailing, dtype=dtype)
            for p in range(P)
        ]
        bufs: List[Optional[np.ndarray]] = [None] * P
        for step in self.steps:
            src_bufs = local_vals if step.reads_local else bufs
            if step.writes_ghost:
                dst_bufs = ghosts
            else:
                dst_bufs = [
                    np.zeros((int(step.out_sizes[p]),) + trailing, dtype=dtype)
                    for p in range(P)
                ]
            for m in step.messages:
                if m.size == 0:
                    continue
                dst_bufs[m.dst][m.dst_idx] = src_bufs[m.src][m.src_idx]
            if not step.writes_ghost:
                bufs = dst_bufs
        return ghosts

    # ----------------------------------------------------------------- introspection

    def describe(self) -> str:
        lines = [f"CommPlan(strategy={self.strategy}, procs={self.topo.n_procs}, "
                 f"regions={self.topo.n_regions})"]
        for st, ss in zip(self.steps, self.stats.steps):
            lines.append(
                f"  step {st.name:>3}: msgs intra={int(ss.intra_msgs.sum())} "
                f"inter={int(ss.inter_msgs.sum())}  vals intra={int(ss.intra_vals.sum())} "
                f"inter={int(ss.inter_vals.sum())}"
            )
        t = self.stats.totals()
        lines.append(f"  totals: {t}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Round scheduling: edge-color messages so each round is a partial permutation
# (one permutation along the rank dim per round on device).
# ---------------------------------------------------------------------------


@dataclass
class Round:
    """One permutation round: disjoint (src, dst) pairs + per-proc slices."""

    pairs: List[Tuple[int, int]]
    # per message in `pairs` order: gather / scatter index arrays
    src_idx: List[np.ndarray]
    dst_idx: List[np.ndarray]

    @property
    def width(self) -> int:
        return max((len(s) for s in self.src_idx), default=0)


def color_rounds(messages: List[Message]) -> List[Round]:
    """Greedy edge coloring of the message multigraph.

    Each process sends to at most one peer and receives from at most one peer
    per round, matching a single permutation along the rank dim.  Local copies (src==dst)
    are excluded (they execute as gather/scatter without wire traffic).
    Larger messages are colored first so that rounds are size-homogeneous,
    minimizing padding waste.
    """
    wire = [m for m in messages if m.src != m.dst and m.size > 0]
    wire.sort(key=lambda m: -m.size)
    send_used: Dict[int, set] = {}
    recv_used: Dict[int, set] = {}
    rounds: List[Round] = []
    for m in wire:
        su = send_used.setdefault(m.src, set())
        ru = recv_used.setdefault(m.dst, set())
        c = 0
        while c in su or c in ru:
            c += 1
        while c >= len(rounds):
            rounds.append(Round([], [], []))
        su.add(c)
        ru.add(c)
        rounds[c].pairs.append((m.src, m.dst))
        rounds[c].src_idx.append(m.src_idx)
        rounds[c].dst_idx.append(m.dst_idx)
    return rounds


def plan_wire_rounds(plan: CommPlan) -> Dict[str, List[Round]]:
    """Rounds per step — the on-wire schedule the device executor runs."""
    return {s.name: color_rounds(s.messages) for s in plan.steps}


def padded_wire_volume(plan: CommPlan) -> Dict[str, int]:
    """Values actually moved per step after SPMD padding (width × pairs)."""
    out = {}
    for s in plan.steps:
        rounds = color_rounds(s.messages)
        out[s.name] = int(sum(r.width * len(r.pairs) for r in rounds))
    return out
