"""Structural verification of CommPattern / CommPlan / partition / MoE plans.

Ported from ``repro.verify.invariants``.  The paper's persistent
neighborhood collectives hand the planner the *whole* communication
pattern, which makes whole-pattern checking possible: every invariant the
planners rely on implicitly is stated here as an explicit, machine-checked
predicate.  A violated invariant raises :class:`VerifyError` with a
diagnostic naming the offending rank / slot / bucket, instead of showing up
downstream as a wrong residual (a dropped or duplicated ghost value) or a
round whose permutation books one rank twice.

What each check proves:

* :func:`verify_pattern`: ownership is a bijection (every global value has
  exactly one (proc, slot) home and every local slot exactly one value) and
  every requested ghost index exists.
* :func:`verify_round_schedule`: conflict-freedom of the edge coloring: no
  rank sends or receives twice in one round, no self-pairs, so each round
  is one permutation along the rank dim.
* :func:`verify_plan`: send/recv duality and end-to-end conservation of a
  multi-step (aggregated / dedup'd) plan: the plan is executed symbolically
  with *global indices as the payload*, so every ghost slot must end up
  holding exactly the global index the pattern requested, written once.
* :func:`verify_partition`: every ghost column of a ``PartitionedCSR`` is
  served by exactly one exchange slot, and the attached pattern agrees with
  the column ownership.
* :func:`verify_device_ell` / :func:`verify_ell_blocked`: the ELL forms
  carry exactly the partition's nonzeros, each in exactly one slot, and all
  padding is inert.  The blocked check reads the bucket-major ``[P, C, R,
  K]`` operands K2-K4 take (the card's copy, or the one
  ``kernels.spmv_ell.to_bucket_major`` makes of the host form).
* :func:`verify_collective`: plan checks plus the frozen device plan (round
  perms, index-array shapes and sentinel bounds).
* :func:`verify_moe_plan` / :func:`verify_moe_dispatch`: dispatch geometry
  arithmetic and per-expert token conservation of the capacity-packed
  routing pattern.
* :func:`verify_dense_plan`: conflict-freedom and contribution conservation
  of a dense collective's round schedule.

Everything here is numpy over host-side plan metadata (tensors are read
back to the host), so the checks run on the CPU and on plan-cache
insertion (``REPRO_VERIFY=1``) without touching the device hot path.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core.plan import CommPattern, CommPlan, Round, color_rounds


class VerifyError(Exception):
    """A violated plan/kernel invariant.

    ``context`` carries the structured fields (rank, slot, bucket, ...)
    the message interpolates, so programmatic consumers need not parse the
    string.
    """

    def __init__(self, message: str, **context: Any):
        if context:
            message = (f"{message} ["
                       f"{', '.join(f'{k}={v}' for k, v in sorted(context.items()))}]")
        super().__init__(message)
        self.context: Dict[str, Any] = context


def _fail(message: str, **context: Any) -> None:
    raise VerifyError(message, **context)


def _host(a) -> np.ndarray:
    """A numpy view of an array or a tensor on any device."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# ---------------------------------------------------------------------------
# patterns
# ---------------------------------------------------------------------------


def verify_pattern(pattern: CommPattern) -> None:
    """Ownership bijection + ghost-request validity of a CommPattern."""
    P = pattern.n_procs
    G = pattern.n_global
    if len(pattern.owner_proc) != G or len(pattern.owner_slot) != G:
        _fail("owner arrays disagree on n_global",
              owner_proc=len(pattern.owner_proc),
              owner_slot=len(pattern.owner_slot))
    if len(pattern.n_local) != P:
        _fail("n_local length != n_procs",
              n_local=len(pattern.n_local), n_procs=P)
    if G and (pattern.owner_proc.min() < 0 or pattern.owner_proc.max() >= P):
        bad = int(np.flatnonzero(
            (pattern.owner_proc < 0) | (pattern.owner_proc >= P))[0])
        _fail("owner_proc out of range", global_index=bad,
              owner=int(pattern.owner_proc[bad]), n_procs=P)
    if int(pattern.n_local.sum()) != G:
        _fail("n_local does not sum to n_global",
              sum=int(pattern.n_local.sum()), n_global=G)
    order = np.argsort(pattern.owner_proc, kind="stable")
    starts = np.searchsorted(pattern.owner_proc[order], np.arange(P + 1))
    for p in range(P):
        mine = order[starts[p]:starts[p + 1]]
        slots = pattern.owner_slot[mine]
        n_p = int(pattern.n_local[p])
        if len(mine) != n_p:
            _fail("proc owns a different value count than n_local claims",
                  rank=p, owned=len(mine), n_local=n_p)
        if n_p and (slots.min() < 0 or slots.max() >= n_p):
            g = int(mine[np.argmax((slots < 0) | (slots >= n_p))])
            _fail("owner_slot out of range", rank=p, global_index=g,
                  slot=int(pattern.owner_slot[g]), n_local=n_p)
        uniq, cnt = np.unique(slots, return_counts=True)
        if len(uniq) != len(slots):
            _fail("two global values share one local slot", rank=p,
                  slot=int(uniq[np.argmax(cnt > 1)]))
    for q, need in enumerate(pattern.needs):
        if len(need) and (need.min() < 0 or need.max() >= G):
            j = int(np.argmax((need < 0) | (need >= G)))
            _fail("ghost request outside the global index space",
                  rank=q, ghost_slot=j, global_index=int(need[j]),
                  n_global=G)


# ---------------------------------------------------------------------------
# round schedules (one permutation a round)
# ---------------------------------------------------------------------------


def verify_round_schedule(rounds: Sequence[Round], step: str = "?") -> None:
    """Each round must be a partial permutation: no rank twice as a sender
    or receiver, no self-pairs: the conditions for one well-formed
    permutation along the rank dim."""
    for r, rnd in enumerate(rounds):
        seen_src: Dict[int, int] = {}
        seen_dst: Dict[int, int] = {}
        for src, dst in rnd.pairs:
            if src == dst:
                _fail("self-pair in a wire round", step=step, round=r,
                      rank=src)
            if src in seen_src:
                _fail("rank sends twice in one round", step=step, round=r,
                      rank=src)
            if dst in seen_dst:
                _fail("rank receives twice in one round", step=step,
                      round=r, rank=dst)
            seen_src[src] = dst
            seen_dst[dst] = src
        if len(rnd.src_idx) != len(rnd.pairs) or \
                len(rnd.dst_idx) != len(rnd.pairs):
            _fail("round index lists disagree with pair count", step=step,
                  round=r, pairs=len(rnd.pairs))
        for (src, dst), si, di in zip(rnd.pairs, rnd.src_idx, rnd.dst_idx):
            if len(si) != len(di):
                _fail("size-mismatched send: gather and scatter lengths "
                      "differ", step=step, round=r, src=src, dst=dst,
                      sent=len(si), received=len(di))


# ---------------------------------------------------------------------------
# plans (duality + conservation)
# ---------------------------------------------------------------------------


def _owned_ids(pattern: CommPattern) -> List[np.ndarray]:
    """Per proc: global index held at each local slot (ownership inverse)."""
    out = [np.full(int(n), -1, dtype=np.int64) for n in pattern.n_local]
    g = np.arange(pattern.n_global, dtype=np.int64)
    for p in range(pattern.n_procs):
        mine = pattern.owner_proc == p
        out[p][pattern.owner_slot[mine]] = g[mine]
    return out


def verify_plan(plan: CommPlan, pattern: Optional[CommPattern] = None) -> None:
    """Full structural + conservation check of a CommPlan.

    Structural: message endpoints and buffer indices in range, step buffer
    sizes chain, every delivery slot written at most once per buffer, each
    step's wire rounds conflict-free.  Conservation: the plan is executed
    symbolically with global indices as payload: ghost slot ``j`` of rank
    ``q`` must receive exactly ``needs[q][j]``, exactly once, through every
    staging hop of an aggregated / dedup'd plan.
    """
    pattern = plan.pattern if pattern is None else pattern
    verify_pattern(pattern)
    P = plan.topo.n_procs
    if pattern.n_procs != P:
        _fail("plan topology and pattern disagree on n_procs",
              topo=P, pattern=pattern.n_procs)

    ids = _owned_ids(pattern)
    # staging buffers hold the global index of the value occupying each
    # slot (-1 = never written); writes counted per ghost slot
    bufs: List[Optional[np.ndarray]] = [None] * P
    ghost_ids = [np.full(len(need), -1, dtype=np.int64)
                 for need in pattern.needs]
    ghost_writes = [np.zeros(len(need), dtype=np.int64)
                    for need in pattern.needs]

    prev_out: Optional[np.ndarray] = None
    for step in plan.steps:
        if len(step.in_sizes) != P or len(step.out_sizes) != P:
            _fail("step buffer-size arrays not per-proc", step=step.name,
                  in_sizes=len(step.in_sizes), out_sizes=len(step.out_sizes))
        if not step.reads_local:
            if prev_out is None:
                _fail("step reads the staging chain before any step "
                      "produced it", step=step.name)
            if not np.array_equal(step.in_sizes, prev_out):
                _fail("step input sizes do not chain from the previous "
                      "step's outputs", step=step.name)
        src_bufs = ids if step.reads_local else bufs
        src_sizes = pattern.n_local if step.reads_local else step.in_sizes
        if step.writes_ghost:
            dst_bufs: List[np.ndarray] = ghost_ids
            dst_sizes = np.asarray([len(n) for n in pattern.needs])
        else:
            dst_bufs = [np.full(int(step.out_sizes[p]), -1, dtype=np.int64)
                        for p in range(P)]
            dst_sizes = step.out_sizes
        written = [np.zeros(int(dst_sizes[p]), dtype=np.int64)
                   for p in range(P)]
        for m in step.messages:
            if not (0 <= m.src < P and 0 <= m.dst < P):
                _fail("message endpoint outside the process group",
                      step=step.name, src=m.src, dst=m.dst, n_procs=P)
            if m.size == 0:
                continue
            if int(m.src_idx.min()) < 0 or \
                    int(m.src_idx.max()) >= int(src_sizes[m.src]):
                _fail("message gathers outside its source buffer",
                      step=step.name, src=m.src, dst=m.dst,
                      index=int(m.src_idx.max()),
                      buffer=int(src_sizes[m.src]))
            if int(m.dst_idx.min()) < 0 or \
                    int(m.dst_idx.max()) >= int(dst_sizes[m.dst]):
                _fail("message scatters outside its destination buffer",
                      step=step.name, src=m.src, dst=m.dst,
                      index=int(m.dst_idx.max()),
                      buffer=int(dst_sizes[m.dst]))
            src = src_bufs[m.src]
            if src is None:
                _fail("message reads a buffer no prior step wrote",
                      step=step.name, src=m.src)
            vals = src[m.src_idx]
            if np.any(vals < 0):
                j = int(m.src_idx[np.argmax(vals < 0)])
                _fail("message forwards an undefined staging slot",
                      step=step.name, src=m.src, dst=m.dst, slot=j)
            dst_bufs[m.dst][m.dst_idx] = vals
            np.add.at(written[m.dst], m.dst_idx, 1)
            if step.writes_ghost:
                np.add.at(ghost_writes[m.dst], m.dst_idx, 1)
        for p in range(P):
            if np.any(written[p] > 1):
                j = int(np.argmax(written[p] > 1))
                _fail("two messages deliver into the same slot (duplicated "
                      "bytes)", step=step.name, rank=p, slot=j)
        if not step.writes_ghost:
            bufs = dst_bufs
            prev_out = np.asarray(step.out_sizes)
        verify_round_schedule(color_rounds(step.messages), step=step.name)

    for q, need in enumerate(pattern.needs):
        w = ghost_writes[q]
        bad = (w != 1) | (ghost_ids[q] != need)
        if not np.any(bad):
            continue
        j = int(np.argmax(bad))
        if w[j] == 0:
            _fail("ghost slot never written (dropped value)", rank=q,
                  ghost_slot=j, global_index=int(need[j]))
        if w[j] > 1:
            _fail("ghost slot written more than once (duplicated value)",
                  rank=q, ghost_slot=j, global_index=int(need[j]),
                  writes=int(w[j]))
        _fail("ghost slot received the wrong value", rank=q,
              ghost_slot=j, expected=int(need[j]),
              got=int(ghost_ids[q][j]))


# ---------------------------------------------------------------------------
# bound collectives (frozen device plans)
# ---------------------------------------------------------------------------


def verify_device_plan(dplan, pattern: CommPattern) -> None:
    """The frozen per-rank index arrays agree with the pattern padding and
    every wire round's perm is a partial permutation."""
    n_local_pad = int(pattern.n_local.max()) if len(pattern.n_local) else 0
    ghost_pad = int(max((len(n) for n in pattern.needs), default=0))
    if dplan.n_local_pad != n_local_pad or dplan.ghost_pad != ghost_pad:
        _fail("device plan padding disagrees with the pattern",
              n_local_pad=dplan.n_local_pad, expected_local=n_local_pad,
              ghost_pad=dplan.ghost_pad, expected_ghost=ghost_pad)
    for st in dplan.steps:
        for r, rnd in enumerate(st.rounds):
            srcs = [s for s, _ in rnd.perm]
            dsts = [d for _, d in rnd.perm]
            if len(set(srcs)) != len(srcs):
                _fail("device round has a doubly-booked sender",
                      step=st.name, round=r,
                      rank=[s for s in srcs if srcs.count(s) > 1][0])
            if len(set(dsts)) != len(dsts):
                _fail("device round has a doubly-booked receiver",
                      step=st.name, round=r,
                      rank=[d for d in dsts if dsts.count(d) > 1][0])
            if rnd.gather.shape != (dplan.n_procs, rnd.width) or \
                    rnd.scatter.shape != (dplan.n_procs, rnd.width):
                _fail("round index arrays not [P, width]", step=st.name,
                      round=r, width=rnd.width)
            if rnd.width and int(rnd.gather.max()) > st.in_pad:
                _fail("gather index beyond the sentinel slot", step=st.name,
                      round=r, index=int(rnd.gather.max()),
                      sentinel=st.in_pad)
            if rnd.width and int(rnd.scatter.max()) > st.out_pad:
                _fail("scatter index beyond the sentinel slot",
                      step=st.name, round=r, index=int(rnd.scatter.max()),
                      sentinel=st.out_pad)


def verify_collective(coll) -> None:
    """Everything a cached ``NeighborAlltoallV`` promises: a conserving,
    conflict-free plan plus a consistent frozen device plan."""
    verify_plan(coll.plan)
    verify_device_plan(coll.device_plan, coll.plan.pattern)


# ---------------------------------------------------------------------------
# partitions + device ELL forms (bucket exhaustiveness)
# ---------------------------------------------------------------------------


def verify_partition(part) -> None:
    """Every ghost column served by exactly one exchange slot.

    ``needs[p]`` must be strictly increasing (slot -> global column is then
    injective), entirely off-block, and referenced exactly as the ghost CSR
    block's column space; the attached CommPattern must be the one
    ``from_block_partition`` derives from the same needs/ownership.
    """
    P = part.n_procs
    n_cols = int(part.col_offsets[-1])
    for p in range(P):
        clo, chi = int(part.col_offsets[p]), int(part.col_offsets[p + 1])
        need = part.needs[p]
        if len(need):
            if np.any(np.diff(need) <= 0):
                j = int(np.argmax(np.diff(need) <= 0)) + 1
                _fail("needs not strictly increasing (a ghost column is "
                      "served by two exchange slots)", rank=p, ghost_slot=j,
                      global_column=int(need[j]))
            if need.min() < 0 or need.max() >= n_cols:
                _fail("ghost column outside the global column space",
                      rank=p, global_column=int(need.max()), n_cols=n_cols)
            inblock = (need >= clo) & (need < chi)
            if np.any(inblock):
                j = int(np.argmax(inblock))
                _fail("owned column listed as a ghost", rank=p,
                      ghost_slot=j, global_column=int(need[j]))
        gh = part.ghost[p]
        if gh.ncols != len(need):
            _fail("ghost block width disagrees with the exchange slot "
                  "count", rank=p, ghost_cols=gh.ncols, slots=len(need))
        if gh.nnz:
            gidx = gh.indices.astype(np.int64)
            if gidx.min() < 0 or gidx.max() >= len(need):
                _fail("ghost nonzero references a column no exchange slot "
                      "serves (dropped ghost column)", rank=p,
                      ghost_slot=int(gidx.max()), slots=len(need))
            unused = np.setdiff1d(np.arange(len(need)), np.unique(gidx))
        else:
            unused = np.arange(len(need))
        if len(unused):
            _fail("exchange slot serves no nonzero (dead ghost column)",
                  rank=p, ghost_slot=int(unused[0]),
                  global_column=int(need[int(unused[0])]))
        loc = part.local[p]
        if loc.ncols != chi - clo:
            _fail("local block width disagrees with the column block",
                  rank=p, local_cols=loc.ncols, block=chi - clo)
        if loc.nnz and (loc.indices.min() < 0 or
                        int(loc.indices.max()) >= chi - clo):
            _fail("local nonzero outside the owned column block", rank=p,
                  column=int(loc.indices.max()), block=chi - clo)
    pat = part.pattern
    if pat.n_procs != P:
        _fail("partition pattern has the wrong process count",
              pattern=pat.n_procs, partition=P)
    if not np.array_equal(pat.n_local, np.diff(part.col_offsets)):
        _fail("pattern n_local disagrees with the column ownership")
    for p in range(P):
        if not np.array_equal(pat.needs[p], part.needs[p]):
            _fail("pattern needs disagree with the partition needs", rank=p)
    # ownership must be the block partition over col_offsets
    want_owner = np.searchsorted(part.col_offsets, np.arange(n_cols),
                                 side="right") - 1
    if not np.array_equal(pat.owner_proc, want_owner):
        g = int(np.argmax(pat.owner_proc != want_owner))
        _fail("pattern ownership disagrees with the column blocks",
              global_column=g, owner=int(pat.owner_proc[g]),
              expected=int(want_owner[g]))
    verify_pattern(pat)


def _csr_triples(m):
    """(row, col) keys and values of a CSR block's nonzero entries."""
    if not m.nnz:
        return np.zeros((0, 2), np.int64), np.zeros(0)
    rows = m.row_indices().astype(np.int64)
    cols = m.indices.astype(np.int64)
    keep = m.data != 0
    return np.stack([rows[keep], cols[keep]], 1), m.data[keep]


def _multiset_equal(where: str, p: int, keys_a, vals_a, keys_b, vals_b,
                    what_a: str, what_b: str) -> None:
    """The two (row, col) -> value multisets are equal; else the first
    mismatch in (row, col, value) order is named by its row and slot."""
    if len(keys_a) != len(keys_b):
        _fail(f"{where}: nonzero counts differ", rank=p,
              **{what_a: len(keys_a), what_b: len(keys_b)})
    if not len(keys_a):
        return
    if min(keys_a.min(), keys_b.min()) >= 0:
        # one int64 key a (row, col): a two-key sort instead of three
        width = int(max(keys_a[:, 1].max(), keys_b[:, 1].max())) + 1
        ka = keys_a[:, 0] * width + keys_a[:, 1]
        kb = keys_b[:, 0] * width + keys_b[:, 1]
        ia, ib = np.lexsort((vals_a, ka)), np.lexsort((vals_b, kb))
    else:
        ia = np.lexsort((vals_a, keys_a[:, 1], keys_a[:, 0]))
        ib = np.lexsort((vals_b, keys_b[:, 1], keys_b[:, 0]))
    ka, va = keys_a[ia], vals_a[ia]
    kb, vb = keys_b[ib], vals_b[ib]
    bad = np.any(ka != kb, axis=1) | (va != vb)
    if np.any(bad):
        i = int(np.argmax(bad))
        _fail(f"{where}: nonzero multiset mismatch", rank=p,
              row=int(ka[i, 0]), slot=int(ka[i, 1]))


def verify_device_ell(ell, part) -> None:
    """Flat ELL carries exactly the partition's nonzeros, once each, with
    padding entries pointing at the sentinel x slot with value zero."""
    if ell.row_pad != int(np.diff(part.offsets).max()):
        _fail("flat ELL row padding disagrees with the partition",
              row_pad=ell.row_pad)
    for p in range(part.n_procs):
        for blk, cols, vals, width, what in (
            (part.local[p], ell.local_cols[p], ell.local_vals[p],
             ell.in_pad, "local"),
            (part.ghost[p], ell.ghost_cols[p], ell.ghost_vals[p],
             ell.ghost_pad, "ghost"),
        ):
            live = vals != 0
            if np.any(cols[live] >= blk.ncols):
                r = int(np.argwhere(live & (cols >= blk.ncols))[0][0])
                _fail(f"flat ELL {what} entry references a column outside "
                      "the block", rank=p, row=r)
            if np.any(cols > width):
                _fail(f"flat ELL {what} column index beyond the sentinel",
                      rank=p, sentinel=width)
            r_idx, _c = np.nonzero(live)
            keys = np.stack([r_idx.astype(np.int64),
                             cols[live].astype(np.int64)], 1)
            ck, cv = _csr_triples(blk)
            _multiset_equal(f"flat ELL {what} block", p, keys, vals[live],
                            ck, cv, "ell_nnz", "csr_nnz")


def verify_ell_blocked(ell, part, cols=None, vals=None) -> None:
    """Every nonzero of the partition lands in exactly one slot of the
    bucket-major operands K2-K4 read, local columns in local buckets and
    ghost columns in the trailing ghost buckets, and ``bucket_K`` bounds
    every bucket's occupancy.

    ``cols`` / ``vals`` are those operands, ``[P, C, R, K]`` (the card's
    copy, a tensor on any device, or a numpy array); by default the
    bucket-major copy of the host form ``[P, R, C*K]`` that
    ``make_distributed_spmv`` makes, so a layout fault of that copy (a
    bucket read from another row's span) is seen.  The nonzeros are found
    where the operands live and only they come to the host.  Diagnostics
    name the rank, the bucket and the row.
    """
    import torch

    from ..kernels.spmv_ell import to_bucket_major

    bc = ell.block_cols
    Cl, C, K, R = ell.n_local_buckets, ell.n_buckets, ell.K, ell.row_pad
    cols = torch.as_tensor(to_bucket_major(ell.cols, C, "cpu")
                           if cols is None else cols)
    vals = torch.as_tensor(to_bucket_major(ell.vals, C, "cpu")
                           if vals is None else vals)
    if tuple(cols.shape) != (ell.n_procs, C, R, K) or \
            tuple(vals.shape) != (ell.n_procs, C, R, K):
        _fail("blocked ELL operands are not bucket-major [P, C, R, K]",
              shape=tuple(cols.shape), expected=(ell.n_procs, C, R, K))
    bucket_K = np.asarray(ell.bucket_K)
    if len(bucket_K) != C:
        _fail("bucket_K has the wrong bucket count", buckets=len(bucket_K),
              n_buckets=C)
    if int(bucket_K.max(initial=0)) > K:
        _fail("bucket_K exceeds the uniform padded width",
              bucket=int(np.argmax(bucket_K)), K=K)
    for p in range(part.n_procs):
        nz = torch.nonzero(vals[p])               # [n, 3]: bucket, row, k
        at = tuple(nz.unbind(1))
        occ = torch.bincount(nz[:, 0] * R + nz[:, 1], minlength=C * R)
        b_idx, r_idx = (_host(t).astype(np.int64) for t in at[:2])
        inb = _host(cols[p][at]).astype(np.int64)
        vv = _host(vals[p][at])
        occ = _host(occ).reshape(C, R)
        if np.any(inb >= bc) or np.any(inb < 0):
            i = int(np.argmax((inb >= bc) | (inb < 0)))
            _fail("blocked ELL in-bucket index outside the bucket",
                  rank=p, bucket=int(b_idx[i]), row=int(r_idx[i]),
                  block_cols=bc)
        # per-bucket occupancy must respect the recorded bucket_K
        over = np.flatnonzero(occ.max(1) > bucket_K)
        if len(over):
            b = int(over[0])
            _fail("bucket holds more nonzeros than bucket_K records",
                  rank=p, bucket=b, row=int(np.argmax(occ[b])),
                  count=int(occ[b].max()), bucket_K=int(bucket_K[b]))
        # device-side nonzeros as (row, absolute x position)
        keys = np.stack([r_idx, b_idx * bc + inb], 1)
        lk, lv = _csr_triples(part.local[p])
        gk, gv = _csr_triples(part.ghost[p])
        want_keys = np.concatenate([
            lk,
            np.stack([gk[:, 0], Cl * bc + gk[:, 1]], 1) if len(gk)
            else np.zeros((0, 2), np.int64),
        ])
        want_vals = np.concatenate([lv, gv])
        # local nonzeros stay in local buckets, ghosts in ghost buckets
        n_ghost_dev = int((b_idx >= Cl).sum())
        if n_ghost_dev != len(gv):
            _fail("blocked ELL ghost-bucket population disagrees with the "
                  "ghost block (duplicated or dropped bucket entries)",
                  rank=p, ell_ghost_nnz=n_ghost_dev, csr_ghost_nnz=len(gv))
        _multiset_equal_buckets(p, keys, vv, want_keys, want_vals, bc)


def _multiset_equal_buckets(p: int, keys, vals, want_keys, want_vals,
                            bc: int) -> None:
    """:func:`_multiset_equal` for the blocked layout: the first mismatch
    is named by rank, row and bucket."""
    try:
        _multiset_equal("blocked ELL", p, keys, vals, want_keys, want_vals,
                        "ell_nnz", "csr_nnz")
    except VerifyError as e:
        ctx = dict(e.context)
        if "slot" in ctx:
            ctx["bucket"] = int(ctx["slot"]) // bc
        raise VerifyError(str(e).split(" [")[0], **ctx) from None


# ---------------------------------------------------------------------------
# MoE dispatch plans (token conservation)
# ---------------------------------------------------------------------------


def verify_moe_plan(plan) -> None:
    """Geometry arithmetic of an ``MoEPlan``: replication, capacity and the
    region factorization must be internally consistent."""
    if plan.e_log <= 0 or plan.e_phys <= 0 or plan.ep_size <= 0:
        _fail("non-positive MoE geometry", e_log=plan.e_log,
              e_phys=plan.e_phys, ep_size=plan.ep_size)
    if plan.e_phys % plan.e_log != 0:
        _fail("physical experts not a whole replication of logical ones",
              e_phys=plan.e_phys, e_log=plan.e_log)
    if plan.e_phys % plan.ep_size != 0:
        _fail("physical experts do not pack evenly onto the EP group",
              e_phys=plan.e_phys, ep_size=plan.ep_size)
    if plan.e_per_dev * plan.ep_size != plan.e_phys:
        _fail("e_per_dev inconsistent with e_phys / ep_size",
              e_per_dev=plan.e_per_dev, e_phys=plan.e_phys,
              ep_size=plan.ep_size)
    if plan.capacity <= 0:
        _fail("non-positive expert capacity", capacity=plan.capacity)
    if plan.mode != "dense":
        if plan.region_size * plan.devs_per_region != plan.ep_size:
            _fail("region factorization does not cover the EP group",
                  region_size=plan.region_size,
                  devs_per_region=plan.devs_per_region,
                  ep_size=plan.ep_size)
        pair_bound = plan.devs_per_region * plan.e_per_dev * plan.capacity
        if plan.uniq_capacity > pair_bound:
            _fail("uniq_capacity exceeds the exact per-region bound",
                  uniq_capacity=plan.uniq_capacity, bound=pair_bound)
    if plan.top_k > plan.e_log:
        _fail("top_k exceeds the number of logical experts",
              top_k=plan.top_k, e_log=plan.e_log)


def verify_moe_dispatch(plan, tokens_per_lane: int) -> None:
    """Token conservation of the capacity-packed dispatch pattern.

    Synthesizes the plan's routing pattern and checks: every lane owns
    exactly ``tokens_per_lane`` token values; no token is shipped more than
    ``top_k`` times; no (source lane, destination device) pair exceeds the
    hard ``e_per_dev * capacity`` bound; and the transport plan built for
    the plan's own mode conserves the pattern end to end.
    """
    from ..core.locality import build_plan
    from ..models.moe import (
        STRATEGY_OF_MODE,
        dispatch_pattern,
        dispatch_topology,
    )

    verify_moe_plan(plan)
    if plan.mode == "dense":
        return
    pattern, _stats, _fp = dispatch_pattern(plan, int(tokens_per_lane))
    verify_pattern(pattern)
    if pattern.n_procs != plan.ep_size:
        _fail("dispatch pattern lane count disagrees with the EP group",
              lanes=pattern.n_procs, ep_size=plan.ep_size)
    if np.any(pattern.n_local != tokens_per_lane):
        q = int(np.argmax(pattern.n_local != tokens_per_lane))
        _fail("lane owns the wrong token count", rank=q,
              n_local=int(pattern.n_local[q]), tokens=tokens_per_lane)
    # each kept (token, k) pair is one push: a token value may be requested
    # at most top_k times across the whole group
    counts = np.zeros(pattern.n_global, dtype=np.int64)
    for need in pattern.needs:
        np.add.at(counts, need, 1)
    if counts.max(initial=0) > plan.top_k:
        g = int(np.argmax(counts))
        _fail("token shipped more often than top_k routes allow",
              global_index=g, copies=int(counts[g]), top_k=plan.top_k)
    # per (src lane, dst device): at most capacity per hosted expert
    bound = plan.e_per_dev * plan.capacity
    for q, need in enumerate(pattern.needs):
        if not len(need):
            continue
        per_src = np.bincount(pattern.owner_proc[need],
                              minlength=plan.ep_size)
        if per_src.max() > bound:
            src = int(np.argmax(per_src))
            _fail("capacity overflow: lane ships more tokens to a device "
                  "than its experts can seat", src=src, dst=q,
                  shipped=int(per_src.max()), bound=bound)
    cplan = build_plan(pattern, dispatch_topology(plan),
                       STRATEGY_OF_MODE[plan.mode])
    verify_plan(cplan, pattern)


# ---------------------------------------------------------------------------
# dense collective plans (conflict-freedom + contribution conservation)
# ---------------------------------------------------------------------------


def verify_dense_plan(plan) -> None:
    """Full check of a ``core.dense.DensePlan``.

    Structural: one segment per device, non-negative counts, in-range and
    duplicate-free segment lists.  Conflict-freedom: every round reduces to
    a :class:`Round` and must pass :func:`verify_round_schedule`.
    Conservation: the schedule is executed symbolically with *contribution
    vectors* as payload (``contrib[p][s]`` is the 0/1 vector of source
    devices whose contribution to segment ``s`` device ``p`` holds), and
    the final state must be the collective's definition: allreduce: every
    device holds every contribution of every segment; reduce_scatter:
    device ``p`` holds every contribution of segment ``p``; allgatherv:
    every device holds exactly the owner's copy of every segment.
    """
    P = plan.topo.n_procs
    n_seg = len(plan.counts)
    if n_seg != P:
        _fail("dense plan must carry one segment per device",
              segments=n_seg, n_procs=P)
    if np.any(plan.counts < 0):
        s = int(np.argmax(plan.counts < 0))
        _fail("negative segment count", segment=s,
              count=int(plan.counts[s]))
    if plan.collective not in ("allreduce", "allgatherv", "reduce_scatter"):
        _fail("unknown dense collective", collective=plan.collective)

    for r, rnd in enumerate(plan.rounds):
        if len(rnd.segs) != len(rnd.pairs):
            _fail("dense round segment lists disagree with pair count",
                  round=r, pairs=len(rnd.pairs), segs=len(rnd.segs))
        for (src, dst), segs in zip(rnd.pairs, rnd.segs):
            if len(segs) and (segs.min() < 0 or segs.max() >= n_seg):
                _fail("dense round moves a segment outside the plan",
                      round=r, src=src, dst=dst,
                      segment=int(segs.max()), segments=n_seg)
            if len(np.unique(segs)) != len(segs):
                _fail("dense round sends a segment twice in one message",
                      round=r, src=src, dst=dst)
    verify_round_schedule(
        [Round(list(r.pairs), list(r.segs), list(r.segs))
         for r in plan.rounds],
        step=f"dense/{plan.collective}/{plan.variant}",
    )

    # symbolic execution with contribution-set payloads
    eye = np.eye(P, dtype=np.int64)
    if plan.collective == "allgatherv":
        contrib = [np.zeros((n_seg, P), dtype=np.int64) for _ in range(P)]
        for p in range(P):
            contrib[p][p] = eye[p]
    else:
        contrib = [np.tile(eye[p], (n_seg, 1)) for p in range(P)]
    for rnd in plan.rounds:
        payloads = [
            (dst, segs, contrib[src][segs].copy())
            for (src, dst), segs in zip(rnd.pairs, rnd.segs)
        ]
        for dst, segs, pay in payloads:
            if rnd.reduce:
                contrib[dst][segs] += pay
            else:
                contrib[dst][segs] = pay

    ones = np.ones(P, dtype=np.int64)
    for p in range(P):
        if plan.collective == "allreduce":
            bad = np.flatnonzero(~(contrib[p] == ones).all(axis=1))
            if len(bad):
                s = int(bad[0])
                _fail("allreduce segment not an exact sum of all "
                      "contributions", rank=p, segment=s,
                      contributions=contrib[p][s].tolist())
        elif plan.collective == "reduce_scatter":
            if not np.array_equal(contrib[p][p], ones):
                _fail("reduce_scatter own segment not an exact sum of all "
                      "contributions", rank=p,
                      contributions=contrib[p][p].tolist())
        else:  # allgatherv
            if not np.array_equal(contrib[p], eye):
                s = int(np.argmax((contrib[p] != eye).any(axis=1)))
                _fail("allgatherv segment is not exactly the owner's copy "
                      "(dropped, duplicated or summed values)", rank=p,
                      segment=s, contributions=contrib[p][s].tolist())


# ---------------------------------------------------------------------------
# cache-insertion dispatch (the REPRO_VERIFY hook)
# ---------------------------------------------------------------------------


def verify_cache_value(ns: str, value) -> None:
    """Verify a value entering a ``PlanCache`` namespace.

    Collectives get the full plan + device-plan check; MoE plan entries
    (stored as ``(plan, init_seconds)``) get the geometry check (the
    token-level :func:`verify_moe_dispatch` needs the token count, which
    the cache does not see, and runs in ``ServeEngine.verify``).  Executor
    namespaces hold opaque callables; their audit happens where the plan is
    still in scope (``PlanCache.executor`` / ``dense_executor``).
    """
    if ns == "collective":
        verify_collective(value)
    elif ns == "moe_plan":
        plan = value[0] if isinstance(value, tuple) else value
        if hasattr(plan, "e_phys"):
            verify_moe_plan(plan)
    elif ns == "dense_plan":
        # stored as ((DensePlan, DenseSelection), init_seconds): unwrap
        # tuples until the object with a round schedule surfaces
        plan = value
        while isinstance(plan, tuple) and not hasattr(plan, "rounds"):
            plan = plan[0]
        if hasattr(plan, "rounds"):
            verify_dense_plan(plan)
