"""Audit of bound rank-stacked executors against their plans.

Ported in place of ``repro.verify.jaxpr_audit``.  ``repro`` traces a bound
``shard_map`` executor with ``jax.make_jaxpr`` and proves its collective
sequence is the frozen ``DevicePlan``'s, round for round.  The port's
executors (``core.collectives.make_executor``, ``core.dense.bind_dense``)
stack the ranks on one device, so a round is not a collective but a gather
of every rank's send slots, one permutation along the rank dim and a
scatter into the receivers' slots.  This module runs a bound executor once
on a zero input under a ``TorchDispatchMode`` that records every aten
indexing op with its index tensors, and proves:

* the sequence of gathers, rank permutations and scatters is the plan's
  steps and rounds, in order, with the same index arrays (a local-copy
  gather and scatter first in a step that has one; then per round the
  ``[ranks, gather]`` read, the ``src`` -> ``dst`` permutation and the
  ``[ranks, scatter]`` write; for a dense plan the segment rows of each
  round, recomputed here from ``DensePlan.rounds``);
* no index depends on the data: every tensor computed from the input is
  tracked, and an indexing op whose index is one of them is refused;
* no other indexing op (``gather``, ``scatter``, ``index_select``, ...)
  moves values off the plan.

An executor bound to another plan fails the first comparison, with the
step, round, rank and slot named.  Running on a zero input of width one is
cheap on the card and on the CPU alike.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from .. import resolve_device
from .invariants import _fail

#: aten ops that read or write values at index tensors
_INDEX_READ = ("index.Tensor",)
_INDEX_WRITE = ("index_put_.default", "index_put.default",
                "_index_put_impl_.default")
_OFF_PLAN = ("gather", "scatter", "scatter_add", "scatter_reduce",
             "index_select", "take", "index_add", "index_copy",
             "index_fill", "masked_scatter")


@dataclass
class IndexRecord:
    """One indexing op of a traced executor."""

    kind: str                          # "gather" (read) | "scatter" (write)
    index: Tuple[np.ndarray, ...]      # the index tensors, on the host


def _flat_tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _flat_tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _flat_tensors(o)]
    return []


def trace_indexing(fn, x: torch.Tensor) -> List[IndexRecord]:
    """Run ``fn(x)`` once and record its indexing ops in program order.

    Raises :class:`~repro_torch.verify.VerifyError` if an index tensor is
    computed from ``x`` (data-dependent) or an off-plan indexing op runs.
    """
    from torch.utils._python_dispatch import TorchDispatchMode

    records: List[IndexRecord] = []
    tainted = {id(x)}
    alive = [x]           # keeps ids unique while the trace runs

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            op = str(func).split("aten.")[-1]
            base = op.split(".")[0].rstrip("_")
            if base in _OFF_PLAN:
                _fail("off-plan indexing op in an executor", op=op)
            if op in _INDEX_READ or op in _INDEX_WRITE:
                idx = [t for t in args[1] if t is not None]
                for t in idx:
                    if id(t) in tainted:
                        _fail("executor index depends on the data", op=op,
                              shape=tuple(t.shape))
                records.append(IndexRecord(
                    "gather" if op in _INDEX_READ else "scatter",
                    tuple(t.detach().cpu().numpy() for t in idx)))
            out = func(*args, **kwargs)
            ins = _flat_tensors(args) + _flat_tensors(kwargs)
            if any(id(t) in tainted for t in ins):
                for t in _flat_tensors(out):
                    tainted.add(id(t))
                    alive.append(t)
                if op.split(".")[0].endswith("_"):
                    tainted.add(id(args[0]))     # written in place
            alive.extend(ins)
            return out

    with Recorder():
        fn(x)
    return records


def _trace(fn, x: torch.Tensor, what: str) -> List[IndexRecord]:
    """:func:`trace_indexing`; an executor that refuses an input of its
    plan's shape is bound to another plan."""
    try:
        return trace_indexing(fn, x)
    except (ValueError, RuntimeError, IndexError) as e:
        _fail(f"executor refuses an input of the {what}'s shape (bound to "
              "another plan)", shape=tuple(x.shape), error=str(e)[:120])


def _ranks_ok(a: np.ndarray, P: int) -> bool:
    return a.shape in ((P, 1), (P,)) and np.array_equal(
        a.reshape(-1), np.arange(P))


def _first_diff(got: np.ndarray, exp: np.ndarray) -> dict:
    """Where two index arrays first differ, both padded with -1 to a
    common shape: ``rank`` and ``slot`` for ``[P, width]`` arrays, the
    ``position`` in the pair list and the plan's ``rank`` there for a
    permutation's rank list."""
    if got.ndim == 2 and exp.ndim == 2 and got.shape[0] == exp.shape[0]:
        w = max(got.shape[1], exp.shape[1])
        g = np.full((got.shape[0], w), -1, dtype=np.int64)
        e = np.full((exp.shape[0], w), -1, dtype=np.int64)
        g[:, :got.shape[1]] = got
        e[:, :exp.shape[1]] = exp
        r, c = (int(v) for v in np.argwhere(g != e)[0])
        return dict(rank=r, slot=c, traced=int(g[r, c]), plan=int(e[r, c]))
    g, e = got.reshape(-1), exp.reshape(-1)
    n = max(len(g), len(e))
    g = np.concatenate([g, np.full(n - len(g), -1)])
    e = np.concatenate([e, np.full(n - len(e), -1)])
    i = int(np.argmax(g != e))
    return dict(position=i, rank=int(e[i] if e[i] >= 0 else g[i]),
                traced=int(g[i]), plan=int(e[i]))


def _compare(records: List[IndexRecord], want: List[tuple],
             what: str) -> None:
    """``want``: (kind, index arrays, context) per expected op, in order;
    an array given as ``None`` stands for the rank column
    ``arange(P)[:, None]``.  The first difference is named with its step,
    round, rank and slot."""
    for rec, (kind, arrays, ctx) in zip(records, want):
        if rec.kind != kind:
            _fail(f"executor does a {rec.kind} where the {what} has a "
                  f"{kind}", **ctx)
        if len(rec.index) != len(arrays):
            _fail(f"executor indexes with {len(rec.index)} tensors where "
                  f"the {what} has {len(arrays)}", **ctx)
        for got, exp in zip(rec.index, arrays):
            if exp is None:
                if not _ranks_ok(got, ctx["n_procs"]):
                    _fail(f"executor's rank index is not the {what}'s "
                          "rank order", **ctx)
                continue
            exp = np.asarray(exp)
            if got.shape != exp.shape or np.any(got != exp):
                _fail(f"executor's {kind} indices disagree with the {what}",
                      **_first_diff(got, exp), **ctx)
    if len(records) != len(want):
        ctx = want[len(records)][2] if len(want) > len(records) else {}
        _fail(f"traced indexing op count disagrees with the {what}",
              traced=len(records), plan=len(want), **ctx)


def audit_executor(fn, dplan, device=None,
                   dtype=torch.float32) -> List[IndexRecord]:
    """Prove a bound exchange executor implements exactly ``dplan``.

    Runs ``fn`` on a zero ``[P, n_local_pad, 1]`` input on ``device``
    (default ``cuda``, the executor's) and checks, against the frozen plan,
    one local-copy gather + scatter in each step that has local copies and
    per wire round the ``[ranks, gather]`` read, the permutation (the
    ``src`` ranks read, the ``dst`` ranks written, in the round's pair
    order) and the ``[ranks, scatter]`` write, with the plan's arrays.
    Returns the records.
    """
    device = resolve_device(device)
    P = dplan.n_procs
    x = torch.zeros((P, dplan.n_local_pad, 1), dtype=dtype, device=device)
    records = _trace(fn, x, "plan")
    want: List[tuple] = []
    for st in dplan.steps:
        if st.local_gather.shape[1] > 0:
            ctx = dict(step=st.name, round="local", n_procs=P)
            want += [("gather", (None, st.local_gather), ctx),
                     ("scatter", (None, st.local_scatter), ctx)]
        for r, rnd in enumerate(st.rounds):
            ctx = dict(step=st.name, round=r, n_procs=P)
            want += [
                ("gather", (None, rnd.gather), ctx),
                ("gather", ([s for s, _ in rnd.perm],), ctx),
                ("scatter", ([d for _, d in rnd.perm],), ctx),
                ("scatter", (None, rnd.scatter), ctx),
            ]
    _compare(records, want, "plan")
    return records


def audit_dense_executor(fn, plan, device=None,
                         dtype=torch.float32) -> List[IndexRecord]:
    """Prove a bound dense executor (``core.dense.bind_dense``) implements
    exactly ``plan``.

    Runs ``fn`` on a zero input of the collective's rank-stacked shape and
    checks, per plan round in order, the read of each sender's segment
    rows, the permutation (every receiver reads its sender, a rank that
    receives nothing the zero row ``P``), for a reducing round the read of
    the receivers' rows, and the write of them, with the segment rows
    recomputed from ``plan.rounds`` (the sentinel row ``n_seg`` pads); an
    allgatherv first places each rank's segment on the diagonal, a
    reduce_scatter last reads it.
    """
    device = resolve_device(device)
    P = plan.topo.n_procs
    n_seg, cmax = len(plan.counts), plan.cmax
    shape = (P, cmax) if plan.collective == "allgatherv" \
        else (P, n_seg, cmax)
    records = _trace(fn, torch.zeros(shape, dtype=dtype, device=device),
                     "dense plan")
    diag = np.arange(P)
    want: List[tuple] = []
    if plan.collective == "allgatherv":
        want.append(("scatter", (diag, diag),
                     dict(round="diagonal", n_procs=P)))
    for r, rnd in enumerate(plan.rounds):
        w = max((len(s) for s in rnd.segs), default=0)
        g = np.full((P, w), n_seg, dtype=np.int64)
        s = np.full((P, w), n_seg, dtype=np.int64)
        src_of = np.full(P, P, dtype=np.int64)
        for (src, dst), segs in zip(rnd.pairs, rnd.segs):
            g[src, :len(segs)] = segs
            s[dst, :len(segs)] = segs
            src_of[dst] = src
        ctx = dict(collective=plan.collective, variant=plan.variant,
                   round=r, n_procs=P)
        want += [("gather", (None, g), ctx), ("gather", (src_of,), ctx)]
        if rnd.reduce:
            want.append(("gather", (None, s), ctx))
        want.append(("scatter", (None, s), ctx))
    if plan.collective == "reduce_scatter":
        want.append(("gather", (diag, diag),
                     dict(round="diagonal", n_procs=P)))
    _compare(records, want, "dense plan")
    return records


__all__ = ["IndexRecord", "trace_indexing", "audit_executor",
           "audit_dense_executor"]
