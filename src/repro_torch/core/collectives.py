"""Device-side execution of CommPlans: edge-colored rounds on rank-stacked
tensors.

The ranks of the distributed solve are stacked along the leading dim of one
tensor on one device.  A plan's MPI world of independent ragged sends
becomes a *round schedule*: the planner edge-colors the message multigraph
(``plan.color_rounds``) so that within a round every rank sends to at most
one peer and receives from at most one peer.  A round is a gather of each
rank's send slots, one permutation along the rank dim (``ppermute``
semantics: a rank that receives nothing in a round gets zeros), and a
scatter into each rank's output slots, padded to the round's widest
message.

Padding bookkeeping uses a sentinel slot: every staging buffer carries one
extra row; gather indices pointing at it read zeros, scatter indices
pointing at it write zeros, and it is dropped when the buffer is consumed.

The executor is built once per plan ("init") and called every iteration:
persistent-collective semantics.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from .plan import CommPlan, color_rounds


@dataclass
class DeviceRound:
    perm: List[Tuple[int, int]]
    width: int
    gather: np.ndarray   # [P, width] indices into step input buffer (pad = in_pad)
    scatter: np.ndarray  # [P, width] indices into step output buffer (pad = out_pad)


@dataclass
class DeviceStep:
    name: str
    reads_local: bool
    writes_ghost: bool
    in_pad: int    # padded per-rank input size (excl. sentinel row)
    out_pad: int
    local_gather: np.ndarray   # [P, Lw] local-copy gathers (pad = in_pad)
    local_scatter: np.ndarray  # [P, Lw]
    rounds: List[DeviceRound]


@dataclass
class DevicePlan:
    strategy: str
    n_procs: int
    n_local_pad: int
    ghost_pad: int
    steps: List[DeviceStep]

    @property
    def n_rounds(self) -> int:
        return sum(len(s.rounds) for s in self.steps)

    @property
    def padded_wire_values(self) -> int:
        return sum(
            r.width * len(r.perm) for s in self.steps for r in s.rounds
        )


def _pack(idx_lists: Sequence[Tuple[int, np.ndarray]], P: int, width: int,
          pad: int) -> np.ndarray:
    out = np.full((P, width), pad, dtype=np.int32)
    for proc, idx in idx_lists:
        out[proc, : len(idx)] = idx
    return out


def build_device_plan(plan: CommPlan) -> DevicePlan:
    """Freeze a CommPlan into padded per-rank index arrays + round schedule."""
    P_ = plan.topo.n_procs
    n_local_pad = int(plan.pattern.n_local.max())
    ghost_pad = int(max((len(n) for n in plan.pattern.needs), default=0))

    dsteps: List[DeviceStep] = []
    for step in plan.steps:
        in_pad = n_local_pad if step.reads_local else int(step.in_sizes.max())
        out_pad = ghost_pad if step.writes_ghost else int(step.out_sizes.max())
        local = [m for m in step.messages if m.src == m.dst and m.size > 0]
        lw = max((m.size for m in local), default=0)
        lg = _pack([(m.src, m.src_idx) for m in local], P_, lw, in_pad)
        ls = _pack([(m.dst, m.dst_idx) for m in local], P_, lw, out_pad)
        rounds = []
        for rnd in color_rounds(step.messages):
            w = rnd.width
            g = _pack(
                [(sd[0], si) for sd, si in zip(rnd.pairs, rnd.src_idx)],
                P_, w, in_pad,
            )
            s = _pack(
                [(sd[1], di) for sd, di in zip(rnd.pairs, rnd.dst_idx)],
                P_, w, out_pad,
            )
            rounds.append(DeviceRound(list(rnd.pairs), w, g, s))
        dsteps.append(
            DeviceStep(
                name=step.name,
                reads_local=step.reads_local,
                writes_ghost=step.writes_ghost,
                in_pad=in_pad,
                out_pad=out_pad,
                local_gather=lg,
                local_scatter=ls,
                rounds=rounds,
            )
        )
    return DevicePlan(plan.strategy, P_, n_local_pad, ghost_pad, dsteps)


# ---------------------------------------------------------------------------
# rank-stacked executor
# ---------------------------------------------------------------------------


@dataclass
class _Round:
    src: torch.Tensor      # [n_pairs] sending ranks
    dst: torch.Tensor      # [n_pairs] receiving ranks
    gather: torch.Tensor   # [P, width] int64
    scatter: torch.Tensor  # [P, width] int64


@dataclass
class _Step:
    reads_local: bool
    writes_ghost: bool
    out_pad: int
    local: Optional[Tuple[torch.Tensor, torch.Tensor]]
    rounds: List[_Round]


def make_executor(
    dplan: DevicePlan, device
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build ``exec(x) -> ghosts`` with the plan's index arrays on ``device``.

    ``x``: [n_procs, n_local_pad, d] on ``device``; returns
    [n_procs, ghost_pad, d] with the delivered values.  The exchange is a
    pure copy, so it delivers exactly the values
    ``CommPlan.execute_numpy`` does.
    """
    device = resolve_device(device)

    def idx(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    steps: List[_Step] = []
    for st in dplan.steps:
        local = None
        if st.local_gather.shape[1] > 0:
            local = (idx(st.local_gather), idx(st.local_scatter))
        rounds = [
            _Round(idx([s for s, _ in r.perm]), idx([d for _, d in r.perm]),
                   idx(r.gather), idx(r.scatter))
            for r in st.rounds
        ]
        steps.append(_Step(st.reads_local, st.writes_ghost, st.out_pad,
                           local, rounds))
    P_ = dplan.n_procs
    ranks = torch.arange(P_, device=device)[:, None]

    def exec_fn(x: torch.Tensor) -> torch.Tensor:
        if x.shape[:2] != (P_, dplan.n_local_pad) or x.device != device:
            raise ValueError(
                f"x {tuple(x.shape)} on {x.device}: expected "
                f"[{P_}, {dplan.n_local_pad}, d] on {device}"
            )
        trailing = x.shape[2:]
        sentinel = x.new_zeros((P_, 1) + trailing)
        xs = torch.cat([x, sentinel], dim=1)
        ghost = x.new_zeros((P_, dplan.ghost_pad + 1) + trailing)
        buf = None
        for st in steps:
            src = xs if st.reads_local else buf
            out = ghost if st.writes_ghost else x.new_zeros(
                (P_, st.out_pad + 1) + trailing
            )
            if st.local is not None:
                lg, ls = st.local
                out[ranks, ls] = src[ranks, lg]
            for rnd in st.rounds:
                sendbuf = src[ranks, rnd.gather]
                recvbuf = torch.zeros_like(sendbuf)
                recvbuf[rnd.dst] = sendbuf[rnd.src]
                out[ranks, rnd.scatter] = recvbuf
            if st.writes_ghost:
                ghost = out
            else:
                buf = out
        return ghost[:, :-1]

    return exec_fn


def pack_local_values(
    plan: CommPlan, local_vals: Sequence[np.ndarray], d: Optional[int] = None
) -> np.ndarray:
    """[P, n_local_pad(, d)] global array from ragged per-proc values."""
    P_ = plan.topo.n_procs
    n_pad = int(plan.pattern.n_local.max())
    trailing = local_vals[0].shape[1:]
    out = np.zeros((P_, n_pad) + trailing, dtype=local_vals[0].dtype)
    for p, v in enumerate(local_vals):
        out[p, : len(v)] = v
    return out


def unpack_ghosts(plan: CommPlan, ghosts) -> List[np.ndarray]:
    """Per-proc ghost arrays from the executor's [P, ghost_pad(, d)] output
    (a numpy array or a tensor on any device)."""
    if isinstance(ghosts, torch.Tensor):
        ghosts = ghosts.cpu().numpy()
    return [
        np.asarray(ghosts[p, : len(plan.pattern.needs[p])])
        for p in range(plan.topo.n_procs)
    ]
