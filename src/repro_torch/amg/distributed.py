"""Device-resident distributed AMG solve on persistent neighborhood collectives.

A BoomerAMG-style V-cycle whose every SpMV-shaped halo exchange (operator,
restriction, prolongation, at every level) runs through a locality-aware
persistent neighborhood collective.  The P ranks are stacked along the
leading dim of every tensor on one device: vectors are ``[P, pad]``
tensors, and each exchange is the rank-stacked round executor of
``core.collectives``.

Setup (:meth:`DistributedHierarchy.setup`) is the persistent init: each
hierarchy level is block-partitioned, its communication pattern extracted,
and a ``NeighborAlltoallV`` initialized *once* with the Section-5 dynamic
selector (``strategy="auto"``) under the given machine model.  All plans
and bound executors go through a :class:`~repro_torch.core.cache.PlanCache`,
so repeated setups on the same grid skip re-planning entirely.

Solve: a V-cycle (Chebyshev smoother, degrees matching the host solver
exactly) over ``[P, pad]`` block vectors, run eagerly; matvecs compose the
plan executor with the ELL SpMV kernels (``sparse.device``).  With the same
rho estimates the residual history tracks the host
:func:`~repro_torch.amg.hierarchy.solve` to rounding error.

Entry points: ``DistributedHierarchy.setup(...)``, ``.solve(b)``,
``.describe()``, ``.selection_table()``, ``.kernel_table()``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.cache import PlanCache, default_plan_cache
from ..core.costmodel import LASSEN, MachineParams, plan_time
from ..core.neighborhood import NeighborAlltoallV
from ..core.plan import Topology
from ..core.selection import SelectionReport
from ..obs import default_obs
from ..sparse.device import (
    DEFAULT_BLOCK_COLS,
    DeviceEll,
    DeviceEllBlocked,
    KernelSelection,
    OverlapSelection,
    make_distributed_spmv,
    pack_vector,
    partitioned_to_device,
    select_spmv_kernel,
    select_spmv_overlap,
    unpack_vector,
)
from ..sparse.partition import (
    PartitionedCSR,
    block_offsets,
    partition_rect_csr,
)
from .hierarchy import Hierarchy, inv_diag

_OBS = default_obs()


@dataclass
class DistOp:
    """One partitioned operator + its persistent collective + device form.

    ``kernel`` records the flat-vs-blocked SpMV choice and ``overlap`` the
    exchange/compute-overlap schedule choice, next to the plan's Section-5
    transport choice, so all three selections travel with the operator.
    """

    part: PartitionedCSR
    coll: NeighborAlltoallV
    ell: "DeviceEll | DeviceEllBlocked"
    kernel: Optional[KernelSelection] = None
    overlap: Optional[OverlapSelection] = None

    @property
    def strategy(self) -> str:
        return self.coll.strategy

    @property
    def selection(self) -> Optional[SelectionReport]:
        return self.coll.selection

    @property
    def kernel_variant(self) -> str:
        return self.kernel.variant if self.kernel else "flat"

    @property
    def overlap_mode(self) -> str:
        return self.overlap.mode if self.overlap else "off"


@dataclass
class DistributedLevel:
    index: int
    n: int                       # global unknowns at this level
    pad: int                     # per-rank vector padding
    A: DistOp
    dinv: torch.Tensor           # [P, pad] Jacobi scaling (0 in padding)
    rho: float                   # spectral-radius estimate (from host setup)
    R: Optional[DistOp] = None   # fine -> coarse (None on coarsest)
    P: Optional[DistOp] = None   # coarse -> fine


def _default_procs_per_region(n_procs: int) -> int:
    for ppr in (4, 2):
        if n_procs % ppr == 0 and n_procs > ppr:
            return ppr
    return 1


class DistributedHierarchy:
    """A host AMG hierarchy lowered to a rank-stacked device solve."""

    def __init__(
        self,
        levels: List[DistributedLevel],
        device: torch.device,
        topo: Topology,
        cache: PlanCache,
        dtype,
        strategy: str,
        params: MachineParams,
        value_bytes: int,
    ):
        self.levels = levels
        self.device = device
        self.topo = topo
        self.cache = cache
        self.dtype = dtype
        # the cache key under which every collective was initialized;
        # executor lookups must reuse it verbatim to hit the same entries
        self.strategy = strategy
        self.params = params
        self.value_bytes = value_bytes
        self._Amv = [self._bind(lv.A) for lv in levels]
        self._Rmv = [self._bind(lv.R) if lv.R is not None else None
                     for lv in levels]
        self._Pmv = [self._bind(lv.P) if lv.P is not None else None
                     for lv in levels]

    # ------------------------------------------------------------- setup
    @classmethod
    def setup(
        cls,
        h: Hierarchy,
        n_procs: int = 8,
        procs_per_region: Optional[int] = None,
        strategy: str = "auto",
        params: MachineParams = LASSEN,
        value_bytes: int = 8,
        cache: Optional[PlanCache] = None,
        dtype=np.float64,
        spmv_variant: str = "flat",
        spmv_vmem_limit: Optional[int] = None,
        spmv_block_cols: int = DEFAULT_BLOCK_COLS,
        spmv_overlap: str = "off",
        spmv_overlap_figures: Optional[Dict[str, float]] = None,
        device=None,
    ) -> "DistributedHierarchy":
        """Partition every level over ``n_procs`` ranks and init its
        collectives once (persistent), with every rank's data stacked on
        ``device`` (default ``cuda``).

        ``strategy="auto"`` runs the paper's Section-5 selector per level
        and per transfer operator under ``params``; pass a concrete
        strategy to pin it.  ``spmv_variant`` is ``"flat"``, ``"blocked"``
        or ``"auto"``; ``auto`` selects per operator from the modeled
        footprint against ``spmv_vmem_limit``, which it then needs.
        ``spmv_overlap`` is ``"off"``, ``"on"`` or ``"auto"``; ``auto``
        selects per operator from the device figures
        ``spmv_overlap_figures`` (``hbm_bw``, ``vpu_flops``, ``launch_s``),
        which it then needs.  All choices are recorded on each
        :class:`DistOp`.
        """
        device = resolve_device(device)
        topo = Topology(
            n_procs, procs_per_region or _default_procs_per_region(n_procs)
        )
        cache = cache if cache is not None else default_plan_cache()
        figures = dict(spmv_overlap_figures or {})

        def make_op(mat, row_off, col_off) -> DistOp:
            part = partition_rect_csr(mat, row_off, col_off)
            coll = cache.collective(
                part.pattern, topo, strategy, value_bytes, params
            )
            sel = select_spmv_kernel(
                part, variant=spmv_variant,
                vmem_limit_bytes=spmv_vmem_limit,
                value_bytes=value_bytes, block_cols=spmv_block_cols,
            )
            ell = partitioned_to_device(part, sel, dtype, spmv_block_cols)
            osel = select_spmv_overlap(
                part, plan_time(coll.plan, params),
                mode=spmv_overlap, value_bytes=value_bytes, **figures,
            )
            return DistOp(part, coll, ell, sel, osel)

        offs = [block_offsets(lvl.A.nrows, n_procs) for lvl in h.levels]
        levels: List[DistributedLevel] = []
        with _OBS.span("amg/setup", n_procs=n_procs, strategy=strategy,
                       levels=len(h.levels)):
            for k, lvl in enumerate(h.levels):
                with _OBS.span("amg/build_level", level=k,
                               n=lvl.A.nrows) as lsp:
                    A_op = make_op(lvl.A, offs[k], offs[k])
                    pad = int(np.diff(offs[k]).max())
                    dinv = pack_vector(offs[k], pad,
                                       inv_diag(lvl.A).astype(dtype))
                    dl = DistributedLevel(
                        index=k,
                        n=lvl.A.nrows,
                        pad=pad,
                        A=A_op,
                        dinv=torch.as_tensor(dinv, device=device),
                        rho=lvl.rho or 1.0,
                    )
                    if lvl.P is not None and k + 1 < len(h.levels):
                        dl.R = make_op(lvl.R, offs[k + 1], offs[k])
                        dl.P = make_op(lvl.P, offs[k], offs[k + 1])
                    levels.append(dl)
                    lsp.set(strategy=A_op.strategy,
                            kernel=A_op.kernel_variant,
                            overlap=A_op.overlap_mode)
            return cls(levels, device, topo, cache, dtype, strategy, params,
                       value_bytes)

    # ------------------------------------------------- device programs
    def _bind(self, op: DistOp) -> Callable:
        exchange = None
        if op.ell.ghost_pad:
            exchange = self.cache.executor(
                op.part.pattern, self.topo, self.device,
                strategy=self.strategy, value_bytes=self.value_bytes,
                params=self.params,
            )
        return make_distributed_spmv(
            op.ell, exchange, overlap=(op.overlap_mode == "on"),
            device=self.device,
        )

    def _cheby(self, k: int, x, b, degree: int):
        """Chebyshev smoother: same arithmetic as the host ``chebyshev``."""
        lv = self.levels[k]
        Amv = self._Amv[k]
        dinv = lv.dinv
        rho = lv.rho
        upper = 1.1 * rho
        lower = 0.30 * rho
        theta = 0.5 * (upper + lower)
        delta = 0.5 * (upper - lower)
        sigma = theta / delta
        rho_k = 1.0 / sigma
        r = dinv * (b - Amv(x))
        p = r / theta
        x = x + p
        for _ in range(degree - 1):
            rho_next = 1.0 / (2.0 * sigma - rho_k)
            r = dinv * (b - Amv(x))
            p = rho_next * rho_k * p + 2.0 * rho_next / delta * r
            x = x + p
            rho_k = rho_next
        return x

    def _vcycle(self, k: int, b):
        lv = self.levels[k]
        zero = torch.zeros_like(b)
        if lv.R is None or k == len(self.levels) - 1:
            return self._cheby(k, zero, b, degree=24)
        x = self._cheby(k, zero, b, degree=3)       # pre-smooth
        r = b - self._Amv[k](x)
        rc = self._Rmv[k](r)
        ec = self._vcycle(k + 1, rc)
        x = x + self._Pmv[k](ec)
        return self._cheby(k, x, b, degree=3)       # post-smooth

    def _step(self, x, b):
        """One iteration: residual norm of ``x``, and ``x`` plus a V-cycle
        on the residual."""
        r = b - self._Amv[0](x)
        rn = torch.linalg.norm(r)
        return x + self._vcycle(0, r), rn

    # -------------------------------------------------------------- solve
    def solve(
        self,
        b: np.ndarray,
        tol: float = 1e-8,
        max_iters: int = 100,
    ) -> Tuple[np.ndarray, List[float]]:
        """AMG-preconditioned stationary iteration on the device.

        Mirrors the host :func:`repro_torch.amg.hierarchy.solve` loop
        (residual check before update) so histories are comparable.
        """
        lv0 = self.levels[0]
        bg = torch.as_tensor(
            pack_vector(lv0.A.part.col_offsets, lv0.pad,
                        b.astype(self.dtype)),
            device=self.device,
        )
        x = torch.zeros_like(bg)
        nb = max(float(np.linalg.norm(b)), 1e-300)
        hist: List[float] = []
        with _OBS.span("amg/solve", n=lv0.n, tol=tol,
                       max_iters=max_iters) as sp:
            for it in range(max_iters):
                # the float() is the device sync: the iteration span
                # covers the whole V-cycle, not just its launches
                with _OBS.span("amg/vcycle_iter", iter=it):
                    x_new, rn = self._step(x, bg)
                    rel = float(rn) / nb
                hist.append(rel)
                if rel < tol:
                    break
                x = x_new
            sp.set(iters=len(hist), final_rel=hist[-1] if hist else 0.0)
        return unpack_vector(lv0.A.part.offsets, x.cpu().numpy()), hist

    # ------------------------------------------------------- introspection
    def _ops(self):
        for lv in self.levels:
            for name, op in (("A", lv.A), ("R", lv.R), ("P", lv.P)):
                if op is not None:
                    yield lv, name, op

    def selection_table(self) -> List[Tuple[int, str, str, Optional[str]]]:
        """[(level, op, chosen strategy, selector report)] for every
        collective of the hierarchy."""
        return [
            (lv.index, name, op.strategy,
             str(op.selection) if op.selection else None)
            for lv, name, op in self._ops()
        ]

    def kernel_table(
        self,
    ) -> List[Tuple[int, str, str, str, Optional[str]]]:
        """[(level, op, kernel variant, overlap mode, selection report)]:
        the flat-vs-blocked SpMV choice and the exchange/compute-overlap
        choice per operator."""
        rows = []
        for lv, name, op in self._ops():
            reps = [str(s) for s in (op.kernel, op.overlap) if s]
            rep = "; ".join(reps) if reps else None
            rows.append(
                (lv.index, name, op.kernel_variant, op.overlap_mode, rep)
            )
        return rows

    def describe(self) -> str:
        lines = [
            f"Distributed AMG: {len(self.levels)} levels on "
            f"{self.topo.n_procs} ranks ({self.topo.n_regions} regions) "
            f"stacked on {self.device}, plan cache: {self.cache.stats()}"
        ]
        for lv in self.levels:
            t = lv.A.coll.plan.stats.totals()
            lines.append(
                f"  L{lv.index}: n={lv.n:>8,d} pad={lv.pad:>6d} "
                f"A={lv.A.strategy:8s} kern={lv.A.kernel_variant:7s} "
                f"ov={lv.A.overlap_mode:4s} "
                f"inter_msgs={t['inter_msgs']:5d} "
                f"inter_bytes={t['inter_bytes']:8d}"
                + (f" R={lv.R.strategy} P={lv.P.strategy}" if lv.R else "")
            )
        return "\n".join(lines)
