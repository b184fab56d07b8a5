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
:meth:`DistributedHierarchy.setup_partitioned` builds the hierarchy itself
from per-rank row blocks (``amg.distributed_setup``: PMIS, interpolation
and the Galerkin SpGEMM over discovered exchanges) and lowers the blocks
straight to the same solve.

Solve: a V-cycle (Chebyshev smoother, degrees matching the host solver
exactly) over ``[P, pad]`` block vectors, run eagerly; matvecs compose the
plan executor with the ELL SpMV kernels (``sparse.device``).  With the same
rho estimates the residual history tracks the host
:func:`~repro_torch.amg.hierarchy.solve` to rounding error.  With
``coarse_gather`` on, the coarsest level gathers its rhs with a plan-based
dense allgatherv (``core.dense``) and smooths replicated on a dense
operator.

Measurement: :meth:`DistributedHierarchy.measure_exchange_seconds` times
each level's bare exchange (the pure-exchange feed of the rate fit,
``profile.calibrate.fit_trace``) and
:meth:`DistributedHierarchy.measure_spmv_seconds` each level's whole SpMV,
kernels included.

Entry points: ``DistributedHierarchy.setup(...)``,
``.setup_partitioned(...)``, ``.solve(b, x0=...)``, ``.describe()``,
``.selection_table()``, ``.kernel_table()``,
``.measure_exchange_seconds(...)``, ``.measure_spmv_seconds(...)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.cache import PlanCache, default_plan_cache
from ..core.collectives import device_sync, time_executor
from ..core.costmodel import LASSEN, MachineParams, plan_time
from ..core.dense import DenseSelection, bind_dense
from ..core.neighborhood import NeighborAlltoallV
from ..core.plan import Topology
from ..core.selection import SelectionReport
from ..obs import default_obs, now
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
    partitioned_from_blocks,
    partitioned_to_global,
)
from .distributed_setup import (
    DistributedSetup,
    _block_inv_diag,
    distributed_build_hierarchy,
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


def _op_maker(cache: PlanCache, topo: Topology, strategy: str,
                params: MachineParams, value_bytes: int, dtype,
                spmv_variant: str, spmv_vmem_limit: Optional[int],
                spmv_block_cols: int, spmv_overlap: str,
                spmv_overlap_figures: Optional[Dict[str, float]]
                ) -> Callable[[PartitionedCSR], DistOp]:
    """``make_op(part)``: a partitioned operator with its cached collective
    and its kernel and overlap selections."""
    figures = dict(spmv_overlap_figures or {})

    def make_op(part: PartitionedCSR) -> DistOp:
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

    return make_op


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
        coarse_gather: str = "off",
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
        # coarsest-level dense allgatherv policy: "off" keeps the
        # distributed Chebyshev; "auto" / "hier" / "ring" gather the
        # coarse rhs with a plan-based dense collective and smooth
        # replicated (the selection lands in coarse_selection)
        self.coarse_gather = coarse_gather
        self.coarse_selection: Optional[DenseSelection] = None
        # the distributed-setup record (per-level blocks + exchange
        # accounting) of setup_partitioned; None for a host hierarchy
        self.setup_info: Optional[DistributedSetup] = None
        self._Amv = [self._bind(lv.A) for lv in levels]
        self._Rmv = [self._bind(lv.R) if lv.R is not None else None
                     for lv in levels]
        self._Pmv = [self._bind(lv.P) if lv.P is not None else None
                     for lv in levels]
        self._coarse_fn = (self._bind_coarse() if coarse_gather != "off"
                           else None)

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
        coarse_gather: str = "off",
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
        :class:`DistOp`.  ``coarse_gather`` is ``"off"``, ``"auto"``,
        ``"hier"`` or ``"ring"`` (see :meth:`_bind_coarse`).
        """
        device = resolve_device(device)
        topo = Topology(
            n_procs, procs_per_region or _default_procs_per_region(n_procs)
        )
        cache = cache if cache is not None else default_plan_cache()
        build = _op_maker(cache, topo, strategy, params, value_bytes, dtype,
                            spmv_variant, spmv_vmem_limit, spmv_block_cols,
                            spmv_overlap, spmv_overlap_figures)

        def make_op(mat, row_off, col_off) -> DistOp:
            return build(partition_rect_csr(mat, row_off, col_off))

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
                       value_bytes, coarse_gather=coarse_gather)

    @classmethod
    def setup_partitioned(
        cls,
        A_blocks,
        row_offsets: np.ndarray,
        procs_per_region: Optional[int] = None,
        strategy: str = "auto",
        params: MachineParams = LASSEN,
        value_bytes: int = 8,
        cache: Optional[PlanCache] = None,
        dtype=np.float64,
        max_levels: int = 25,
        min_coarse: int = 64,
        strength_theta: float = 0.25,
        seed: int = 0,
        spmv_variant: str = "flat",
        spmv_vmem_limit: Optional[int] = None,
        spmv_block_cols: int = DEFAULT_BLOCK_COLS,
        spmv_overlap: str = "off",
        spmv_overlap_figures: Optional[Dict[str, float]] = None,
        coarse_gather: str = "off",
        device=None,
    ) -> "DistributedHierarchy":
        """End-to-end distributed build: partitioned fine matrix -> solve.

        ``A_blocks[p]`` are rank ``p``'s rows of the fine operator (global
        columns), ``row_offsets`` their block boundaries.  Runs the
        distributed *setup* (``amg.distributed_setup``: PMIS /
        interpolation / Galerkin SpGEMM over sparse dynamic data
        exchanges) and lowers the resulting per-rank blocks straight to
        the solve on ``device``: the global operators are never assembled.
        Setup and solve share one :class:`PlanCache`; for structurally
        symmetric operators the setup halo pattern IS the solve halo
        pattern, so the solve collectives come out of the cache pre-built.
        The other arguments are :meth:`setup`'s; the setup record lands in
        :attr:`setup_info`.
        """
        device = resolve_device(device)
        n_procs = len(A_blocks)
        topo = Topology(
            n_procs, procs_per_region or _default_procs_per_region(n_procs)
        )
        cache = cache if cache is not None else default_plan_cache()
        setup = distributed_build_hierarchy(
            A_blocks, row_offsets, topo, cache=cache,
            max_levels=max_levels, min_coarse=min_coarse,
            strength_theta=strength_theta, seed=seed,
            strategy=strategy, value_bytes=value_bytes, params=params,
        )
        build = _op_maker(cache, topo, strategy, params, value_bytes, dtype,
                            spmv_variant, spmv_vmem_limit, spmv_block_cols,
                            spmv_overlap, spmv_overlap_figures)

        def make_op(blocks, row_off, col_off) -> DistOp:
            return build(partitioned_from_blocks(blocks, row_off, col_off))

        levels: List[DistributedLevel] = []
        with _OBS.span("amg/setup_partitioned", n_procs=n_procs,
                       strategy=strategy, levels=len(setup.levels)):
            for k, sl in enumerate(setup.levels):
                with _OBS.span("amg/build_level", level=k,
                               n=sl.nrows) as lsp:
                    A_op = make_op(sl.A_blocks, sl.row_offsets,
                                   sl.row_offsets)
                    pad = int(np.diff(sl.row_offsets).max())
                    dinv = np.zeros((n_procs, pad), dtype=dtype)
                    for p, Ab in enumerate(sl.A_blocks):
                        dinv[p, : Ab.nrows] = _block_inv_diag(
                            Ab, int(sl.row_offsets[p])
                        ).astype(dtype)
                    dl = DistributedLevel(
                        index=k, n=sl.nrows, pad=pad, A=A_op,
                        dinv=torch.as_tensor(dinv, device=device),
                        rho=sl.rho or 1.0,
                    )
                    if sl.P_blocks is not None and k + 1 < len(setup.levels):
                        dl.R = make_op(sl.R_blocks, sl.coarse_offsets,
                                       sl.row_offsets)
                        dl.P = make_op(sl.P_blocks, sl.row_offsets,
                                       sl.coarse_offsets)
                    levels.append(dl)
                    lsp.set(strategy=A_op.strategy,
                            kernel=A_op.kernel_variant,
                            overlap=A_op.overlap_mode)
            dh = cls(levels, device, topo, cache, dtype, strategy, params,
                     value_bytes, coarse_gather=coarse_gather)
        dh.setup_info = setup
        return dh

    # ------------------------------------------------- device programs
    def _bind(self, op: DistOp) -> Callable:
        exchange = self._bind_exchange_only(op) if op.ell.ghost_pad else None
        return make_distributed_spmv(
            op.ell, exchange, overlap=(op.overlap_mode == "on"),
            device=self.device,
        )

    def _bind_coarse(self) -> Callable:
        """Coarsest-level solve by dense allgatherv + replicated Chebyshev.

        The coarsest packed rhs ``[P, pad]`` is exactly the allgatherv
        input layout (``counts`` = real block sizes, ``cmax`` = pad): each
        rank contributes its block, the plan-based gather replicates the
        full coarse vector on every rank, and a dense padded coarse
        operator (zeros at padding rows/cols, so no unpadding is needed)
        runs the same degree-24 Chebyshev arithmetic as :meth:`_cheby`
        on every rank's copy; each rank then keeps its own block.  The
        :class:`~repro_torch.core.dense.DenseSelection` lands in
        :attr:`coarse_selection`.
        """
        lv = self.levels[-1]
        counts = np.diff(np.asarray(lv.A.part.col_offsets, dtype=np.int64))
        plan, sel = self.cache.dense_collective(
            "allgatherv", counts, self.topo, variant=self.coarse_gather,
            value_bytes=self.value_bytes, params=self.params,
        )
        self.coarse_selection = sel
        gather = bind_dense(plan, self.device)

        P_, pad = self.topo.n_procs, lv.pad
        Ag = partitioned_to_global(lv.A.part)
        # global index -> padded position p*pad + local slot
        pos = np.concatenate([
            p * pad + np.arange(int(counts[p]), dtype=np.int64)
            for p in range(P_)
        ])
        Ad = np.zeros((P_ * pad, P_ * pad), dtype=self.dtype)
        rows = Ag.row_indices().astype(np.int64)
        cols = Ag.indices.astype(np.int64)
        np.add.at(Ad, (pos[rows], pos[cols]), Ag.data.astype(self.dtype))
        # the rows of every rank's copy times Ad: x @ Ad^T
        AdT = torch.as_tensor(Ad.T.copy(), device=self.device)
        dinv = lv.dinv.reshape(-1)
        ranks = torch.arange(P_, device=self.device)

        rho = lv.rho
        upper = 1.1 * rho
        lower = 0.30 * rho
        theta = 0.5 * (upper + lower)
        delta = 0.5 * (upper - lower)
        sigma = theta / delta

        def coarse_cheby(b, degree=24):
            x = torch.zeros_like(b)
            rho_k = 1.0 / sigma
            r = dinv * (b - x @ AdT)
            p = r / theta
            x = x + p
            for _ in range(degree - 1):
                rho_next = 1.0 / (2.0 * sigma - rho_k)
                r = dinv * (b - x @ AdT)
                p = rho_next * rho_k * p + 2.0 * rho_next / delta * r
                x = x + p
                rho_k = rho_next
            return x

        def coarse_fn(b):                  # [P, pad], rank p's block in row p
            full = gather(b).reshape(P_, P_ * pad)   # every rank's copy
            x = coarse_cheby(full).reshape(P_, P_, pad)
            return x[ranks, ranks]

        return coarse_fn

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
            if self._coarse_fn is not None:
                return self._coarse_fn(b)
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
        x0: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, List[float]]:
        """AMG-preconditioned stationary iteration on the device.

        Mirrors the host :func:`repro_torch.amg.hierarchy.solve` loop
        (residual check before update) so histories are comparable.
        ``x0`` (a global host vector) warm-starts the iteration: a solve
        resumed from the iterate of an earlier one continues its
        history.
        """
        lv0 = self.levels[0]

        def packed(v: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(
                pack_vector(lv0.A.part.col_offsets, lv0.pad,
                            np.asarray(v).astype(self.dtype)),
                device=self.device,
            )

        bg = packed(b)
        x = torch.zeros_like(bg) if x0 is None else packed(x0)
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
        if self.coarse_selection is not None:
            lines.append(f"  coarse_gather={self.coarse_gather}: "
                         f"{self.coarse_selection}")
        return "\n".join(lines)

    # -------------------------------------------------------- measurement
    def measure_exchange_seconds(
        self, iters: int = 20, warmup: int = 3, tracer=None
    ) -> List[Tuple[int, str, float]]:
        """Measured (not modeled) per-level exchange wall time on the
        device: [(level, strategy, seconds_per_exchange)].

        Times the bound executor of each level's operator halo with the
        shared protocol (``core.collectives.time_executor``).  Levels
        without ghost columns have no exchange and report 0.0.  With
        ``tracer`` (a ``repro_torch.profile.TraceRecorder``) each level's
        timing is recorded against its plan as a pure exchange; without
        one, a tracer attached to the enabled obs layer receives the same
        samples through the span bridge (``pure_exchange`` span
        attributes).
        """
        out = []
        for lv in self.levels:
            if not lv.A.ell.ghost_pad:
                out.append((lv.index, lv.A.strategy, 0.0))
                continue
            with _OBS.span("amg/measure_exchange", level=lv.index,
                           strategy=lv.A.strategy) as sp:
                secs = time_executor(
                    self._bind_exchange_only(lv.A),
                    self.topo.n_procs,
                    lv.A.ell.in_pad,
                    dtype=self.dtype,
                    iters=iters,
                    warmup=warmup,
                    device=self.device,
                )
                if tracer is not None:
                    tracer.record_plan(lv.A.coll.plan, secs,
                                       label=f"amg/L{lv.index}",
                                       pure_exchange=True)
                else:
                    # no explicit tracer: let the obs bridge record it
                    # (so a tracer passed here is never recorded twice)
                    sp.set(plan=lv.A.coll.plan, pure_exchange=True,
                           seconds=secs)
            out.append((lv.index, lv.A.strategy, secs))
        return out

    def measure_spmv_seconds(
        self, iters: int = 10, warmup: int = 2, tracer=None
    ) -> List[Tuple[int, str, str, float]]:
        """Measured per-level wall time of the whole bound SpMV (exchange
        and kernels, under each level's own variant and overlap):
        [(level, kernel variant, overlap mode, seconds)].

        ``warmup + 1`` calls each wait for the device; the ``iters`` timed
        calls are issued back to back and waited for once.  With
        ``tracer``, levels with an exchange are recorded against their
        plan with ``pure_exchange=False``: these timings include the
        kernels, so ``merged_rate_samples(pure_only=True)`` keeps them out
        of the rate fit.
        """
        rng = np.random.default_rng(0)
        out = []
        for k, lv in enumerate(self.levels):
            fn = self._Amv[k]
            x = torch.as_tensor(
                rng.normal(size=(self.topo.n_procs, lv.A.ell.in_pad))
                .astype(self.dtype),
                device=self.device,
            )
            for _ in range(warmup + 1):
                fn(x)
                device_sync(self.device)
            t0 = now()
            for _ in range(iters):
                fn(x)
            device_sync(self.device)
            secs = (now() - t0) / iters
            if tracer is not None and lv.A.ell.ghost_pad:
                tracer.record_plan(
                    lv.A.coll.plan, secs,
                    label=f"amg/L{lv.index}/spmv", pure_exchange=False,
                )
            out.append(
                (lv.index, lv.A.kernel_variant, lv.A.overlap_mode, secs)
            )
        return out

    def _bind_exchange_only(self, op: DistOp) -> Callable:
        return self.cache.executor(
            op.part.pattern, self.topo, self.device,
            strategy=self.strategy, value_bytes=self.value_bytes,
            params=self.params,
        )
