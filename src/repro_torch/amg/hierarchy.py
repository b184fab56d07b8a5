"""AMG hierarchy construction (setup phase) + V-cycle solver (solve phase).

The solve phase is where the paper measures communication: one SpMV-shaped
exchange per level per iteration.  ``Hierarchy.levels[k].A`` supplies the
communication pattern analyzed by the benchmarks.

This module is the HOST reference solver.  The device-resident distributed
solve (every level partitioned, halos through persistent neighborhood
collectives, ranks stacked on one device) lives in
:mod:`repro_torch.amg.distributed` (``DistributedHierarchy.setup`` /
``.solve``) and is validated against this solver's residual history.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..sparse.csr import CSR
from .coarsen import direct_interpolation, pmis, strength_graph


@dataclass
class Level:
    A: CSR
    P: Optional[CSR] = None  # prolongation to this level's fine grid
    R: Optional[CSR] = None  # restriction (P^T)
    rho: float = 0.0         # spectral-radius estimate of D^-1 A (Chebyshev)
    splitting: Optional[np.ndarray] = None  # C/F splitting used to coarsen
    # this level (+1 C-point, 0 F-point); the quantity the distributed
    # setup (amg.distributed_setup) must reproduce exactly


def inv_diag(A: CSR) -> np.ndarray:
    """Guarded inverse diagonal (0 where the diagonal is 0).

    The single definition shared by the host smoothers and the device
    solver (``amg.distributed``), which must stay arithmetically identical
    for the host/device residual-history cross-check to hold.
    """
    d = A.diagonal()
    return np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)


def estimate_rho(A: CSR, iters: int = 12, seed: int = 0) -> float:
    """Power iteration on D^{-1} A (the Chebyshev smoother interval)."""
    dinv = inv_diag(A)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=A.nrows)
    x /= np.linalg.norm(x) + 1e-300
    rho = 1.0
    for _ in range(iters):
        y = dinv * A.matvec(x)
        n = np.linalg.norm(y)
        if n == 0:
            return 1.0
        rho = n
        x = y / n
    return float(rho)


@dataclass
class Hierarchy:
    levels: List[Level]

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def complexity(self) -> float:
        fine = self.levels[0].A.nnz
        return sum(l.A.nnz for l in self.levels) / max(fine, 1)

    def describe(self) -> str:
        rows = [
            f"  level {i:2d}: n={l.A.nrows:>9,d} nnz={l.A.nnz:>10,d} "
            f"nnz/row={l.A.nnz / max(l.A.nrows, 1):5.1f}"
            for i, l in enumerate(self.levels)
        ]
        return "\n".join(
            [f"AMG hierarchy: {self.n_levels} levels, "
             f"operator complexity {self.complexity():.2f}"] + rows
        )


def build_hierarchy(
    A: CSR,
    max_levels: int = 25,
    min_coarse: int = 64,
    strength_theta: float = 0.25,
    seed: int = 0,
) -> Hierarchy:
    levels = [Level(A=A)]
    while (
        levels[-1].A.nrows > min_coarse and len(levels) < max_levels
    ):
        Ak = levels[-1].A
        S = strength_graph(Ak, strength_theta)
        if S.nnz == 0:
            break
        splitting = pmis(S, seed=seed + len(levels))
        P, splitting = direct_interpolation(Ak, S, splitting)
        if P.ncols >= Ak.nrows or P.ncols == 0:
            break
        levels[-1].splitting = splitting
        R = P.transpose()
        AP = Ak.matmat(P)
        Ac = R.matmat(AP).prune(1e-14)
        levels[-1].P = P
        levels[-1].R = R
        levels.append(Level(A=Ac))
    for lvl in levels:
        lvl.rho = estimate_rho(lvl.A)
    return Hierarchy(levels)


def from_reference_hierarchy(levels: Sequence[Tuple]) -> Hierarchy:
    """Build a :class:`Hierarchy` from per-level operators given as arrays.

    ``levels[k]`` is ``(A, P, R, rho)`` where each operator is an
    ``(indptr, indices, data, shape)`` tuple of numpy arrays (``P`` and
    ``R`` are ``None`` on the coarsest level).  This is how the same
    operators, built once by another implementation, are fed to this
    package's solvers.
    """

    def csr(op) -> Optional[CSR]:
        if op is None:
            return None
        indptr, indices, data, shape = op
        return CSR(
            (int(shape[0]), int(shape[1])),
            np.asarray(indptr, dtype=np.int64),
            np.asarray(indices, dtype=np.int32),
            np.asarray(data, dtype=np.float64),
        )

    return Hierarchy([
        Level(A=csr(A), P=csr(P), R=csr(R), rho=float(rho))
        for A, P, R, rho in levels
    ])


# ---------------------------------------------------------------------------
# solve phase
# ---------------------------------------------------------------------------


def jacobi(A: CSR, x: np.ndarray, b: np.ndarray, omega: float = 2.0 / 3.0,
           iters: int = 1) -> np.ndarray:
    dinv = inv_diag(A)
    for _ in range(iters):
        x = x + omega * dinv * (b - A.matvec(x))
    return x


def chebyshev(A: CSR, x: np.ndarray, b: np.ndarray, rho: float,
              degree: int = 3, lower_frac: float = 0.30) -> np.ndarray:
    """Chebyshev polynomial smoother on D^{-1}A over [lower*rho, 1.1*rho]
    (hypre-style), vectorized — a strong smoother without Gauss-Seidel's
    sequential dependence (which would serialize across the distributed
    rows and is why hypre offers l1-Jacobi/Chebyshev at scale)."""
    dinv = inv_diag(A)
    upper = 1.1 * rho
    lower = lower_frac * rho
    theta = 0.5 * (upper + lower)
    delta = 0.5 * (upper - lower)
    sigma = theta / delta
    rho_k = 1.0 / sigma
    r = dinv * (b - A.matvec(x))
    p = r / theta
    x = x + p
    for _ in range(degree - 1):
        rho_next = 1.0 / (2.0 * sigma - rho_k)
        r = dinv * (b - A.matvec(x))
        p = rho_next * rho_k * p + 2.0 * rho_next / delta * r
        x = x + p
        rho_k = rho_next
    return x


def v_cycle(h: Hierarchy, b: np.ndarray, x: Optional[np.ndarray] = None,
            level: int = 0, pre: int = 1, post: int = 1) -> np.ndarray:
    A = h.levels[level].A
    rho = h.levels[level].rho or 1.0

    def smooth(xx, sweeps):
        return chebyshev(A, xx, b, rho, degree=3 * sweeps)

    if x is None:
        x = np.zeros_like(b)
    if level == h.n_levels - 1 or h.levels[level].P is None:
        # coarsest: heavy smoothing is plenty at n<=64
        return chebyshev(A, x, b, rho, degree=24)
    x = smooth(x, pre)
    r = b - A.matvec(x)
    rc = h.levels[level].R.matvec(r)
    ec = v_cycle(h, rc, None, level + 1, pre, post)
    x = x + h.levels[level].P.matvec(ec)
    return smooth(x, post)


def solve(
    h: Hierarchy,
    b: np.ndarray,
    tol: float = 1e-8,
    max_iters: int = 100,
) -> tuple:
    """AMG-preconditioned stationary iteration; returns (x, residual_history)."""
    x = np.zeros_like(b)
    A = h.levels[0].A
    nb = np.linalg.norm(b)
    hist = []
    for _ in range(max_iters):
        r = b - A.matvec(x)
        rn = np.linalg.norm(r) / max(nb, 1e-300)
        hist.append(rn)
        if rn < tol:
            break
        x = x + v_cycle(h, r)
    return x, hist
