"""Rotated anisotropic diffusion operator (the paper's test problem).

-div(K grad u) on a regular 2-D grid, K = Q(theta)^T diag(1, eps) Q(theta),
discretized with the classical 7-point finite-difference stencil for
operators with mixed derivatives: center, E, W, N, S and the two corners
along the strong-coupling diagonal (NE/SW for positive cross term).  At
theta=45 deg this is exactly the paper's "7-point rotated anisotropic
diffusion system" (rotation 45 deg, anisotropy 0.001).
"""
from __future__ import annotations

import numpy as np

from ..sparse.csr import CSR


def rotated_anisotropic_stencil(theta: float, eps: float):
    """Return [(dy, dx, coeff), ...] of the 7-point stencil."""
    C, S = np.cos(theta), np.sin(theta)
    a = C * C + eps * S * S        # Kxx
    c = S * S + eps * C * C        # Kyy
    b = (1.0 - eps) * C * S        # Kxy
    # L = -(a u_xx + 2 b u_xy + c u_yy); u_xy via 7-point corner scheme.
    # Positive b couples the NE/SW diagonal; negative b couples NW/SE.
    corner = (1, 1) if b >= 0 else (1, -1)
    bb = abs(b)
    entries = [
        (0, 0, 2 * a + 2 * c - 2 * bb),
        (0, 1, -a + bb),
        (0, -1, -a + bb),
        (1, 0, -c + bb),
        (-1, 0, -c + bb),
        (corner[0], corner[1], -bb),
        (-corner[0], -corner[1], -bb),
    ]
    return entries


def diffusion_2d(
    ny: int, nx: int, theta: float = np.pi / 4, eps: float = 1e-3
) -> CSR:
    """Assemble the 7-point rotated anisotropic diffusion matrix (Dirichlet)."""
    stencil = rotated_anisotropic_stencil(theta, eps)
    n = ny * nx
    ys, xs = np.divmod(np.arange(n, dtype=np.int64), nx)
    rows_list, cols_list, vals_list = [], [], []
    for dy, dx, coeff in stencil:
        if coeff == 0.0:
            continue
        yy = ys + dy
        xx = xs + dx
        ok = (yy >= 0) & (yy < ny) & (xx >= 0) & (xx < nx)
        rows_list.append(np.arange(n, dtype=np.int64)[ok])
        cols_list.append((yy * nx + xx)[ok])
        vals_list.append(np.full(int(ok.sum()), coeff))
    return CSR.from_coo(
        np.concatenate(rows_list),
        np.concatenate(cols_list),
        np.concatenate(vals_list),
        (n, n),
    )


def paper_problem(rows: int = 524_288) -> CSR:
    """The paper's system: 524,288 rows, theta=45deg, eps=0.001.

    We use a 1024 x 512 grid (exactly 524,288 rows)."""
    nx = 1 << int(np.ceil(np.log2(np.sqrt(rows))))
    ny = rows // nx
    assert nx * ny == rows, (nx, ny, rows)
    return diffusion_2d(ny, nx)
