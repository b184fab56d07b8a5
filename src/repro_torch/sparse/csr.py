"""Minimal CSR sparse-matrix substrate (numpy; scipy-free).

Supports everything the AMG pipeline needs: SpMV, SpGEMM (CSR x CSR),
transpose, diagonal extraction, row scaling, and pruning.  Row-major CSR with
int64 indptr / int32 indices / float64 data.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class CSR:
    shape: Tuple[int, int]
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray

    # ------------------------------------------------------------ basics
    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def row(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        lo, hi = int(self.indptr[i]), int(self.indptr[i + 1])
        return self.indices[lo:hi], self.data[lo:hi]

    @staticmethod
    def from_coo(
        rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, shape
    ) -> "CSR":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int32)
        vals = np.asarray(vals, dtype=np.float64)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        # merge duplicates
        if len(rows):
            key_new = np.ones(len(rows), dtype=bool)
            key_new[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
            groups = np.cumsum(key_new) - 1
            merged_vals = np.zeros(groups[-1] + 1 if len(groups) else 0)
            np.add.at(merged_vals, groups, vals)
            rows, cols, vals = rows[key_new], cols[key_new], merged_vals
        indptr = np.zeros(shape[0] + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        return CSR(tuple(shape), indptr, cols.astype(np.int32), vals)

    @staticmethod
    def eye(n: int) -> "CSR":
        return CSR(
            (n, n),
            np.arange(n + 1, dtype=np.int64),
            np.arange(n, dtype=np.int32),
            np.ones(n),
        )

    def row_indices(self) -> np.ndarray:
        """COO row array: row index of every stored entry."""
        return np.repeat(
            np.arange(self.nrows, dtype=np.int64), np.diff(self.indptr)
        )

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape)
        np.add.at(out, (self.row_indices(), self.indices), self.data)
        return out

    # ------------------------------------------------------------ ops
    def matvec(self, x: np.ndarray) -> np.ndarray:
        # segment-sum SpMV
        prod = self.data * x[self.indices]
        out = np.add.reduceat(
            np.concatenate([prod, [0.0]]),
            np.minimum(self.indptr[:-1], len(prod)),
        )[: self.nrows]
        # rows with zero nnz: reduceat duplicates next segment; fix by masking
        empty = self.indptr[:-1] == self.indptr[1:]
        out[empty] = 0.0
        return out

    def diagonal(self) -> np.ndarray:
        d = np.zeros(self.nrows)
        rows = self.row_indices()
        mask = self.indices == rows
        d[rows[mask]] = self.data[mask]
        return d

    def transpose(self) -> "CSR":
        return CSR.from_coo(
            self.indices.astype(np.int64),
            self.row_indices().astype(np.int32),
            self.data,
            (self.ncols, self.nrows),
        )

    def scale_rows(self, s: np.ndarray) -> "CSR":
        return CSR(self.shape, self.indptr.copy(), self.indices.copy(),
                   self.data * s[self.row_indices()])

    def prune(self, tol: float = 0.0) -> "CSR":
        keep = np.abs(self.data) > tol
        rows = self.row_indices()[keep]
        return CSR.from_coo(rows, self.indices[keep], self.data[keep], self.shape)

    def take_rows(self, rows: np.ndarray) -> "CSR":
        """Row-subset CSR: the given rows, in the given order (entries keep
        their in-row order, so downstream merge sums are reproducible)."""
        rows = np.asarray(rows, dtype=np.int64)
        lens = np.diff(self.indptr)[rows]
        total = int(lens.sum())
        indptr = np.concatenate(
            [[0], np.cumsum(lens)]
        ).astype(np.int64)
        if total == 0:
            return CSR((len(rows), self.ncols), indptr,
                       np.zeros(0, dtype=np.int32), np.zeros(0))
        starts = self.indptr[rows]
        seg_off = np.concatenate([[0], np.cumsum(lens)[:-1]])
        flat = (
            np.repeat(starts, lens)
            + np.arange(total, dtype=np.int64)
            - np.repeat(seg_off, lens)
        )
        return CSR((len(rows), self.ncols), indptr,
                   self.indices[flat], self.data[flat])

    def matmat(self, other: "CSR") -> "CSR":
        """CSR x CSR, fully vectorized: expand every (i,j,v) of A against row
        j of B, then merge duplicates via from_coo's lexsort."""
        assert self.ncols == other.nrows, (self.shape, other.shape)
        A, B = self, other
        ai = A.row_indices()
        aj = A.indices.astype(np.int64)
        av = A.data
        b_len = np.diff(B.indptr)
        counts = b_len[aj]
        total = int(counts.sum())
        if total == 0:
            return CSR(
                (A.nrows, B.ncols),
                np.zeros(A.nrows + 1, dtype=np.int64),
                np.zeros(0, dtype=np.int32),
                np.zeros(0),
            )
        starts = B.indptr[aj]
        seg_off = np.concatenate([[0], np.cumsum(counts)[:-1]])
        flat = (
            np.repeat(starts, counts)
            + np.arange(total, dtype=np.int64)
            - np.repeat(seg_off, counts)
        )
        rows = np.repeat(ai, counts)
        cols = B.indices[flat].astype(np.int64)
        vals = np.repeat(av, counts) * B.data[flat]
        return CSR.from_coo(rows, cols, vals, (A.nrows, B.ncols))
