"""Host-side CSR container (numpy), the universal import format and the
host oracle.

Carried across from ``spmv_tpu.formats.csr`` (which cannot be imported here:
its package imports jax). Only the numpy tier of ``from_coo`` comes along;
the native C++ host tier is still to port (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRHost:
    """A host (numpy) CSR matrix with int32 indices.

    rowptr: (nrows+1,) int32/int64
    colind: (nnz,) int32
    values: (nnz,) float dtype
    ncols:  number of columns (may exceed max colind + 1)
    """

    rowptr: np.ndarray
    colind: np.ndarray
    values: np.ndarray
    ncols: int

    def __post_init__(self) -> None:
        self.rowptr = np.asarray(self.rowptr)
        self.colind = np.asarray(self.colind, dtype=np.int32)
        self.values = np.asarray(self.values)
        if self.rowptr.ndim != 1 or self.colind.ndim != 1 or self.values.ndim != 1:
            raise ValueError("rowptr/colind/values must be 1-D")
        if self.colind.shape != self.values.shape:
            raise ValueError("colind and values must have equal length")
        if self.rowptr[0] != 0 or self.rowptr[-1] != len(self.values):
            raise ValueError("rowptr must start at 0 and end at nnz")
        if np.any(np.diff(self.rowptr) < 0):
            raise ValueError("rowptr must be non-decreasing")
        if len(self.colind) and (self.colind.min() < 0 or self.colind.max() >= self.ncols):
            raise ValueError("column index out of range")

    @property
    def nrows(self) -> int:
        return len(self.rowptr) - 1

    @property
    def nnz(self) -> int:
        return len(self.values)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nrows, self.ncols)

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.rowptr).astype(np.int32)

    @classmethod
    def from_coo(
        cls,
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        nrows: int,
        ncols: int,
        sum_duplicates: bool = True,
    ) -> "CSRHost":
        """Build CSR from triplets (rows sorted stably; duplicates summed
        unless ``sum_duplicates=False``)."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_duplicates and len(rows):
            key_new = np.empty(len(rows), dtype=bool)
            key_new[0] = True
            key_new[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
            group = np.cumsum(key_new) - 1
            rows = rows[key_new]
            cols = cols[key_new]
            if np.iscomplexobj(vals):
                vals = (np.bincount(group, weights=vals.real)
                        + 1j * np.bincount(group, weights=vals.imag)
                        ).astype(vals.dtype)
            else:
                vals = np.bincount(group, weights=vals).astype(vals.dtype)
        rowptr = np.zeros(nrows + 1, dtype=np.int64)
        np.add.at(rowptr, rows + 1, 1)
        rowptr = np.cumsum(rowptr)
        out = cls(rowptr=rowptr, colind=cols.astype(np.int32), values=vals,
                  ncols=ncols)
        # lexsorted, summed triplets are strictly column-increasing per
        # row — downstream conversions skip their canonicality scan
        out._sorted_unique = bool(sum_duplicates)
        return out

    @classmethod
    def from_dense(cls, dense: np.ndarray) -> "CSRHost":
        dense = np.asarray(dense)
        rows, cols = np.nonzero(dense)
        return cls.from_coo(rows, cols, dense[rows, cols], dense.shape[0], dense.shape[1])

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.values.dtype)
        rows = np.repeat(np.arange(self.nrows), self.row_nnz())
        np.add.at(out, (rows, self.colind), self.values)
        return out

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Sequential oracle SpMV, accumulated in float64 (complex128 for
        complex operands); the result takes the operands' common dtype."""
        rows = np.repeat(np.arange(self.nrows), self.row_nnz())
        acc_t = (np.complex128 if (np.iscomplexobj(self.values)
                                   or np.iscomplexobj(x)) else np.float64)
        prod = self.values.astype(acc_t) * np.asarray(x, dtype=acc_t)[self.colind]
        if acc_t is np.complex128:
            out = (np.bincount(rows, weights=prod.real, minlength=self.nrows)
                   + 1j * np.bincount(rows, weights=prod.imag,
                                      minlength=self.nrows))
        else:
            out = np.bincount(rows, weights=prod, minlength=self.nrows)
        return out.astype(np.result_type(self.values, x))

    def extract_rows(self, start: int, stop: int) -> "CSRHost":
        """Row slice [start, stop) keeping global column indices."""
        lo, hi = self.rowptr[start], self.rowptr[stop]
        rowptr = (self.rowptr[start : stop + 1] - lo).astype(np.int64)
        out = CSRHost(rowptr, self.colind[lo:hi], self.values[lo:hi], self.ncols)
        # a row slice of a canonical (sorted, duplicate-free) matrix stays
        # canonical — propagate so downstream can take the no-sort paths
        out._sorted_unique = getattr(self, "_sorted_unique", False)
        return out

    def transpose(self) -> "CSRHost":
        rows = np.repeat(np.arange(self.nrows), self.row_nnz())
        return CSRHost.from_coo(
            self.colind, rows, self.values, self.ncols, self.nrows,
            sum_duplicates=False)

    def split_lower_diag(self) -> tuple["CSRHost", np.ndarray]:
        """(strict lower triangle, dense diagonal vector): the L and D of
        A = L + D + L^T that symmetric storage keeps."""
        rows = np.repeat(np.arange(self.nrows), self.row_nnz())
        diag = np.zeros(min(self.nrows, self.ncols), dtype=self.values.dtype)
        on_diag = rows == self.colind
        diag[rows[on_diag]] = self.values[on_diag]
        keep = rows > self.colind
        lower = CSRHost.from_coo(
            rows[keep], self.colind[keep], self.values[keep], self.nrows,
            self.ncols, sum_duplicates=False)
        return lower, diag
