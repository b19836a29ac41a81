"""Host-side CSR container (numpy), the universal import format and the
host oracle.

Carried across from ``spmv_tpu.formats.csr`` (which cannot be imported here:
its package imports jax). Only the numpy tiers of ``from_coo`` and
``csr_matmul`` come along; the native C++ host tier is still to port
(ROADMAP.md). ``coo_ell`` and
``ell_transpose`` build the stacked ELL rectangles through which the
port applies its far remainders and transpose terms as gathers.
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


def csr_matmul(a: CSRHost, b: CSRHost) -> CSRHost:
    """C = A @ B on host CSR, float64 values out: the reference's numpy ESC
    tier (expand every A nonzero against its matching B row, lexsort,
    compress). Setup-time products (the AMG Galerkin triple products) on
    stencil-width rows."""
    if a.ncols != b.nrows:
        raise ValueError(f"shape mismatch: ({a.nrows},{a.ncols}) @ "
                         f"({b.nrows},{b.ncols})")
    lens_a = a.row_nnz().astype(np.int64)
    rows_a = np.repeat(np.arange(a.nrows, dtype=np.int64), lens_a)
    cols_a = a.colind.astype(np.int64)
    rep = (b.rowptr[cols_a + 1] - b.rowptr[cols_a]).astype(np.int64)
    total = int(rep.sum())
    out_rows = np.repeat(rows_a, rep)
    grp_off = np.zeros(len(rep), np.int64)
    np.cumsum(rep[:-1], out=grp_off[1:])
    inner = (np.arange(total, dtype=np.int64) - np.repeat(grp_off, rep)
             + np.repeat(b.rowptr[cols_a], rep))
    out_vals = np.repeat(a.values.astype(np.float64), rep) * b.values[inner]
    return CSRHost.from_coo(out_rows, b.colind[inner].astype(np.int64),
                            out_vals, a.nrows, b.ncols)


def coo_ell(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
            nrows: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-shard COO entries (D, F) as a (D, nrows, K) ELL rectangle: each
    row keeps its entries in their COO order, zero values (the padding of
    a stacked COO or ELL) are dropped, and K is the longest row (at least
    1). Returns (colind int64, values)."""
    nd = rows.shape[0]
    keep = vals != 0
    shard = np.broadcast_to(np.arange(nd, dtype=np.int64)[:, None], rows.shape)[keep]
    key = shard * nrows + rows[keep].astype(np.int64)
    order = np.argsort(key, kind="stable")
    key = key[order]
    rank = np.arange(len(key)) - np.searchsorted(key, key, side="left")
    k = int(rank.max()) + 1 if len(rank) else 1
    colind = np.zeros((nd, nrows, k), dtype=np.int64)
    values = np.zeros((nd, nrows, k), dtype=vals.dtype)
    colind[key // nrows, key % nrows, rank] = cols[keep][order]
    values[key // nrows, key % nrows, rank] = vals[keep][order]
    return colind, values


def ell_transpose(colind: np.ndarray, values: np.ndarray, ncols: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """The transpose of each shard's (D, R, K) ELL block as a
    (D, ncols, K') ELL rectangle, each row's entries in ascending source
    row."""
    nd, r, k = colind.shape
    src = np.broadcast_to(np.arange(r, dtype=np.int64)[None, :, None], colind.shape)
    return coo_ell(colind.reshape(nd, -1), src.reshape(nd, -1),
                   values.reshape(nd, -1), ncols)
