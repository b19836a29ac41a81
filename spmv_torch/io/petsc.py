"""PETSc binary matrix and vector I/O (host numpy).

Counterpart of ``spmv_tpu.io.petsc``, its numpy tier carried across: the
big-endian PETSc binary format, matrix class id 1211216 and vector class id
1211214, parsed as vectorized numpy big-endian views, and writers for
both, so a file round-trips. ``row_range`` reads only those rows, seeking
past the others' entries through the per-row nnz prefix sum, as each rank
of a distributed reader reads its own slice. The reference's native C++
reader is still to carry across (ROADMAP.md); the numpy path is its
reference implementation.
"""
from __future__ import annotations

import numpy as np

from spmv_torch.formats.csr import CSRHost

MAT_CLASSID = 1211216
VEC_CLASSID = 1211214

_I = np.dtype(">i4")
_D = np.dtype(">f8")


def read_petsc_binary_matrix_host(
    path: str, row_range: tuple[int, int] | None = None
) -> CSRHost:
    """Read a PETSc binary matrix into host CSR (float64). With
    ``row_range=(r0, r1)``, read only those rows (global column indices
    kept), seeking directly to their index and value spans."""
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=_I, count=4)
        if len(header) != 4 or header[0] != MAT_CLASSID:
            raise ValueError(f"{path}: not a PETSc binary matrix (magic {header[:1]})")
        nrows, ncols, nnz = (int(v) for v in header[1:])
        row_nnz = np.fromfile(f, dtype=_I, count=nrows).astype(np.int64)
        if len(row_nnz) != nrows:
            raise ValueError(f"{path}: truncated nnz-per-row table")
        data_start = f.tell()
        if row_range is None:
            r0, r1 = 0, nrows
        else:
            r0, r1 = row_range
            if not (0 <= r0 <= r1 <= nrows):
                raise ValueError(f"bad row_range {row_range} for {nrows} rows")
        prefix = np.concatenate([[0], np.cumsum(row_nnz)])
        lo, hi = int(prefix[r0]), int(prefix[r1])
        f.seek(data_start + lo * _I.itemsize)
        colind = np.fromfile(f, dtype=_I, count=hi - lo)
        f.seek(data_start + nnz * _I.itemsize + lo * _D.itemsize)
        values = np.fromfile(f, dtype=_D, count=hi - lo)
        if len(colind) != hi - lo or len(values) != hi - lo:
            raise ValueError(f"{path}: truncated matrix payload")
    rowptr = prefix[r0 : r1 + 1] - lo
    return CSRHost(
        rowptr=rowptr,
        colind=colind.astype(np.int32),
        values=values.astype(np.float64),
        ncols=ncols,
    )


def read_petsc_binary_vector_host(
    path: str, index_range: tuple[int, int] | None = None
) -> np.ndarray:
    """Read a PETSc binary vector (float64); optionally only [i0, i1)."""
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=_I, count=2)
        if len(header) != 2 or header[0] != VEC_CLASSID:
            raise ValueError(f"{path}: not a PETSc binary vector (magic {header[:1]})")
        n = int(header[1])
        i0, i1 = index_range if index_range is not None else (0, n)
        if not (0 <= i0 <= i1 <= n):
            raise ValueError(f"bad index_range {index_range} for size {n}")
        f.seek(i0 * _D.itemsize, 1)
        data = np.fromfile(f, dtype=_D, count=i1 - i0)
        if len(data) != i1 - i0:
            raise ValueError(f"{path}: truncated vector payload")
    return data.astype(np.float64)


def write_petsc_binary_matrix(path: str, a: CSRHost) -> None:
    """Write host CSR as a PETSc binary matrix (big-endian, float64)."""
    with open(path, "wb") as f:
        np.array([MAT_CLASSID, a.nrows, a.ncols, a.nnz], dtype=_I).tofile(f)
        a.row_nnz().astype(_I).tofile(f)
        a.colind.astype(_I).tofile(f)
        a.values.astype(_D).tofile(f)


def write_petsc_binary_vector(path: str, x: np.ndarray) -> None:
    """Write a vector as a PETSc binary vector (big-endian, float64)."""
    with open(path, "wb") as f:
        x = np.asarray(x).ravel()
        np.array([VEC_CLASSID, len(x)], dtype=_I).tofile(f)
        x.astype(_D).tofile(f)
