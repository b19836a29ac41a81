"""Matrix Market (.mtx) I/O.

Counterpart of ``spmv_tpu.io.matrix_market``, carried across unchanged
(host numpy). Coordinate format, real/integer/pattern fields,
general/symmetric/skew-symmetric storage, optionally gzipped.
"""
from __future__ import annotations

import gzip

import numpy as np

from spmv_torch.formats.csr import CSRHost


def _open(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode + "t" if "b" not in mode else mode)
    return open(path, mode)


def read_matrix_market(path: str, dtype=np.float64) -> CSRHost:
    """Read a coordinate-format .mtx (optionally .gz) into host CSR.

    Symmetric/skew-symmetric storage is expanded to full (mirrored entries
    added; skew mirrors negated; symmetric diagonals not duplicated).
    ``pattern`` fields get value 1.0.
    """
    with _open(path, "r") as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError(f"{path}: not a MatrixMarket file")
        parts = header.split()
        if len(parts) < 5 or parts[1] != "matrix" or parts[2] != "coordinate":
            raise ValueError(f"{path}: only coordinate matrices supported")
        field, symmetry = parts[3], parts[4]
        if field not in ("real", "integer", "pattern"):
            raise ValueError(f"{path}: unsupported field {field!r}")
        if symmetry not in ("general", "symmetric", "skew-symmetric"):
            raise ValueError(f"{path}: unsupported symmetry {symmetry!r}")
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        nrows, ncols, nnz = (int(v) for v in line.split())
        data = np.loadtxt(f, ndmin=2) if nnz else np.zeros((0, 3))
    if nnz and data.shape[0] != nnz:
        raise ValueError(f"{path}: expected {nnz} entries, got {data.shape[0]}")
    rows = data[:, 0].astype(np.int64) - 1  # 1-based on disk
    cols = data[:, 1].astype(np.int64) - 1
    if field == "pattern":
        vals = np.ones(len(rows), dtype=dtype)
    else:
        vals = data[:, 2].astype(dtype)
    if symmetry in ("symmetric", "skew-symmetric"):
        off = rows != cols
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        rows = np.concatenate([rows, cols[off]])
        cols = np.concatenate([cols, data[:, 0].astype(np.int64)[off] - 1])
        vals = np.concatenate([vals, sign * vals[off]])
    return CSRHost.from_coo(rows, cols, vals, nrows, ncols,
                            sum_duplicates=True)


def write_matrix_market(path: str, a: CSRHost, comment: str = "") -> None:
    """Write host CSR as a general real coordinate .mtx."""
    lens = a.row_nnz()
    rows = np.repeat(np.arange(a.nrows), lens)
    with _open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"% {line}\n")
        f.write(f"{a.nrows} {a.ncols} {a.nnz}\n")
        # vectorized writer: a per-nnz Python loop takes minutes at the
        # 10M-100M nnz scale the assembly path targets
        if a.nnz:
            np.savetxt(
                f,
                np.column_stack([rows + 1, a.colind.astype(np.int64) + 1,
                                 a.values]),
                fmt="%d %d %.17g",
            )
