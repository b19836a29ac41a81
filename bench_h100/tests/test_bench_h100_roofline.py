"""The roofline's byte count, by hand on small matrices."""
from __future__ import annotations

import numpy as np
import pytest

from bench_h100 import roofline
from bench_h100.matrices import lap2d
from bench_h100.reference.csr import CSR


def test_laplacian_3x3_by_hand():
    a = lap2d.generate({"nx": 3, "ny": 3})
    # 9 rows: 4 corners of 3 entries, 4 edges of 4, the centre 5 -> 33;
    # on or below the diagonal: (33 + 9) / 2 = 21
    assert (a.nnz, a.lower_nnz()) == (33, 21)
    assert roofline.apply_bytes(a, True, "float64") == (21 + 9 + 9) * 8
    assert roofline.apply_bytes(a, False, "float32") == (33 + 9 + 9) * 4
    assert roofline.apply_seconds(a, True, "float64") == pytest.approx(
        312 / 3.35e12)


def test_main_grid_bound_is_the_kernel_tables():
    # 3200^2: 51,187,200 nonzeros, 30,713,600 on or below the diagonal;
    # with x and y, 409.5 MB in float64: 0.1222 ms at 3.35 TB/s
    n, nnz = 3200 * 3200, 5 * 3200 * 3200 - 4 * 3200
    assert 1e3 * ((nnz + n) // 2 + 2 * n) * 8 / roofline.PEAK_BYTES_PER_S == (
        pytest.approx(0.12225, abs=1e-5))


def _csr(dense: np.ndarray) -> CSR:
    rows, cols = np.nonzero(dense)
    rowptr = np.zeros(dense.shape[0] + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=dense.shape[0]), out=rowptr[1:])
    return CSR(rowptr, cols.astype(np.int32), dense[rows, cols],
               dense.shape[1])


def test_unsymmetric_and_random_symmetric_counts_against_dense():
    a = _csr(np.array([[0, 0, 1.0], [1, 1, 0], [0, 1, 1]]))
    assert (a.nnz, a.lower_nnz()) == (5, 4)
    assert roofline.apply_bytes(a, False, "float64") == (5 + 3 + 3) * 8
    rng = np.random.default_rng(3)
    dense = np.where(rng.random((200, 200)) < 0.03, rng.random((200, 200)), 0)
    dense = dense + dense.T + np.eye(200)
    f = _csr(dense)
    assert f.lower_nnz() == np.count_nonzero(np.tril(dense))
    assert roofline.apply_bytes(f, True, "float64") == (
        np.count_nonzero(np.tril(dense)) + 400) * 8
