"""Problem generators (host side, numpy).

Carried across from ``spmv_tpu.gen``: the 1-D gamma-coupled operator, the
2-D 5-point and 3-D 7-point Dirichlet Laplacians, the random test matrix
and the Gaussian-bump input vector. ``hpcg_27pt`` is HPCG's operator, which
the reference does not have. Only the numpy path comes along; the
native single-pass C++ fill is still to port (ROADMAP.md). At 3200² the
numpy 2-D path allocates a few hundred MB and runs in seconds.
"""
from __future__ import annotations

import numpy as np

from spmv_torch.formats.csr import CSRHost


def create_laplace_1d(n: int, gamma: float = 0.1, dtype=np.float64) -> CSRHost:
    """1-D 3-point operator: A = I + gamma * (2I - shift - shift^T).
    Tridiagonal, SPD, diagonally dominant."""
    i = np.arange(n, dtype=np.int64)
    rows = np.concatenate([i[1:], i, i[:-1]])
    cols = np.concatenate([i[:-1], i, i[1:]])
    vals = np.concatenate(
        [
            np.full(n - 1, -gamma, dtype=dtype),
            np.full(n, 1.0 + 2.0 * gamma, dtype=dtype),
            np.full(n - 1, -gamma, dtype=dtype),
        ]
    )
    return CSRHost.from_coo(rows, cols, vals, n, n)


def create_laplace_2d(nx: int, ny: int | None = None, dtype=np.float64) -> CSRHost:
    """2-D 5-point Laplacian on an nx x ny grid (Dirichlet): diag 4,
    neighbors -1, row-major numbering, offsets {-nx, -1, 0, +1, +nx}.
    Built directly in CSR row order (no triplet sort)."""
    ny = ny if ny is not None else nx
    n = nx * ny
    # int32 index math: n < 2^31 always holds, and the (n, 5) candidate
    # table is the dominant allocation
    idx = np.arange(n, dtype=np.int32)
    ix = idx % np.int32(nx)
    iy = idx // np.int32(nx)
    # candidate columns per row, already in ascending offset order
    offsets = np.array([-nx, -1, 0, 1, nx], dtype=np.int32)
    cand = idx[:, None] + offsets[None, :]  # (n, 5)
    valid = np.stack(
        [iy > 0, ix > 0, np.ones(n, dtype=bool), ix < nx - 1, iy < ny - 1],
        axis=1,
    )
    lens = valid.sum(axis=1).astype(np.int64)
    rowptr = np.concatenate([[0], np.cumsum(lens)])
    colind = cand[valid]
    valmat = np.full((n, 5), -1.0, dtype=dtype)
    valmat[:, 2] = 4.0
    values = valmat[valid]
    out = CSRHost(rowptr=rowptr, colind=colind.astype(np.int32),
                  values=values, ncols=n)
    out._sorted_unique = True  # ascending-offset construction
    return out


def create_laplace_3d(nx: int, ny: int | None = None, nz: int | None = None,
                      dtype=np.float64) -> CSRHost:
    """3-D 7-point Laplacian on an nx x ny x nz grid (Dirichlet): diag 6,
    neighbors -1, offsets {-nx*ny, -nx, -1, 0, +1, +nx, +nx*ny}."""
    ny = ny if ny is not None else nx
    nz = nz if nz is not None else nx
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int32)
    ix = idx % np.int32(nx)
    iy = (idx // np.int32(nx)) % np.int32(ny)
    iz = idx // np.int32(nx * ny)
    offsets = np.array([-nx * ny, -nx, -1, 0, 1, nx, nx * ny], dtype=np.int32)
    cand = idx[:, None] + offsets[None, :]
    valid = np.stack(
        [iz > 0, iy > 0, ix > 0, np.ones(n, dtype=bool),
         ix < nx - 1, iy < ny - 1, iz < nz - 1],
        axis=1,
    )
    lens = valid.sum(axis=1).astype(np.int64)
    rowptr = np.concatenate([[0], np.cumsum(lens)])
    colind = cand[valid]
    valmat = np.full((n, 7), -1.0, dtype=dtype)
    valmat[:, 3] = 6.0
    values = valmat[valid]
    out = CSRHost(rowptr=rowptr, colind=colind.astype(np.int32),
                  values=values, ncols=n)
    out._sorted_unique = True  # ascending-offset construction
    return out


def hpcg_27pt(nx: int, ny: int, nz: int, dtype=np.float64) -> CSRHost:
    """HPCG 3.1's operator (``GenerateProblem_ref.cpp``): the 27-point
    stencil on an nx x ny x nz grid, numbered ``ix + nx*(iy + ny*iz)``, 26
    on the diagonal and -1 for each of the up to 26 neighbours inside the
    grid (every face is a domain boundary, as on one rank). Columns ascend
    within a row, as HPCG's loops over (sz, sy, sx) give them."""
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int32)
    ix = idx % np.int32(nx)
    iy = (idx // np.int32(nx)) % np.int32(ny)
    iz = idx // np.int32(nx * ny)
    steps = (-1, 0, 1)
    # (n, 3) in-grid masks along each axis for steps -1, 0, +1
    ok = [np.stack([c > 0, np.ones(n, dtype=bool), c < m - 1], axis=1)
          for c, m in ((ix, nx), (iy, ny), (iz, nz))]
    valid = (ok[2][:, :, None, None] & ok[1][:, None, :, None]
             & ok[0][:, None, None, :]).reshape(n, 27)
    del ok
    offsets = np.array([sx + nx * (sy + ny * sz) for sz in steps
                        for sy in steps for sx in steps], dtype=np.int32)
    lens = valid.sum(axis=1).astype(np.int64)
    rowptr = np.concatenate([[0], np.cumsum(lens)])
    colind = (idx[:, None] + offsets[None, :])[valid]
    values = np.where(offsets == 0, 26.0, -1.0).astype(dtype)
    values = np.broadcast_to(values, (n, 27))[valid]
    out = CSRHost(rowptr=rowptr, colind=colind, values=values, ncols=n)
    out._sorted_unique = True  # ascending-offset construction
    return out


def random_csr(
    nrows: int,
    ncols: int,
    nnz_per_row: int,
    seed: int = 0,
    dtype=np.float64,
    symmetric: bool = False,
    spd_shift: float = 0.0,
) -> CSRHost:
    """Random sparse matrix for tests (duplicates merged). With
    ``symmetric=True`` returns A + A^T (+ spd_shift * row-sum on the
    diagonal, making it strictly diagonally dominant SPD when
    spd_shift >= 1)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(nrows, dtype=np.int64), nnz_per_row)
    cols = rng.integers(0, ncols, size=nrows * nnz_per_row)
    vals = rng.standard_normal(nrows * nnz_per_row).astype(dtype)
    a = CSRHost.from_coo(rows, cols, vals, nrows, ncols)
    if symmetric:
        assert nrows == ncols
        dense_sym = a.to_dense()
        dense_sym = dense_sym + dense_sym.T
        if spd_shift:
            np.fill_diagonal(
                dense_sym,
                np.abs(dense_sym).sum(axis=1) * spd_shift + 1.0,
            )
        a = CSRHost.from_dense(dense_sym)
    return a


def gaussian_bump(n: int, dtype=np.float64) -> np.ndarray:
    """Gaussian-bump input vector of length n, centred on the index range."""
    t = (np.arange(n, dtype=np.float64) / max(n - 1, 1)) - 0.5
    return np.exp(-10.0 * t * t).astype(dtype)
