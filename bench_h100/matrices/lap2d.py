"""The 2-D 5-point Dirichlet Laplacian on an nx x ny grid: diagonal 4,
neighbours -1, row-major numbering (offsets -nx, -1, 0, +1, +nx).

A frozen copy of ``spmv_torch.gen.create_laplace_2d`` (the upstream's
5-point ``demos/cg.cpp`` problem), so that a change to the program's
generator cannot change the yardstick. Parameters: ``nx``, ``ny``.
"""
from __future__ import annotations

import numpy as np

from bench_h100.reference.csr import CSR


def generate(params: dict) -> CSR:
    nx, ny = int(params["nx"]), int(params["ny"])
    n = nx * ny
    idx = np.arange(n, dtype=np.int32)
    ix = idx % np.int32(nx)
    iy = idx // np.int32(nx)
    offsets = np.array([-nx, -1, 0, 1, nx], dtype=np.int32)
    cand = idx[:, None] + offsets[None, :]  # (n, 5), ascending offsets
    valid = np.stack(
        [iy > 0, ix > 0, np.ones(n, dtype=bool), ix < nx - 1, iy < ny - 1],
        axis=1)
    rowptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(valid.sum(axis=1), out=rowptr[1:])
    colind = cand[valid]
    del cand
    valmat = np.full((n, 5), -1.0)
    valmat[:, 2] = 4.0
    return CSR(rowptr, colind, valmat[valid], n)
