"""HPCG 3.1's operator (``GenerateProblem_ref.cpp``): the 27-point stencil
on an nx x ny x nz grid, numbered ix + nx (iy + ny iz), 26 on the diagonal
and -1 for each of the up to 26 neighbours inside the grid, columns
ascending within a row.

A frozen copy of ``spmv_torch.gen.hpcg_27pt``, so that a change to the
program's generator cannot change the yardstick. Parameters: ``nx``,
``ny``, ``nz``.
"""
from __future__ import annotations

import numpy as np

from bench_h100.reference.csr import CSR


def generate(params: dict) -> CSR:
    nx, ny, nz = int(params["nx"]), int(params["ny"]), int(params["nz"])
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int32)
    ix = idx % np.int32(nx)
    iy = (idx // np.int32(nx)) % np.int32(ny)
    iz = idx // np.int32(nx * ny)
    # (n, 3) in-grid masks along each axis for the steps -1, 0, +1
    ok = [np.stack([c > 0, np.ones(n, dtype=bool), c < m - 1], axis=1)
          for c, m in ((ix, nx), (iy, ny), (iz, nz))]
    del ix, iy, iz
    valid = (ok[2][:, :, None, None] & ok[1][:, None, :, None]
             & ok[0][:, None, None, :]).reshape(n, 27)
    del ok
    steps = (-1, 0, 1)
    offsets = np.array([sx + nx * (sy + ny * sz) for sz in steps
                        for sy in steps for sx in steps], dtype=np.int32)
    rowptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(valid.sum(axis=1), out=rowptr[1:])
    colind = (idx[:, None] + offsets[None, :])[valid]
    values = np.broadcast_to(np.where(offsets == 0, 26.0, -1.0), (n, 27))[valid]
    return CSR(rowptr, colind, values, n)
