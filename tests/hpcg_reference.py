"""HPCG 3.1's operator and its multigrid-preconditioned CG in plain torch:
the reference that the port's ``solvers/gmg.py`` is held against.

It follows HPCG's reference code step for step, on torch sparse CSR
matrices built here, and uses nothing of the port (no kernel, no module)
and no JAX:

- ``generate``: ``GenerateProblem_ref.cpp``, its loops as they are;
- ``symgs``: ``ComputeSYMGS_ref.cpp``, each row's update as HPCG writes it
  (sum = r_i - sum_j a_ij x_j + a_ii x_i; x_i = sum / a_ii). Its one
  departure from HPCG: rows are taken in 8 colours, (ix % 2) + 2 (iy % 2)
  + 4 (iz % 2), 0 .. 7 forward and 7 .. 0 backward, where HPCG's reference
  goes in row order. The rows of a colour are never neighbours, so they
  update at once: each colour's rows are one row block of the CSR, and a
  sweep costs one apply;
- ``mg``: ``ComputeMG_ref.cpp``: x = 0; SymGS; A x; restriction by
  injection, rc = r[f2c] - (A x)[f2c]; the next level; prolongation by
  injection, x[f2c] += xc; SymGS; one SymGS alone on the coarsest level;
  every level ``GenerateCoarseProblem``'s, the grid halved;
- ``cg``: ``CG_ref.cpp`` with the multigrid, from x = 0, a fixed number of
  iterations (HPCG's sets run with tolerance 0).

Values and vectors take the dtype asked for (float64 is HPCG's); TF32 is
off wherever a product could take it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _exact() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def generate(nx: int, ny: int, nz: int):
    """(rowptr, colind, values) of the 27-point operator on the grid, as
    GenerateProblem_ref's loops make it: row ix + nx (iy + ny iz), 26 on
    the diagonal, -1 for each neighbour inside the grid, columns in loop
    order (ascending)."""
    rowptr, colind, values = [0], [], []
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                row = ix + nx * (iy + ny * iz)
                for sz in (-1, 0, 1):
                    for sy in (-1, 0, 1):
                        for sx in (-1, 0, 1):
                            jx, jy, jz = ix + sx, iy + sy, iz + sz
                            if 0 <= jx < nx and 0 <= jy < ny and 0 <= jz < nz:
                                col = jx + nx * (jy + ny * jz)
                                colind.append(col)
                                values.append(26.0 if col == row else -1.0)
                rowptr.append(len(colind))
    return (np.array(rowptr, dtype=np.int64), np.array(colind, dtype=np.int64),
            np.array(values))


def colours(nx: int, ny: int, nz: int) -> np.ndarray:
    i = np.arange(nx * ny * nz)
    return (i % nx) % 2 + 2 * ((i // nx % ny) % 2) + 4 * ((i // (nx * ny)) % 2)


def _csr(rowptr, colind, values, shape, dtype, device):
    return torch.sparse_csr_tensor(
        torch.as_tensor(rowptr, device=device),
        torch.as_tensor(colind, device=device),
        torch.as_tensor(values, dtype=dtype, device=device), shape)


@dataclasses.dataclass
class Level:
    grid: tuple[int, int, int]
    A: torch.Tensor                       # the whole operator
    blocks: list                          # per colour: (rows, its row block, its diagonal)
    f2c: torch.Tensor | None = None       # fine row of each point of the next level


def level(grid, dtype=torch.float64, device="cpu") -> Level:
    nx, ny, nz = grid
    n = nx * ny * nz
    rowptr, colind, values = generate(nx, ny, nz)
    rows_all = np.repeat(np.arange(n), np.diff(rowptr))
    diag = values[colind == rows_all]  # one a row, rows in order
    col = colours(nx, ny, nz)
    blocks = []
    for c in range(8):
        rows = np.flatnonzero(col == c)
        lens = np.diff(rowptr)[rows]
        take = np.concatenate([np.arange(rowptr[i], rowptr[i + 1]) for i in rows]) \
            if len(rows) else np.zeros(0, dtype=np.int64)
        ptr = np.concatenate([[0], np.cumsum(lens)])
        blocks.append((torch.as_tensor(rows, device=device),
                       _csr(ptr, colind[take], values[take], (len(rows), n), dtype,
                            device),
                       torch.as_tensor(diag[rows], dtype=dtype, device=device)))
    return Level(grid, _csr(rowptr, colind, values, (n, n), dtype, device), blocks)


def hierarchy(grid, levels: int = 4, dtype=torch.float64, device="cpu") -> list[Level]:
    """HPCG's levels, finest first, each grid the last one halved."""
    _exact()
    out = [level(tuple(grid), dtype, device)]
    for _ in range(levels - 1):
        nx, ny, nz = out[-1].grid
        cx, cy, cz = nx // 2, ny // 2, nz // 2
        c = np.arange(cx * cy * cz)
        out[-1].f2c = torch.as_tensor(
            2 * (c % cx) + nx * (2 * (c // cx % cy) + ny * 2 * (c // (cx * cy))),
            device=device)
        out.append(level((cx, cy, cz), dtype, device))
    return out


def sweep(lv: Level, r: torch.Tensor, x: torch.Tensor, forward: bool) -> None:
    """One direction of ComputeSYMGS_ref, colour by colour, x in place."""
    for c in (range(8) if forward else range(7, -1, -1)):
        rows, block, d = lv.blocks[c]
        if rows.numel() == 0:
            continue
        s = r[rows] - block @ x
        s = s + x[rows] * d
        x[rows] = s / d


def symgs(lv: Level, r: torch.Tensor, x: torch.Tensor) -> None:
    sweep(lv, r, x, True)
    sweep(lv, r, x, False)


def mg(levels: list[Level], r: torch.Tensor, k: int = 0) -> torch.Tensor:
    """ComputeMG_ref on level k: M^-1 r."""
    lv = levels[k]
    x = torch.zeros_like(r)
    symgs(lv, r, x)
    if k + 1 < len(levels):
        axf = lv.A @ x
        rc = r[lv.f2c] - axf[lv.f2c]
        x[lv.f2c] += mg(levels, rc, k + 1)
        symgs(lv, r, x)
    return x


def cg(levels: list[Level], b: torch.Tensor, iterations: int):
    """CG_ref with the multigrid from x = 0 for ``iterations`` iterations:
    (x, |r| / |r0|)."""
    _exact()
    A = levels[0].A
    x = torch.zeros_like(b)
    r = b - A @ x
    normr0 = torch.linalg.vector_norm(r)
    rtz = p = None
    for k in range(1, iterations + 1):
        z = mg(levels, r)
        if k == 1:
            p = z.clone()
            rtz = torch.dot(r, z)
        else:
            oldrtz, rtz = rtz, torch.dot(r, z)
            p = z + (rtz / oldrtz) * p
        ap = A @ p
        alpha = rtz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
    return x, float(torch.linalg.vector_norm(r) / normr0)
