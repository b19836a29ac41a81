"""HPCG 3.1's multigrid-preconditioned CG in plain float64 torch, from the
benchmark's own level matrices (``matrices/hpcg27.py`` on each grid),
on the run's device: the numbers that decide ``correct`` in the
``hpcg_mg`` cells. Nothing of the program is imported.

It follows HPCG's reference code step for step:

- SymGS (``ComputeSYMGS_ref.cpp``): each row as HPCG updates it, sum = r_i
  - sum_j a_ij x_j + a_ii x_i, x_i = sum / a_ii; one forward sweep, one
  backward. Its one departure from HPCG: rows go in 8 colours, (ix % 2) +
  2 (iy % 2) + 4 (iz % 2), 0 .. 7 forward and 7 .. 0 backward, where HPCG's
  reference goes in row order (an optimised run may reorder the sweep;
  the program does so). The rows of a colour are never neighbours, so they
  update at once: each colour's rows are one row block of the CSR, and a
  sweep costs one apply.
- the cycle (``ComputeMG_ref.cpp``): x = 0; SymGS; A x; restriction by
  injection, rc = r[f2c] - (A x)[f2c]; the next level; prolongation by
  injection, x[f2c] += xc; SymGS; on the coarsest level one SymGS alone.
  f2c takes coarse (i, j, k) to fine (2i, 2j, 2k).
- CG (``CG_ref.cpp``) with the cycle as its preconditioner, from x = 0,
  ``kmax`` iterations (a set runs with tolerance 0).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from bench_h100.reference.csr import CSR, TorchCSR


def colours(grid) -> np.ndarray:
    nx, ny, nz = grid
    i = np.arange(nx * ny * nz, dtype=np.int64)
    return ((i % nx) % 2 + 2 * ((i // nx % ny) % 2)
            + 4 * ((i // (nx * ny)) % 2)).astype(np.int8)


def coarse_points(grid) -> np.ndarray:
    """f2c: the fine row of each point of the grid halved."""
    nx, ny, nz = grid
    cx, cy, cz = nx // 2, ny // 2, nz // 2
    c = np.arange(cx * cy * cz, dtype=np.int64)
    return 2 * (c % cx) + nx * (2 * (c // cx % cy) + ny * 2 * (c // (cx * cy)))


def colour_blocks(a: CSR, grid) -> list[tuple[np.ndarray, CSR, np.ndarray]]:
    """Per colour: (its rows, ascending; their row block of ``a``; their
    diagonal)."""
    col = colours(grid)
    order = np.argsort(col, kind="stable")
    lens = np.diff(a.rowptr)[order]
    ptr = np.zeros(a.nrows + 1, dtype=np.int64)
    np.cumsum(lens, out=ptr[1:])
    take = np.repeat(a.rowptr[:-1][order] - ptr[:-1], lens)
    take += np.arange(a.nnz, dtype=np.int64)
    colind, values = a.colind[take], a.values[take]
    del take
    rows_of = np.repeat(order, lens)
    diag_at = colind == rows_of
    diag = np.empty(a.nrows)
    diag[rows_of[diag_at]] = values[diag_at]
    del rows_of, diag_at
    bounds = np.concatenate([[0], np.cumsum(np.bincount(col, minlength=8))])
    out = []
    for c in range(8):
        r0, r1 = bounds[c], bounds[c + 1]
        rows = order[r0:r1]
        out.append((rows, CSR(ptr[r0:r1 + 1] - ptr[r0], colind[ptr[r0]:ptr[r1]],
                              values[ptr[r0]:ptr[r1]], a.ncols), diag[rows]))
    return out


@dataclasses.dataclass
class Level:
    A: TorchCSR
    blocks: list        # per colour: (rows, row block, diagonal) on the device
    f2c: object = None  # the next level's points, as fine rows


def hierarchy(levels: list, device) -> list[Level]:
    """``levels``: [(grid, CSR)], finest first, each grid the last halved."""
    import torch

    out = []
    for k, (grid, a) in enumerate(levels):
        at = a.on(device)
        blocks = [(torch.as_tensor(rows, device=device), block.on(device),
                   at.tensor(d)) for rows, block, d in colour_blocks(a, grid)]
        f2c = (torch.as_tensor(coarse_points(grid), device=device)
               if k + 1 < len(levels) else None)
        out.append(Level(at, blocks, f2c))
    return out


def sweep(lv: Level, r, x, forward: bool) -> None:
    for c in (range(8) if forward else range(7, -1, -1)):
        rows, block, d = lv.blocks[c]
        if rows.numel() == 0:
            continue
        s = r[rows] - block.apply(x)
        s = s + x[rows] * d
        x[rows] = s / d


def mg(levels: list[Level], r, k: int = 0):
    """ComputeMG_ref on level k: M^-1 r."""
    import torch

    lv = levels[k]
    x = torch.zeros_like(r)
    sweep(lv, r, x, True)
    sweep(lv, r, x, False)
    if lv.f2c is not None:
        axf = lv.A.apply(x)
        rc = r[lv.f2c] - axf[lv.f2c]
        x[lv.f2c] += mg(levels, rc, k + 1)
        sweep(lv, r, x, True)
        sweep(lv, r, x, False)
    return x


def cg(levels: list[Level], b, kmax: int):
    """CG_ref with the multigrid from x = 0 for ``kmax`` iterations."""
    import torch

    a = levels[0].A
    x = torch.zeros_like(b)
    r = b - a.apply(x)
    rtz = p = None
    for k in range(1, kmax + 1):
        z = mg(levels, r)
        if k == 1:
            p = z.clone()
            rtz = torch.dot(r, z)
        else:
            oldrtz, rtz = rtz, torch.dot(r, z)
            p = z + (rtz / oldrtz) * p
        ap = a.apply(p)
        alpha = rtz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
    return x


def solution_errors(levels: list, device, rhs: list, answers: list,
                    solver: dict) -> list[float]:
    """||x - x_ref|| / ||x_ref|| for each answer ``(j, x)``: x_ref is the
    reference's MG-PCG from ``rhs[j]`` with the configuration's kmax, worked
    out from the benchmark's own level matrices."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if float(solver["rtol"]) != 0.0:
        raise ValueError("the reference runs HPCG's sets: rtol 0")
    ref_levels = hierarchy(levels, device)
    at = ref_levels[0].A
    refs, out = {}, []
    for j, x in answers:
        if j not in refs:
            refs[j] = cg(ref_levels, at.tensor(rhs[j]), int(solver["kmax"]))
        ref = refs[j]
        out.append(float(torch.linalg.vector_norm(at.tensor(x) - ref)
                         / torch.linalg.vector_norm(ref)))
    return out
