"""Symmetric Gauss–Seidel on symmetric DIA storage in 8 colours, and the
residual at the coarse points: the plain torch versions of the two kernels
of ``csrc/symgs_dia.cu`` (HPCG 3.1's ``ComputeSYMGS_ref`` and the residual
half of ``ComputeRestriction_ref``), on the operator of a structured grid.

The operator is a DistMatrix's one DIA block in symmetric storage: the
stored diagonals have offsets o <= 0 (the diagonal included), laid out as
``formats/dia.py`` says, so the coupling of row i to row i + o is stored at
row i and its coupling to row i - o at row i - o (the transpose term of
``csrc/dia_window.cuh``). Rows are the grid's points ``ix + nx*(iy +
ny*iz)``; every coupling joins two points of the 27-point neighbourhood.

The colour of a point is ``(ix % 2) + 2 (iy % 2) + 4 (iz % 2)``: two points
of one colour are never neighbours, so the rows of a colour update at once.
A forward sweep takes colours 0 .. 7, a backward one 7 .. 0 (HPCG's
reference sweeps lexicographically; its rules let an optimised run reorder
the sweep, and the 8 colours are that order here).

A sweep reads only the rows before each row in its order. With E_i the
sum of a_ij x_j over those (their new values), Gauss–Seidel's forward
update is x_i = (r_i - E_i - w_i) / a_ii, with w_i the sum over the rows
after i at their values before the sweep (0 from x = 0). The backward
sweep's rows after i are the forward sweep's rows before it, whose sum
the forward update left as r_i - a_ii x'_i - w_i (x' its result). So:

    forward   x_i = (r_i - (E_i + w_i)) / a_ii
    backward  x_i = x_i + (w_i - E_i) / a_ii

A backward sweep's E is the sum over the rows after i in the forward
order at its result: it keeps it as the next forward sweep's ``w``. In a
V-cycle that holds: between a level's two SymGS only the prolongation
changes x, at colour-0 points (the coarse points), which come after no
row in the forward order. So a SymGS reads each coupling once a sweep,
where the plain update reads it for both of its rows: the same numbers
in exact arithmetic.

Each sum runs over the stored diagonals in order, the lower term before
the upper one, with one rounding a product and one a sum, as the kernels
add them.
"""
from __future__ import annotations

import functools

import torch

from spmv_torch.formats.dia import LANES


def colours(grid: tuple[int, int, int], device) -> torch.Tensor:
    """(n,) int64: each row's colour, (ix % 2) + 2 (iy % 2) + 4 (iz % 2)."""
    nx, ny, nz = grid
    i = torch.arange(nx * ny * nz, device=device)
    return (i % nx) % 2 + 2 * ((i // nx % ny) % 2) + 4 * ((i // (nx * ny)) % 2)


def coarse_rows(grid: tuple[int, int, int], device) -> torch.Tensor:
    """(nc,) int64: the fine row of each coarse point, coarse (i, j, k) ->
    fine (2i, 2j, 2k), in the coarse grid's numbering (HPCG's f2c)."""
    nx, ny, nz = grid
    cx, cy, cz = nx // 2, ny // 2, nz // 2
    c = torch.arange(cx * cy * cz, device=device)
    return 2 * (c % cx) + nx * (2 * (c // cx % cy) + ny * 2 * (c // (cx * cy)))


def _terms(rows, offsets, n):
    """The off-diagonal terms of ``rows``, in the order the kernels add
    them (each stored diagonal, its lower term then its upper one): (value
    positions in the interleaved data, x positions, in-grid mask), each
    (2 (K - 1), m); and the diagonal's value positions."""
    k = len(offsets)

    def at(row, d):
        return row // LANES * (k * LANES) + d * LANES + row % LANES

    vals, xs, oks = [], [], []
    for d, o in enumerate(offsets):
        if o == 0:
            diag = at(rows, d)
            continue
        lo, up = (rows + o).clamp(min=0), (rows - o).clamp(max=n - 1)
        for j, ok, row in ((lo, rows + o >= 0, rows), (up, rows - o < n, up)):
            vals.append(at(row, d))
            xs.append(j)
            oks.append(ok)
    if not vals:  # the diagonal alone (a grid of one point)
        none = rows.new_zeros((0, rows.numel()))
        return none, none, none.bool(), diag
    return torch.stack(vals), torch.stack(xs), torch.stack(oks), diag


@functools.lru_cache(maxsize=32)
def _sweep_plan(grid, offsets, device, forward: bool):
    """Per colour in the sweep's order: (rows, the terms' value positions,
    x positions, in-grid-and-before mask, the diagonal's positions)."""
    nx, ny, nz = grid
    col = colours(grid, device)
    plan = []
    for c in (range(8) if forward else range(7, -1, -1)):
        rows = (col == c).nonzero().squeeze(1)
        if rows.numel() == 0:
            continue
        vals, xs, ok, diag = _terms(rows, offsets, nx * ny * nz)
        before = col[xs] < c if forward else col[xs] > c
        plan.append((rows, vals, xs, ok & before, diag))
    return plan


def _sum(flat, vals, xs, oks, xf):
    """The terms' sum, added one term after another."""
    p = flat[vals] * xf[xs]
    p = torch.where(oks, p, torch.zeros_like(p))
    s = p.new_zeros(p.shape[1])
    for term in p:
        s = s + term
    return s


def symgs_sweep_plain(data: torch.Tensor, offsets: tuple[int, ...],
                      grid: tuple[int, int, int], r: torch.Tensor,
                      x: torch.Tensor, forward: bool,
                      w_in: torch.Tensor | None = None,
                      w_out: torch.Tensor | None = None) -> None:
    """One sweep direction over the 8 colours, x updated in place, with
    ``w_in`` as w (None: 0); a backward sweep keeps its E in ``w_out``."""
    flat, xf, rf = data.view(-1), x.view(-1), r.view(-1)
    for rows, vals, xs, before, diag in _sweep_plan(
            tuple(grid), tuple(offsets), x.device, forward):
        e = _sum(flat, vals, xs, before, xf)
        d = flat[diag]
        if forward:
            ew = e if w_in is None else e + w_in.view(-1)[rows]
            xf[rows] = (rf[rows] - ew) / d
        else:
            wv = torch.zeros_like(e) if w_in is None else w_in.view(-1)[rows]
            xf[rows] = xf[rows] + (wv - e) / d
            if w_out is not None:
                w_out.view(-1)[rows] = e


def restrict_residual_plain(data: torch.Tensor, offsets: tuple[int, ...],
                            grid: tuple[int, int, int], r: torch.Tensor,
                            x: torch.Tensor, rc: torch.Tensor) -> None:
    """rc[c] = r[f] - (A x)[f] at each coarse point's fine row f, written
    into rc's first nc entries. The diagonal's term is added in its place
    among the stored diagonals."""
    nx, ny, nz = grid
    flat, xf = data.view(-1), x.view(-1)
    f = coarse_rows(grid, x.device)
    vals, xs, oks, diag = _terms(f, offsets, nx * ny * nz)
    # the diagonal's term goes where its offset (the last, 0) puts it
    d = offsets.index(0)
    vals = torch.cat([vals[: 2 * d], diag[None], vals[2 * d:]])
    xs = torch.cat([xs[: 2 * d], f[None], xs[2 * d:]])
    oks = torch.cat([oks[: 2 * d], torch.ones_like(f, dtype=torch.bool)[None],
                     oks[2 * d:]])
    rc.view(-1)[: f.numel()] = r.view(-1)[f] - _sum(flat, vals, xs, oks, xf)
