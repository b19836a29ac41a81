"""DOLFINx's Poisson demo operator (``python/demo/demo_poisson.py``): -Δu = f
on [0, 2] x [0, 1] with P1 Lagrange elements on ``create_rectangle``'s
``cx`` x ``cy`` cells, each cut by the "right" diagonal into the triangles
(v0, v1, v3) and (v0, v2, v3), v0 = (ix, iy), v1 = (ix+1, iy),
v2 = (ix, iy+1), v3 = (ix+1, iy+1); u = 0 on the edges x = 0 and x = 2.

Assembled as DOLFINx assembles it for PETSc:
- element by element, the stiffness matrix (e_i . e_j) / (4A), e_i the
  edge opposite vertex i, vectorised over the cells of each triangle kind;
- every pair of vertices that share a triangle is a stored entry, the
  diagonal-edge couplings of these right triangles included, which are
  exactly 0.0;
- the rows and columns of the Dirichlet vertices are zeroed (their entries
  stay stored) and their diagonal set to 1.

Numbering (assumed; DOLFINx numbers its dofs by its own bandwidth-reducing
graph reordering): a Cuthill-McKee level order from the corner (x = 0,
y = 1), reversed. The levels are the graph distances from that corner,
ix + (cy - iy) on this mesh, each level in order of ascending x.

Plain numpy, imports nothing of the program, so that a change to the
program cannot change the yardstick. Parameters: ``cx``, ``cy``.
"""
from __future__ import annotations

import numpy as np

from bench_h100.reference.csr import CSR

# the stencil's lattice steps (dx, dy): the vertex itself, its four axis
# neighbours and its two neighbours along the right diagonal
STEPS = ((0, 0), (-1, -1), (0, -1), (-1, 0), (1, 0), (0, 1), (1, 1))
# local lattice offsets of the two triangle kinds' vertices
TRIANGLES = (((0, 0), (1, 0), (1, 1)), ((0, 0), (0, 1), (1, 1)))


def element_matrices(hx: float, hy: float) -> np.ndarray:
    """(2, 3, 3): the P1 stiffness matrix (e_i . e_j) / (4A) of each triangle
    kind, from its vertices' offsets times the cell's widths."""
    p = np.array(TRIANGLES, dtype=np.float64) * np.array([hx, hy])
    # e_i: the edge opposite vertex i, oriented around the triangle
    e = np.stack([p[:, 2] - p[:, 1], p[:, 0] - p[:, 2], p[:, 1] - p[:, 0]],
                 axis=1)
    area = 0.5 * np.abs(e[:, 2, 0] * e[:, 1, 1] - e[:, 2, 1] * e[:, 1, 0])
    return np.einsum("tik,tjk->tij", e, e) / (4.0 * area)[:, None, None]


def level_order(cx: int, cy: int) -> np.ndarray:
    """The new index of each lattice vertex iy * (cx + 1) + ix: levels
    ix + (cy - iy) in ascending order, each by ascending ix, all reversed."""
    nvx, nvy = cx + 1, cy + 1
    ix = np.arange(nvx, dtype=np.int64)[None, :]
    iy = np.arange(nvy, dtype=np.int64)[:, None]
    level = ix + (cy - iy)
    sizes = np.bincount(level.ravel(), minlength=cx + cy + 1)
    first = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    forward = first[level] + ix - np.maximum(level - cy, 0)
    return (nvx * nvy - 1 - forward).ravel()


def generate(params: dict) -> CSR:
    cx, cy = int(params["cx"]), int(params["cy"])
    nvx, nvy = cx + 1, cy + 1
    n = nvx * nvy
    ke = element_matrices(2.0 / cx, 1.0 / cy)
    # stencil[s, iy, ix]: the entry of vertex (ix, iy) toward its neighbour
    # (ix, iy) + STEPS[s], summed over the triangles they share
    stencil = np.zeros((len(STEPS), nvy, nvx))
    step = {d: s for s, d in enumerate(STEPS)}
    for t, verts in enumerate(TRIANGLES):
        for i, (ax, ay) in enumerate(verts):
            for j, (bx, by) in enumerate(verts):
                # every cell's triangle t adds ke[t, i, j] at its vertex i
                stencil[step[(bx - ax, by - ay)], ay:ay + cy, ax:ax + cx] += ke[t, i, j]
    # Dirichlet vertices: x = 0 and x = 2
    dirichlet = np.zeros((nvy, nvx), dtype=bool)
    dirichlet[:, [0, cx]] = True
    new = level_order(cx, cy).reshape(nvy, nvx)
    cols = np.full((nvy, nvx, len(STEPS)), n, dtype=np.int64)
    for s, (dx, dy) in enumerate(STEPS):
        ys = slice(max(-dy, 0), nvy - max(dy, 0))
        xs = slice(max(-dx, 0), nvx - max(dx, 0))
        yt = slice(max(dy, 0), nvy - max(-dy, 0))
        xt = slice(max(dx, 0), nvx - max(-dx, 0))
        cols[ys, xs, s] = new[yt, xt]
        # a coupling in a Dirichlet row or column is zeroed, and stays stored
        if s:
            stencil[s, ys, xs][dirichlet[ys, xs] | dirichlet[yt, xt]] = 0.0
    stencil[0][dirichlet] = 1.0
    vals = np.moveaxis(stencil, 0, -1)
    del stencil
    # rows in the new numbering, columns ascending within each row
    order = np.empty(n, dtype=np.int64)
    order[new.ravel()] = np.arange(n, dtype=np.int64)
    cols = cols.reshape(n, len(STEPS))[order]
    vals = vals.reshape(n, len(STEPS))[order]
    by_col = np.argsort(cols, axis=1)
    cols = np.take_along_axis(cols, by_col, axis=1)
    vals = np.take_along_axis(vals, by_col, axis=1)
    valid = cols < n
    rowptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(valid.sum(axis=1), out=rowptr[1:])
    return CSR(rowptr, cols[valid].astype(np.int32), vals[valid], n)
