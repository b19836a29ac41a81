"""A plain reference for DOLFINx's Poisson demo operator
(``python/demo/demo_poisson.py``): P1 Lagrange on ``create_rectangle``'s
cx x cy cells of [0, 2] x [0, 1], each cut by the "right" diagonal, u = 0 on
x = 0 and x = 2; and its apply.

It imports numpy and torch alone, nothing of the program and no JAX, and
works the slow way, for small meshes:
- the stiffness matrix is assembled triangle by triangle in a Python loop,
  each element matrix (e_i . e_j) / (4A) from its vertices' coordinates, and
  every pair of vertices of a triangle is a stored entry, zeros included;
- the Dirichlet rows and columns are zeroed (their entries stay stored) and
  their diagonal set to 1, as DOLFINx does for PETSc;
- the vertices are numbered by a breadth-first search from the corner
  (x = 0, y = 1), each level in order of ascending x, the whole order
  reversed (the level order the benchmark assumes in place of DOLFINx's);
- the apply is a float64 torch CSR product with TF32 off.

Vertex coordinates are taken relative to each triangle's first vertex, in
multiples of the cell widths, as a mesh generator lays out a uniform grid.
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch


def mesh(cx: int, cy: int):
    """(vertices as (ix, iy), triangles as vertex-index triples) of the
    right-diagonal mesh, vertex (ix, iy) numbered iy * (cx + 1) + ix."""
    verts = [(ix, iy) for iy in range(cy + 1) for ix in range(cx + 1)]
    tris = []
    for iy in range(cy):
        for ix in range(cx):
            v0 = iy * (cx + 1) + ix
            v1, v2, v3 = v0 + 1, v0 + cx + 1, v0 + cx + 2
            tris += [(v0, v1, v3), (v0, v2, v3)]
    return verts, tris


def element_matrix(p: np.ndarray) -> np.ndarray:
    """The P1 stiffness matrix of the triangle with vertices ``p`` (3, 2)."""
    e = [p[2] - p[1], p[0] - p[2], p[1] - p[0]]
    area = 0.5 * abs(e[2][0] * e[1][1] - e[2][1] * e[1][0])
    k = np.zeros((3, 3))
    for i in range(3):
        for j in range(3):
            k[i, j] = float(e[i] @ e[j]) / (4.0 * area)
    return k


def level_order(cx: int, cy: int, verts, tris) -> list[int]:
    """new -> natural vertex index: BFS levels from (0, cy), each level by
    ascending ix, reversed."""
    nbrs = [set() for _ in verts]
    for t in tris:
        for a in t:
            nbrs[a].update(b for b in t if b != a)
    start = cy * (cx + 1)
    level = {start: 0}
    queue = deque([start])
    while queue:
        v = queue.popleft()
        for w in nbrs[v]:
            if w not in level:
                level[w] = level[v] + 1
                queue.append(w)
    order = sorted(range(len(verts)), key=lambda v: (level[v], verts[v][0]))
    return order[::-1]


def assemble(cx: int, cy: int):
    """(rowptr, colind, values) of the demo's matrix in the level order,
    columns ascending within each row."""
    hx, hy = 2.0 / cx, 1.0 / cy
    verts, tris = mesh(cx, cy)
    entries: dict[tuple[int, int], float] = {}
    for t in tris:
        base = verts[t[0]]
        p = np.array([[(verts[v][0] - base[0]) * hx, (verts[v][1] - base[1]) * hy]
                      for v in t])
        k = element_matrix(p)
        for i, a in enumerate(t):
            for j, b in enumerate(t):
                entries[(a, b)] = entries.get((a, b), 0.0) + k[i, j]
    dirichlet = {v for v, (ix, _) in enumerate(verts) if ix in (0, cx)}
    for (a, b) in entries:
        if a in dirichlet or b in dirichlet:
            entries[(a, b)] = 1.0 if a == b else 0.0
    order = level_order(cx, cy, verts, tris)
    new = {v: i for i, v in enumerate(order)}
    rows: list[list[tuple[int, float]]] = [[] for _ in verts]
    for (a, b), v in entries.items():
        rows[new[a]].append((new[b], v))
    rowptr, colind, values = [0], [], []
    for r in rows:
        for c, v in sorted(r):
            colind.append(c)
            values.append(v)
        rowptr.append(len(colind))
    return (np.array(rowptr, dtype=np.int64), np.array(colind, dtype=np.int64),
            np.array(values, dtype=np.float64))


def apply(rowptr: np.ndarray, colind: np.ndarray, values: np.ndarray,
          x: np.ndarray) -> np.ndarray:
    """y = A x in float64 torch CSR, TF32 off."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        n = len(rowptr) - 1
        a = torch.sparse_csr_tensor(torch.as_tensor(rowptr), torch.as_tensor(colind),
                                    torch.as_tensor(values, dtype=torch.float64),
                                    (n, n), check_invariants=True)
        xt = torch.as_tensor(np.asarray(x, dtype=np.float64))
        return (a @ xt[:, None])[:, 0].numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
