"""Structurally diverse operator corpus: deterministic generators for
matrices nobody tuned the kernels for (unstructured-mesh FEM on true
Delaunay triangulations, power-law graphs, circuit networks, anisotropic
and wide-stencil operators).

Counterpart of ``spmv_tpu.corpus``, carried across unchanged (host numpy
and ``scipy.spatial.Delaunay``): the same seed gives the reference's matrix
bit for bit. Every generator returns a host ``CSRHost``; the user workflow
is ``rcm_reorder`` -> ``build_dist_matrix(local_format="auto")`` -> solve.
"""
from __future__ import annotations

import numpy as np

from spmv_torch.formats.csr import CSRHost

__all__ = [
    "fem_p1_2d",
    "fem_p1_3d",
    "powerlaw_laplacian",
    "circuit_network",
    "aniso_laplace_2d",
    "stencil27_3d",
    "scramble",
    "CORPUS",
]


def _sym_coo_to_csr(rows, cols, vals, n, dtype) -> CSRHost:
    return CSRHost.from_coo(rows, cols, np.asarray(vals, dtype=dtype), n, n)


def fem_p1_2d(n_nodes: int, seed: int = 0, dtype=np.float32) -> CSRHost:
    """P1 (linear triangle) stiffness matrix on a Delaunay triangulation of
    ``n_nodes`` random points in the unit square, plus a small mass-matrix
    shift (making it SPD without boundary bookkeeping). Row degrees vary
    with the mesh (typically 4..12); the node ordering is the random point
    order — bandwidth is O(n) until RCM fixes it. This is the structure
    class of the reference's real PETSc FEM inputs."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    pts = rng.random((n_nodes, 2))
    tri = Delaunay(pts).simplices  # (m, 3)
    p = pts[tri]  # (m, 3, 2)
    # edge vectors opposite each vertex: e_i = p_k - p_j (cyclic)
    e = p[:, [2, 0, 1], :] - p[:, [1, 2, 0], :]  # (m, 3, 2)
    # 2*area (signed)
    det = e[:, 0, 0] * e[:, 1, 1] - e[:, 0, 1] * e[:, 1, 0]
    area2 = np.abs(det)
    # grad(lambda_i) = rot90(e_i) / (2A); K_ij = A * grad_i . grad_j
    #               = (e_i . e_j) / (4A)  [rotation preserves dots]
    kloc = np.einsum("mid,mjd->mij", e, e) / (2.0 * area2)[:, None, None]
    ii = np.repeat(tri, 3, axis=1).reshape(-1)          # (m*9,)
    jj = np.tile(tri, (1, 3)).reshape(-1)
    vv = kloc.reshape(-1)
    # lumped-mass shift: h^2-scaled identity keeps kappa finite (pure
    # Neumann stiffness is singular)
    mass = np.zeros(n_nodes)
    np.add.at(mass, tri.reshape(-1), np.repeat(area2 / 6.0, 3))
    ii = np.concatenate([ii, np.arange(n_nodes)])
    jj = np.concatenate([jj, np.arange(n_nodes)])
    vv = np.concatenate([vv, mass])
    return _sym_coo_to_csr(ii, jj, vv, n_nodes, dtype)


def fem_p1_3d(n_nodes: int, seed: int = 0, dtype=np.float32) -> CSRHost:
    """P1 tetrahedral stiffness + lumped mass on a 3-D Delaunay mesh of
    random points in the unit cube. Higher and more variable row degrees
    than 2-D (typically 8..30) — the hard case for ELL/WELL padding."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    pts = rng.random((n_nodes, 3))
    tet = Delaunay(pts).simplices  # (m, 4)
    p = pts[tet]  # (m, 4, 3)
    em = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0],
                   p[:, 3] - p[:, 0]], axis=1)  # (m, 3, 3)
    vol6 = np.abs(np.linalg.det(em))
    good = vol6 > 1e-12 * np.median(vol6)  # drop degenerate slivers
    tet, p, em, vol6 = tet[good], p[good], em[good], vol6[good]
    ginv = np.linalg.inv(em)  # columns: grads of lambda_1..3
    g123 = np.transpose(ginv, (0, 2, 1))  # (m, 3grad, 3dim)
    g0 = -g123.sum(axis=1, keepdims=True)
    g = np.concatenate([g0, g123], axis=1)  # (m, 4, 3)
    kloc = np.einsum("mid,mjd->mij", g, g) * (vol6 / 6.0)[:, None, None]
    ii = np.repeat(tet, 4, axis=1).reshape(-1)
    jj = np.tile(tet, (1, 4)).reshape(-1)
    vv = kloc.reshape(-1)
    mass = np.zeros(n_nodes)
    np.add.at(mass, tet.reshape(-1), np.repeat(vol6 / 24.0, 4))
    ii = np.concatenate([ii, np.arange(n_nodes)])
    jj = np.concatenate([jj, np.arange(n_nodes)])
    vv = np.concatenate([vv, mass])
    return _sym_coo_to_csr(ii, jj, vv, n_nodes, dtype)


def powerlaw_laplacian(n: int, m: int = 8, seed: int = 0,
                       dtype=np.float32) -> CSRHost:
    """Graph Laplacian + I of a preferential-attachment (Barabasi-Albert
    style) graph: each new node attaches ``m`` edges to targets sampled
    proportionally to degree. Degree distribution is a power law — a few
    hub rows have thousands of entries while the median row has ~2m. The
    adversarial case for row-uniform formats (ELL padding explodes; WELL's
    per-slot windows and the format auto-select have to cope).

    Vectorized sampling: targets are drawn from the repeated-endpoint list
    (each edge contributes both endpoints -> sampling that list IS
    degree-proportional sampling), in blocks, which preserves the power
    law while staying O(E)."""
    rng = np.random.default_rng(seed)
    src = np.empty(n * m, dtype=np.int64)
    dst = np.empty(n * m, dtype=np.int64)
    # seed clique among the first m+1 nodes (cheap, keeps it connected)
    k = 0
    endpoints = [np.repeat(np.arange(m + 1), 2)]  # rough initial degrees
    block = max(4096, 4 * m)
    node = m + 1
    pool = np.concatenate(endpoints)
    while node < n:
        hi = min(n, node + block // m)
        nb = hi - node
        new = np.repeat(np.arange(node, hi), m)
        # sample from the current endpoint pool (degree-proportional) +
        # a recent-node uniform mix so late blocks still attach locally
        t = pool[rng.integers(0, len(pool), nb * m)]
        # forbid self-loops by redirect to a uniform node
        self_loop = t == new
        t[self_loop] = rng.integers(0, node, int(self_loop.sum()))
        src[k : k + nb * m] = new
        dst[k : k + nb * m] = t
        k += nb * m
        pool = np.concatenate([pool, new, t])
        node = hi
    src, dst = src[:k], dst[:k]
    rows = np.concatenate([src, dst])
    cols = np.concatenate([dst, src])
    ones = np.ones(len(rows))
    deg = np.zeros(n)
    np.add.at(deg, rows, 1.0)
    ii = np.concatenate([rows, np.arange(n)])
    jj = np.concatenate([cols, np.arange(n)])
    vv = np.concatenate([-ones, deg + 1.0])
    a = _sym_coo_to_csr(ii, jj, vv, n, dtype)
    return a


def circuit_network(nx: int, extra_frac: float = 0.05, seed: int = 0,
                    dtype=np.float32) -> CSRHost:
    """Resistor-network conductance matrix: a 2-D grid of random
    conductances plus ``extra_frac * n`` random long-range resistors
    (small-world shortcuts — the via/supply-net structure of circuit
    matrices). SPD and diagonally dominant, but the shortcuts defeat pure
    bandedness: after RCM a small far remainder persists, exercising the
    WELL window-split path."""
    rng = np.random.default_rng(seed)
    n = nx * nx
    i = np.arange(n)
    right = i[(i % nx) != nx - 1]
    down = i[i < n - nx]
    src = np.concatenate([right, down])
    dst = np.concatenate([right + 1, down + nx])
    g = 10.0 ** rng.uniform(-1, 1, len(src))  # 2-decade conductance spread
    ne = int(extra_frac * n)
    es = rng.integers(0, n, ne)
    ed = rng.integers(0, n, ne)
    keep = es != ed
    src = np.concatenate([src, es[keep]])
    dst = np.concatenate([dst, ed[keep]])
    g = np.concatenate([g, 10.0 ** rng.uniform(-2, 0, int(keep.sum()))])
    rows = np.concatenate([src, dst])
    cols = np.concatenate([dst, src])
    deg = np.zeros(n)
    np.add.at(deg, rows, np.concatenate([g, g]))
    ii = np.concatenate([rows, np.arange(n)])
    jj = np.concatenate([cols, np.arange(n)])
    vv = np.concatenate([-np.concatenate([g, g]), deg + 1e-3])
    return _sym_coo_to_csr(ii, jj, vv, n, dtype)


def aniso_laplace_2d(nx: int, eps: float = 100.0,
                     dtype=np.float32) -> CSRHost:
    """Anisotropic 5-point operator -(eps u_xx + u_yy): same sparsity as
    the isotropic Laplacian but a spectrum that breaks isotropic-tuned
    solvers (smoothing/coarsening quality, Chebyshev bounds)."""
    n = nx * nx
    i = np.arange(n)
    right = i[(i % nx) != nx - 1]
    down = i[i < n - nx]
    ii = np.concatenate([right, right + 1, down, down + nx, i])
    jj = np.concatenate([right + 1, right, down + nx, down, i])
    vv = np.concatenate([
        np.full(2 * len(right), -eps),
        np.full(2 * len(down), -1.0),
        np.full(n, 2.0 * eps + 2.0),
    ])
    return _sym_coo_to_csr(ii, jj, vv, n, dtype)


def stencil27_3d(nx: int, dtype=np.float32) -> CSRHost:
    """27-point 3-D stencil (trilinear hex FEM Laplacian weights): 26
    neighbors at -1/26-ish weights, heavier rows than the 7-point star —
    wide-band DIA with 27 diagonals, a different kernel regime (K large,
    window small)."""
    n = nx ** 3
    idx = np.arange(n)
    x = idx % nx
    y = (idx // nx) % nx
    z = idx // (nx * nx)
    rows, cols, vals = [], [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == dy == dz == 0:
                    continue
                m = ((x + dx >= 0) & (x + dx < nx)
                     & (y + dy >= 0) & (y + dy < nx)
                     & (z + dz >= 0) & (z + dz < nx))
                src = idx[m]
                rows.append(src)
                cols.append(src + dx + dy * nx + dz * nx * nx)
                w = -1.0 if (abs(dx) + abs(dy) + abs(dz)) == 1 else (
                    -0.5 if (abs(dx) + abs(dy) + abs(dz)) == 2 else -0.25)
                vals.append(np.full(len(src), w))
    rows.append(idx)
    cols.append(idx)
    deg = np.zeros(n)
    for r, v in zip(rows[:-1], vals):
        np.add.at(deg, r, -v)
    vals.append(deg + 0.1)
    return _sym_coo_to_csr(np.concatenate(rows), np.concatenate(cols),
                           np.concatenate(vals), n, dtype)


def scramble(a: CSRHost, seed: int = 0) -> CSRHost:
    """Random symmetric permutation P A P^T — destroys any ordering
    structure; RCM must rediscover it (the round-trip regression for the
    reorder pipeline)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(a.nrows)
    lens = a.row_nnz()
    rows = perm[np.repeat(np.arange(a.nrows), lens)]
    cols = perm[a.colind]
    return CSRHost.from_coo(rows, cols, a.values, a.nrows, a.ncols,
                            sum_duplicates=False)


# name -> (builder, kwargs, solver) — the standard corpus instance sizes
# (0.9M-2.1M rows each)
CORPUS = {
    "fem2d_1p6M": (fem_p1_2d, {"n_nodes": 1_600_000}, "cg"),
    "fem3d_400k": (fem_p1_3d, {"n_nodes": 400_000}, "cg"),
    "powerlaw_1M": (powerlaw_laplacian, {"n": 1_000_000, "m": 8}, "cg"),
    "circuit_1M": (circuit_network, {"nx": 1000}, "cg"),
    "aniso_1448": (aniso_laplace_2d, {"nx": 1448}, "cg"),
    "stencil27_100": (stencil27_3d, {"nx": 100}, "cg"),
}
