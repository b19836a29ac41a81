"""Bandwidth-reduction reordering (reverse Cuthill-McKee) + permutation.

Counterpart of ``spmv_tpu.reorder``, numpy tier only: the orders and
permuted matrices equal the reference's ``native=False`` results bit for
bit (the reference's native C++ tier gives the same bits, faster; it is
still to port, ROADMAP.md). The windowed WELL format and the DIA kernels
are window-local, so concentrating nonzeros near the diagonal shrinks
their x-windows and slot counts.

The BFS expands one level at a time (vectorized multi-slice gathers via
repeat/cumsum), with no per-node Python loop.
"""
from __future__ import annotations

import numpy as np

from spmv_torch.formats.csr import CSRHost


def bandwidth(a: CSRHost) -> int:
    """max |col - row| over stored entries (0 for diagonal/empty)."""
    if a.nnz == 0:
        return 0
    rows = np.repeat(np.arange(a.nrows, dtype=np.int64), a.row_nnz())
    return int(np.abs(a.colind.astype(np.int64) - rows).max())


def _neighbors_of(
    rowptr: np.ndarray, colind: np.ndarray, frontier: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Concatenated adjacency of all frontier nodes (vectorized multi-slice):
    returns (neighbor cols, index of the frontier parent per neighbor).
    ``rowptr``/``colind`` must be int64."""
    starts = rowptr[frontier]
    cnt = rowptr[frontier + 1] - starts
    total = int(cnt.sum())
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    shift = np.repeat(starts - np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt)
    nbr = colind[np.arange(total, dtype=np.int64) + shift]
    parent = np.repeat(np.arange(len(frontier), dtype=np.int64), cnt)
    return nbr, parent


def reverse_cuthill_mckee(a: CSRHost) -> np.ndarray:
    """RCM ordering of a structurally symmetric square matrix's graph.

    Returns ``order`` such that new row i is old row ``order[i]``. Matrices
    with non-symmetric structure still get a valid permutation (BFS runs on
    the out-edges); symmetrize first (A + A^T pattern) for best bandwidth.
    """
    if a.nrows != a.ncols:
        raise ValueError("RCM needs a square matrix")
    n = a.nrows
    rowptr64 = np.ascontiguousarray(a.rowptr, dtype=np.int64)
    colind64 = np.ascontiguousarray(a.colind, dtype=np.int64)
    deg = a.row_nnz().astype(np.int64)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    deg_sorted = np.argsort(deg, kind="stable")  # start nodes: min degree
    ptr = 0
    while pos < n:
        while visited[deg_sorted[ptr]]:
            ptr += 1
        start = deg_sorted[ptr]
        visited[start] = True
        order[pos] = start
        pos += 1
        frontier = np.array([start], dtype=np.int64)
        while True:
            nbr, parent = _neighbors_of(rowptr64, colind64, frontier)
            mask = ~visited[nbr] if len(nbr) else np.empty(0, bool)
            nbr, parent = nbr[mask], parent[mask]
            if len(nbr) == 0:
                break
            # classic CM tie-breaking: group by parent's position in the
            # frontier, then ascending degree; first occurrence wins
            k = np.lexsort((deg[nbr], parent))
            nbr = nbr[k]
            _, first = np.unique(nbr, return_index=True)
            new = nbr[np.sort(first)]
            visited[new] = True
            order[pos : pos + len(new)] = new
            pos += len(new)
            frontier = new
    return order[::-1].copy()  # the "reverse" in RCM


def permute_symmetric(a: CSRHost, order: np.ndarray) -> CSRHost:
    """B[i, j] = A[order[i], order[j]] — simultaneous row+col permutation
    (preserves symmetry/SPD-ness, so CG on B solves the permuted system).
    One sort over packed (row*ncols + col) int64 keys."""
    inv = np.empty(len(order), dtype=np.int64)
    inv[order] = np.arange(len(order), dtype=np.int64)
    rows = np.repeat(np.arange(a.nrows, dtype=np.int64), a.row_nnz())
    key = inv[rows] * np.int64(a.ncols) + inv[a.colind.astype(np.int64)]
    k = np.argsort(key)  # keys are unique -> stability irrelevant
    ks = key[k]
    new_rows = (ks // a.ncols).astype(np.int64)
    rowptr = np.zeros(a.nrows + 1, dtype=np.int64)
    np.cumsum(np.bincount(new_rows, minlength=a.nrows), out=rowptr[1:])
    return CSRHost(rowptr, (ks % a.ncols).astype(np.int32), a.values[k],
                   a.ncols)


def bandwidth_quantile(a: CSRHost, q: float = 90.0,
                       sample: int = 2_000_000) -> float:
    """q-th percentile of |col - row| over (sampled) entries — the
    window-locality figure the windowed formats care about (a handful of
    outliers belong in the far remainder; the BULK must be near the
    diagonal, which max-bandwidth cannot see)."""
    if a.nnz == 0:
        return 0.0
    if a.nnz > sample:
        idx = np.arange(0, a.nnz, a.nnz // sample, dtype=np.int64)
    else:
        idx = np.arange(a.nnz, dtype=np.int64)
    rows = np.searchsorted(a.rowptr, idx, side="right") - 1
    return float(np.percentile(
        np.abs(a.colind[idx].astype(np.int64) - rows), q))


def rcm_reorder(a: CSRHost,
                keep_best: bool = False) -> tuple[CSRHost, np.ndarray]:
    """Symmetrize the pattern, compute RCM on it, and return (permuted
    matrix, order). ``order`` maps new->old; apply to vectors with
    x_new = x_old[order], and undo with y_old = y_new[inverse].

    ``keep_best=True``: compare the bulk window locality
    (``bandwidth_quantile`` p90) before and after and return the identity
    ordering when RCM made it worse — BFS orderings can destroy an
    already-structured matrix whose long-range edges span the graph."""
    if a.nrows != a.ncols:
        raise ValueError("rcm_reorder needs a square matrix")
    if keep_best:
        b, order = rcm_reorder(a, keep_best=False)
        if bandwidth_quantile(b) < bandwidth_quantile(a):
            return b, order
        return a, np.arange(a.nrows, dtype=np.int64)
    rows = np.repeat(np.arange(a.nrows, dtype=np.int64), a.row_nnz())
    cols = a.colind.astype(np.int64)
    # pattern-only symmetrization via one sorted-unique pass over packed
    # (row*ncols + col) keys; values are irrelevant for the BFS, int8 ones
    # keep the footprint small
    n64 = np.int64(a.ncols)
    keys = np.concatenate([rows * n64 + cols, cols * n64 + rows])
    keys.sort()
    if len(keys):
        keep = np.empty(len(keys), dtype=bool)
        keep[0] = True
        np.not_equal(keys[1:], keys[:-1], out=keep[1:])
        keys = keys[keep]
    sym_rows = (keys // n64).astype(np.int64)
    rowptr = np.zeros(a.nrows + 1, dtype=np.int64)
    np.cumsum(np.bincount(sym_rows, minlength=a.nrows), out=rowptr[1:])
    sym = CSRHost(rowptr, (keys % n64).astype(np.int32),
                  np.ones(len(keys), dtype=np.int8), a.ncols)
    order = reverse_cuthill_mckee(sym)
    return permute_symmetric(a, order), order
