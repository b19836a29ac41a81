"""SPAI — the sparse approximate inverse preconditioner on a static
pattern.

Counterpart of ``spmv_tpu.solvers.spai`` (Grote & Huckle 1997): choose a
pattern for M and minimize

    ||A M - I||_F^2  =  sum_j || A m_j - e_j ||_2^2,

one small least-squares problem per column, independent of the others.
The apply z = M r is one more distributed SpMV, through the operator's own
kernels. The setup is the reference's vectorized numpy, carried across as
it is (pattern unions flattened with cumsum/repeat, one lexsort dedup, a
sorted-key searchsorted gather, one batched normal-equations solve in
float64 with a relative ridge), so it gives the reference's M bit for bit.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np

from spmv_torch.formats.csr import CSRHost, csr_matmul


def _ragged_to_padded(seg: np.ndarray, val: np.ndarray, n: int):
    """(segment_id, value) pairs, seg sorted ascending -> (n, width) padded
    int array (pad = -1) + per-segment counts."""
    counts = np.bincount(seg, minlength=n)
    width = max(int(counts.max()) if len(counts) else 0, 1)
    out = np.full((n, width), -1, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(seg)) - starts[seg]
    out[seg, pos] = val
    return out, counts


def spai_setup(a: CSRHost, ridge: float = 1e-12,
               pattern_level: int = 1) -> CSRHost:
    """Compute the SPAI approximate inverse M minimizing ||A M - I||_F
    column-wise over a static pattern. Returns M as a host CSR in A's
    dtype; ``ridge`` is the RELATIVE Tikhonov shift on each column's normal
    equations (keeps structurally singular columns at zero).

    ``pattern_level=1`` uses pattern(A) (the SPAI(0/1) choice);
    ``pattern_level=2`` uses pattern(|A|^2 + |A|) — a denser, stronger M
    for weakly dominant or badly scaled operators (the standard pattern-
    augmentation step; setup and apply cost grow with the squared pattern).

    Pure vectorized numpy — no Python-level per-column loop; the lexsort
    dedup of the candidate rows is most of its time."""
    if a.nrows != a.ncols:
        raise ValueError("SPAI needs a square operator")
    if pattern_level not in (1, 2):
        raise ValueError("pattern_level must be 1 or 2")
    n = a.nrows
    at = a.transpose()  # at row j = pattern/values of A's column j
    if pattern_level == 2:
        aa = CSRHost(a.rowptr, a.colind, np.abs(a.values), a.ncols)
        p2 = csr_matmul(aa, aa)
        # |A|^2 + |A| pattern, then transpose for column access
        rows = np.concatenate([
            np.repeat(np.arange(n, dtype=np.int64), np.diff(p2.rowptr)),
            np.repeat(np.arange(n, dtype=np.int64), np.diff(a.rowptr))])
        cols = np.concatenate([p2.colind, a.colind]).astype(np.int64)
        vals = np.ones(len(cols))
        pt = CSRHost.from_coo(rows, cols, vals, n, n).transpose()
    else:
        pt = at  # pattern(A) columns = at rows

    # --- J: M's column patterns, padded (n, kc) ---
    kc_counts = np.diff(pt.rowptr).astype(np.int64)
    j_of = np.repeat(np.arange(n, dtype=np.int64), kc_counts)
    J_pad, kc = _ragged_to_padded(j_of, pt.colind.astype(np.int64), n)

    # --- I: per-column union of the row patterns of A[:, J] ---
    # candidates: for every (j, jj in J_j) pair, all rows of A's column jj
    jj_flat = pt.colind.astype(np.int64)       # in j-major order
    seg_pair = j_of                            # candidate's owning column j
    starts = at.rowptr[jj_flat].astype(np.int64)
    lens = (at.rowptr[jj_flat + 1] - at.rowptr[jj_flat]).astype(np.int64)
    total = int(lens.sum())
    off = np.concatenate([[0], np.cumsum(lens)[:-1]])
    idx = np.arange(total, dtype=np.int64) - np.repeat(off, lens) + np.repeat(
        starts, lens)
    cand_i = at.colind.astype(np.int64)[idx]   # candidate row index
    seg_j = np.repeat(seg_pair, lens)          # candidate's column j
    # dedup (j, i) pairs with one global lexsort
    order = np.lexsort((cand_i, seg_j))
    sj, si = seg_j[order], cand_i[order]
    keep = np.empty(len(sj), dtype=bool)
    keep[:1] = True
    keep[1:] = (sj[1:] != sj[:-1]) | (si[1:] != si[:-1])
    I_pad, ri = _ragged_to_padded(sj[keep], si[keep], n)

    rmax, kcmax = I_pad.shape[1], J_pad.shape[1]

    # --- gather S[j, r, c] = A[I[j,r], J[j,c]] via sorted-key searchsorted ---
    row_of_nnz = np.repeat(np.arange(n, dtype=np.int64), np.diff(a.rowptr))
    a_keys = row_of_nnz * n + a.colind.astype(np.int64)
    if len(a_keys) > 1 and np.any(np.diff(a_keys) <= 0):
        srt = np.argsort(a_keys, kind="stable")
        a_keys, a_vals = a_keys[srt], a.values[srt]
    else:
        a_vals = a.values
    i_b = I_pad[:, :, None]                    # (n, rmax, 1)
    c_b = J_pad[:, None, :]                    # (n, 1, kcmax)
    valid = (i_b >= 0) & (c_b >= 0)
    q = np.where(valid, i_b * n + c_b, 0).reshape(-1)
    pos = np.searchsorted(a_keys, q)
    pos = np.minimum(pos, len(a_keys) - 1)
    hit = (a_keys[pos] == q) & valid.reshape(-1)
    S = np.where(hit, a_vals[pos], 0.0).reshape(n, rmax, kcmax)
    S = S.astype(np.float64)

    # --- rhs e_j and one batched normal-equations solve in f64 ---
    e = (I_pad == np.arange(n)[:, None]).astype(np.float64)   # (n, rmax)
    gram = np.einsum("brc,brd->bcd", S, S)                    # (n, kc, kc)
    rhs = np.einsum("brc,br->bc", S, e)                       # (n, kc)
    diag = np.einsum("bcc->bc", gram)
    lam = np.maximum(diag.max(axis=1), np.finfo(np.float64).tiny) * ridge
    gram += (lam[:, None, None] + 0.0) * np.eye(kcmax)[None]
    m = np.linalg.solve(gram, rhs[..., None])[..., 0]         # (n, kcmax)

    # --- assemble M: column j holds m[j, c] at rows J[j, c] ---
    cmask = J_pad >= 0
    rows = J_pad[cmask]
    cols = np.repeat(np.arange(n, dtype=np.int64), cmask.sum(axis=1))
    vals = m[cmask].astype(a.values.dtype)
    return CSRHost.from_coo(rows.astype(np.int64),
                            cols.astype(np.int64), vals, n, n)


def spai_preconditioner(A, ridge: float = 1e-12, pattern_level: int = 1,
                        timings: dict | None = None, **overrides) -> Callable:
    """SPAI preconditioner for a ``DistMatrix``: ``apply(r) = M r``, M the
    approximate inverse on A's pattern, built as a DistMatrix with A's own
    shard count, format settings and device (``overrides`` replace any of
    those ``build_dist_matrix`` arguments), so the apply is one distributed
    SpMV through A's kernels; where M's layout pads the shards otherwise
    than A's, the vectors are re-padded on the way in and out. ``apply``
    carries M as ``apply.operators``; ``timings``, when given, receives the
    host seconds of the "setup" (``spai_setup``) and the "assemble". Needs
    the assembly-time host matrix (operators from ``build_dist_matrix``)."""
    from spmv_torch.parallel.dist_matrix import build_dist_matrix, relayout

    host = getattr(A, "_host_csr", None)
    if host is None:
        raise ValueError(
            "spai_preconditioner needs the assembly-time host matrix that "
            "build_dist_matrix keeps; build M yourself via spai_setup for "
            "hand-assembled operators")
    t0 = time.perf_counter()
    m_host = spai_setup(host, ridge=ridge, pattern_level=pattern_level)
    t1 = time.perf_counter()
    # the rebuild arguments never carry symmetric storage, which is right
    # here: M is not symmetric even when A is
    M = build_dist_matrix(m_host, **{**A._rebuild_kwargs, **overrides})
    if timings is not None:
        timings.update(setup=t1 - t0, assemble=time.perf_counter() - t1)
    nd = A.n_devices

    def apply(r):
        return relayout(M.matvec(relayout(r, M.col_pad, nd)), A.row_pad, nd)

    apply.operators = (M,)
    return apply
