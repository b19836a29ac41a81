"""FSAI — the factorized sparse approximate inverse preconditioner for
SPD operators.

Counterpart of ``spmv_tpu.solvers.fsai`` (Kolotilina & Yeremin 1993): a
sparse lower-triangular G approximating inv(chol(A)), so that

    M^-1 = G^T G   (SPD whenever diag(G) > 0),

and the apply z = G^T (G r) is two SpMVs through the operators' own
kernels, with no triangular solve. FSAI(0): row i of G solves the small SPD
system A[J_i, J_i] g_i = e_i on J_i = {j in pattern(A_i*) : j <= i}, then
g_i <- g_i / sqrt(g_i[i]) makes diag(G A G^T) = 1. The setup is the
reference's vectorized numpy, carried across as it is (one batched dense
solve over all rows), so it gives the reference's G bit for bit.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np

from spmv_torch.formats.csr import CSRHost
from spmv_torch.solvers.spai import _ragged_to_padded


def fsai_setup(a: CSRHost, ridge: float = 1e-12) -> CSRHost:
    """Compute the FSAI(0) factor G (sparse lower triangular, positive
    diagonal, pattern = tril pattern of A incl. the diagonal) such that
    M^-1 = G^T G approximates A^-1 and diag(G A G^T) = 1.

    ``a`` must be square and is ASSUMED symmetric positive definite; only
    its lower triangle is read. ``ridge`` is the relative Tikhonov shift
    on each row's local system (guards structurally singular blocks).

    Pure vectorized numpy — no Python-level per-row loop; same batched
    machinery as ``spai_setup``.
    """
    if a.nrows != a.ncols:
        raise ValueError("FSAI needs a square (SPD) operator")
    n = a.nrows

    # --- J: per-row lower-triangle pattern incl. the diagonal, sorted ---
    rows_all = np.repeat(np.arange(n, dtype=np.int64), a.row_nnz())
    keep = rows_all >= a.colind
    # union with the identity pattern so a structurally-missing diagonal
    # still yields a well-posed local system (value gathered below is then
    # 0 and the ridge takes over)
    pr = np.concatenate([rows_all[keep], np.arange(n, dtype=np.int64)])
    pc = np.concatenate([a.colind[keep].astype(np.int64),
                         np.arange(n, dtype=np.int64)])
    pat = CSRHost.from_coo(pr, pc, np.ones(len(pr)), n, n)  # dedups + sorts
    kc_counts = np.diff(pat.rowptr).astype(np.int64)
    i_of = np.repeat(np.arange(n, dtype=np.int64), kc_counts)
    J_pad, _kc = _ragged_to_padded(i_of, pat.colind.astype(np.int64), n)
    kcmax = J_pad.shape[1]

    # --- gather S[i, r, c] = A[J[i,r], J[i,c]] (sorted-key searchsorted,
    # symmetrized read: fetch (max, min) so only tril(A) need be stored) ---
    a_rows = rows_all
    a_keys = a_rows * n + a.colind.astype(np.int64)
    if len(a_keys) > 1 and np.any(np.diff(a_keys) <= 0):
        srt = np.argsort(a_keys, kind="stable")
        a_keys, a_vals = a_keys[srt], a.values[srt]
    else:
        a_vals = a.values
    r_b = J_pad[:, :, None]                    # (n, kc, 1)
    c_b = J_pad[:, None, :]                    # (n, 1, kc)
    valid = (r_b >= 0) & (c_b >= 0)
    hi = np.maximum(r_b, c_b)
    lo = np.minimum(r_b, c_b)
    q = np.where(valid, hi * n + lo, 0).reshape(-1)
    pos = np.searchsorted(a_keys, q)
    pos = np.minimum(pos, max(len(a_keys) - 1, 0))
    hit = (a_keys[pos] == q) & valid.reshape(-1) if len(a_keys) else \
        np.zeros_like(valid.reshape(-1))
    S = np.where(hit, a_vals[pos] if len(a_vals) else 0.0, 0.0)
    S = S.reshape(n, kcmax, kcmax).astype(np.float64)
    # padded positions: unit diagonal keeps the batched solve non-singular
    pad_c = (J_pad < 0)
    eye = np.eye(kcmax, dtype=bool)[None]
    S[np.broadcast_to(pad_c[:, :, None] & eye, S.shape)] = 0.0
    S += (pad_c[:, :, None] * eye).astype(np.float64)

    # --- rhs: e at the position of i within J_i (its max element) ---
    e = (J_pad == np.arange(n, dtype=np.int64)[:, None]).astype(np.float64)

    # --- relative ridge + one batched solve ---
    diag = np.einsum("bcc->bc", S)
    lam = np.maximum(np.abs(diag).max(axis=1),
                     np.finfo(np.float64).tiny) * ridge
    S = S + lam[:, None, None] * np.eye(kcmax)[None]
    g = np.linalg.solve(S, e[..., None])[..., 0]              # (n, kcmax)

    # --- scale so diag(G A G^T) = 1: g_i /= sqrt(g_i[i]) ---
    d = np.einsum("bc,bc->b", g, e)            # g_i at the diagonal slot
    d = np.maximum(d, np.finfo(np.float64).tiny)
    g = g / np.sqrt(d)[:, None]

    cmask = (J_pad >= 0)
    out_rows = np.repeat(np.arange(n, dtype=np.int64), cmask.sum(axis=1))
    out_cols = J_pad[cmask]
    out_vals = g[cmask].astype(a.values.dtype)
    return CSRHost.from_coo(out_rows, out_cols.astype(np.int64),
                            out_vals, n, n, sum_duplicates=False)


def fsai_preconditioner(A, ridge: float = 1e-12, timings: dict | None = None,
                        **overrides) -> Callable:
    """SPD preconditioner apply ``z = G^T (G r)`` for a ``DistMatrix``: G
    and its cached transpose (``G.transposed()``) as DistMatrix operators
    with A's own shard count, format settings and device (``overrides``
    replace any of those ``build_dist_matrix`` arguments), so each apply is
    two distributed SpMVs through A's kernels; where their layouts pad the
    shards otherwise than A's, the vectors are re-padded between the
    applies. Valid wherever an SPD M^-1 is required (``cg``,
    ``cg_pipelined``, ``minres``). ``apply`` carries (G, G^T) as
    ``apply.operators``; ``timings``, when given, receives the host seconds
    of the "setup" (``fsai_setup``), the "assemble" of G and its
    "transposed" rebuild. Needs the assembly-time host matrix (operators
    from ``build_dist_matrix``)."""
    from spmv_torch.parallel.dist_matrix import build_dist_matrix, relayout

    host = getattr(A, "_host_csr", None)
    if host is None:
        raise ValueError(
            "fsai_preconditioner needs the assembly-time host matrix that "
            "build_dist_matrix keeps; build G yourself via fsai_setup for "
            "hand-assembled operators")
    t0 = time.perf_counter()
    g_host = fsai_setup(host, ridge=ridge)
    t1 = time.perf_counter()
    # G is triangular, not symmetric: the rebuild arguments never carry
    # symmetric storage
    G = build_dist_matrix(g_host, **{**A._rebuild_kwargs, **overrides})
    t2 = time.perf_counter()
    Gt = G.transposed()
    if timings is not None:
        timings.update(setup=t1 - t0, assemble=t2 - t1,
                       transposed=time.perf_counter() - t2)
    nd = A.n_devices

    def apply(r):
        z = G.matvec(relayout(r, G.col_pad, nd))
        z = Gt.matvec(relayout(z, Gt.col_pad, nd))
        return relayout(z, A.row_pad, nd)

    apply.operators = (G, Gt)
    return apply
