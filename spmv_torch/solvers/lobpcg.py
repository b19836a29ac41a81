"""LOBPCG block eigensolver: the smallest (or largest) eigenpairs of a
symmetric operator.

Counterpart of ``spmv_tpu.solvers.lobpcg`` (``LOBPCGResult``,
``default_block_ops`` :67, ``lane_block_ops`` :75, ``_whiten_map`` :100,
``lobpcg`` :111), Knyazev's LOBPCG. The hot operation is a block apply
A @ X: on DIA operators ``DistMatrix.matmat`` runs the block kernels
(``dia_spmm``, ``dia_sym_spmm``), which read the matrix once for the
block. Everything else is small dense algebra on (3k, 3k) Grams.

The reference keeps the loop in a ``lax.while_loop``; here it is a Python
loop. The Grams and the block combinations run on the vectors' device
(``block_dot``, ``combine``, ``colscale``, injectable so the same loop
serves (n, k) blocks and the SpMM lane layout); each Gram is read to the
host, where the whitening eigendecompositions and the Rayleigh-Ritz
eigenproblem run in numpy in the vectors' dtype: three reads in a
Rayleigh-Ritz step and one for the residual norms, four host syncs an
iteration. Every Gram and combination is a float32 product at full
precision (TF32 stays off: ``NEXT.md:142-143``; the reference forces
``Precision.HIGHEST`` for the TPU's MXU).

Basis conditioning is the reference's static-shape treatment: the [X W P]
Gram is eigendecomposed, directions below a relative cutoff are zeroed in
the whitening map, and their Ritz values are pushed past the spectrum so
Rayleigh-Ritz never selects them (the first iteration's P = 0 block is
such a direction).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from spmv_torch.formats.dia import LANES
from spmv_torch.ops.spmm_dia import spmm_from_layout, to_lanes


@dataclasses.dataclass
class LOBPCGResult:
    eigenvalues: np.ndarray   # (k,) Ritz values, ascending in smallest mode
    X: torch.Tensor           # (n, k) / lane-layout Ritz vectors, orthonormal
    iterations: int
    resid_norms: np.ndarray   # (k,) |A x_j - theta_j x_j|
    converged: bool           # every column below tol


def default_block_ops():
    """Device primitives for (n, k) blocks: (block_dot, combine, colscale)."""
    def block_dot(X, Y):
        return X.T @ Y

    def combine(X, C):
        return X @ C

    def colscale(X, s):
        return X * s[None, :]

    return block_dot, combine, colscale


def lane_block_ops():
    """Device primitives for the stacked SpMM lane layout (rows, k*128),
    the layout of ``DistMatrix.to_dist_block`` and ``matmat``: column r is
    lanes [r*128, (r+1)*128) (``ops/spmm_dia.spmm_from_layout`` /
    ``to_lanes``). Padding rows are zero, so the Grams are exact."""
    def cols(X):
        return spmm_from_layout(X, X.shape[1] // LANES)

    def block_dot(X, Y):
        return cols(X).T @ cols(Y)

    def combine(X, C):
        return to_lanes(cols(X) @ C)

    def colscale(X, s):
        k = X.shape[1] // LANES
        return (X.reshape(X.shape[0], k, LANES) * s[None, :, None]).reshape(X.shape)

    return block_dot, combine, colscale


def _whiten_map(G: np.ndarray, rtol_rank) -> tuple[np.ndarray, np.ndarray]:
    """M with (S M) orthonormal on the well-conditioned subspace of S
    (G = S^T S): an eigh inverse square root with sub-cutoff directions
    zeroed. Returns (M, good), good marking the kept columns. Host numpy."""
    w, V = np.linalg.eigh((G + G.T) / 2)
    wmax = max(w[-1], np.finfo(G.dtype).tiny)
    good = w > rtol_rank * wmax
    inv = np.where(good, 1 / np.sqrt(np.where(good, w, 1)), 0).astype(w.dtype)
    return V * inv[None, :], good


def lobpcg(
    matmat: Callable[[torch.Tensor], torch.Tensor],
    X0: torch.Tensor,
    k: int | None = None,
    maxiter: int = 200,
    tol: float = 1e-8,
    preconditioner: Callable[[torch.Tensor], torch.Tensor] | None = None,
    largest: bool = False,
    block_ops=None,
) -> LOBPCGResult:
    """The ``k`` smallest (``largest=True``: largest) eigenpairs of
    symmetric A, where ``matmat`` applies A to a block.

    ``X0``: the initial block, (n, k) in the dense layout or (rows, k*128)
    in the lane layout (``block_ops=lane_block_ops()``, and then ``k`` is
    required); random is fine. Padding rows must be zero and stay zero
    under ``matmat``. Converged when every column has
    |A x - theta x| <= tol * max|theta|.
    """
    if block_ops is None:
        block_dot, combine, colscale = default_block_ops()
        if k is None:
            k = X0.shape[1]
    else:
        block_dot, combine, colscale = block_ops
        if k is None:
            raise ValueError(
                "k must be given explicitly with custom block_ops (the "
                "column count is not recoverable from a custom layout)")
    dt = torch.empty(0, dtype=X0.dtype).numpy().dtype
    rdt = np.finfo(dt).dtype
    rtol_rank = np.finfo(rdt).eps * 100
    tiny = np.finfo(rdt).tiny
    sgn = -1.0 if largest else 1.0  # select ascending on sgn * spectrum

    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    def dev(arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(arr), device=X0.device)

    def rayleigh_ritz(S, AS):
        """Whiten S twice (the second pass acts on a Gram already near I,
        so its error is ~eps where one pass leaves eps * cond(G), enough to
        push Ritz values outside the spectrum), solve the projected
        problem, and return the k best Ritz pairs: (theta, Cx, So, ASo)."""
        M1, _good1 = _whiten_map(host(block_dot(S, S)), rtol_rank)
        S1, AS1 = combine(S, dev(M1)), combine(AS, dev(M1))
        M2, good = _whiten_map(host(block_dot(S1, S1)), rtol_rank)
        So, ASo = combine(S1, dev(M2)), combine(AS1, dev(M2))
        T = host(block_dot(So, ASo))
        T = (T + T.T) / 2
        # masked directions: a sentinel beyond any Ritz value of the kept
        # subspace, scaled from the data
        big = (np.abs(T).sum() + 1) * 10
        T = np.where(good[:, None] & good[None, :], T, 0).astype(dt)
        T = T + np.diag(np.where(good, 0, sgn * big)).astype(dt)
        w, C = np.linalg.eigh(sgn * T)
        return (sgn * w[:k]).astype(rdt), C[:, :k], So, ASo

    def colnorms(Y) -> torch.Tensor:
        return torch.sqrt(torch.clamp(torch.diagonal(block_dot(Y, Y)).real, min=0))

    def scale(th) -> float:
        return max(np.max(np.abs(th)), tiny)

    AX0 = matmat(X0)
    theta, Cx, So, ASo = rayleigh_ritz(X0, AX0)
    X, AX = combine(So, dev(Cx)), combine(ASo, dev(Cx))
    P, AP = torch.zeros_like(X), torch.zeros_like(X)
    resid = host(colnorms(AX - colscale(X, dev(theta))))
    it = 0
    while it < maxiter and not np.all(resid <= tol * scale(theta)):
        R = AX - colscale(X, dev(theta))
        W = preconditioner(R) if preconditioner is not None else R
        # normalize W and P: their columns shrink as the pairs converge,
        # and a tiny column would fall under the whitening cutoff and floor
        # the residual at ~sqrt(cutoff); the spans do not change
        W = colscale(W, 1 / torch.clamp(colnorms(W), min=tiny))
        pn = colnorms(P)
        pscale = torch.where(pn > tiny, 1 / torch.clamp(pn, min=tiny), torch.zeros_like(pn))
        P, AP = colscale(P, pscale), colscale(AP, pscale)
        S = torch.cat([X, W, P], dim=1)
        AS = torch.cat([AX, matmat(W), AP], dim=1)
        theta, Cx, So, ASo = rayleigh_ritz(S, AS)
        X, AX = combine(So, dev(Cx)), combine(ASo, dev(Cx))
        # the implicit-difference directions: the W and P part of the new X
        Cp = Cx.copy()
        Cp[:k] = 0
        P, AP = combine(So, dev(Cp)), combine(ASo, dev(Cp))
        resid = host(colnorms(AX - colscale(X, dev(theta))))
        it += 1
    return LOBPCGResult(eigenvalues=theta, X=X, iterations=it, resid_norms=resid,
                        converged=bool(np.all(resid <= tol * scale(theta))))
