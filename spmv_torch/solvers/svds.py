"""svds — leading singular triplets of a (rectangular) sparse operator via
Golub-Kahan-Lanczos bidiagonalization.

Counterpart of ``spmv_tpu.solvers.svds`` (``gk_factorization`` :46,
``SVDSResult`` :139, ``svds`` :147). The split is the reference's:
- the factorization (the matvec/rmatvec applies and CGS2 full
  reorthogonalization of both bases as masked matmuls) runs on the
  vectors' device as a Python loop with no host sync: breakdown is a
  device flag, and from the breakdown step on alpha/beta are exact zeros
  and the basis rows are zero, as the reference's ``lax.scan`` leaves them;
- the extraction (the SVD of the small (t+1, t) lower bidiagonal B) runs
  on the host in numpy after one read of alpha and beta.

m steps from u_1 = b0/|b0| give A V_m = U_{m+1} B_m and
A^T U_{m+1} = V_m B_m^T + alpha_{m+1} v_{m+1} e_{m+1}^T, so a Ritz triplet
(s, u = U p, v = V q) of B_m has A v - s u = 0 in the Krylov frame and
|A^T u - s v| = alpha_{m+1} |p_{m+1}|, the certificate returned per triplet.

The reference applies A^T to u_1 once to learn the column side's shape
and leaves the duplicate apply to XLA to drop; here that apply is step
0's, so a factorization is exactly 2m + 1 applies: m of A and m + 1 of
A^T (the last for the certificate).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


def _rdtype(t: torch.Tensor) -> torch.dtype:
    return t.real.dtype if t.is_complex() else t.dtype


def _gk(matvec, rmatvec, b0: torch.Tensor, m: int):
    """The factorization; returns gk_factorization's tuple and the column
    side's vector shape."""
    cdtype, rdtype, dev = b0.dtype, _rdtype(b0), b0.device
    fi = torch.finfo(b0.dtype)
    tiny = torch.tensor(fi.tiny, dtype=rdtype, device=dev)
    # breakdown threshold relative to the running operator scale; 64 eps
    # absorbs the eps*sqrt(n) reorthogonalization noise floor
    releps = torch.tensor(fi.eps, dtype=rdtype, device=dev) * 64
    ushape, nu = b0.shape, b0.numel()

    def rnorm(w):
        return torch.sqrt(torch.vdot(w, w).real.to(rdtype))

    def orth(basis, w, mask):
        # CGS2 against the masked prefix of a basis
        for _ in range(2):
            proj = (basis.conj() @ w) * mask
            w = w - proj @ basis
        return w

    beta1 = rnorm(b0.reshape(nu))
    u0 = (b0 / torch.maximum(beta1, tiny).to(cdtype)).reshape(nu)
    w0 = rmatvec(u0.reshape(ushape))          # step 0's A^T u_1
    vshape, nv = w0.shape, w0.numel()
    U = torch.zeros((m + 1, nu), dtype=cdtype, device=dev)
    U[0] = u0
    V = torch.zeros((m, nv), dtype=cdtype, device=dev)
    iv = torch.arange(m, device=dev)
    iu = torch.arange(m + 1, device=dev)
    live = torch.ones((), dtype=torch.bool, device=dev)
    # amax = running max(alpha, beta): the operator scale. On an exactly
    # rank-deficient operator the post-reorthogonalization residual is
    # rounding noise ~ eps*sigma_max*sqrt(n), invisible at a local scale.
    amax = torch.zeros((), dtype=rdtype, device=dev)
    alphas, betas = [], []
    for j in range(m):
        # v-step: alpha_j v_j = orth(A^T u_j against V[:j])
        w = (w0 if j == 0 else rmatvec(U[j].reshape(ushape))).reshape(nv)
        w = orth(V, w, (iv < j).to(cdtype))
        alpha = rnorm(w)
        live_v = live & ~(alpha <= torch.maximum(releps * amax, tiny * 4))
        vj = torch.where(live_v, w / torch.maximum(alpha, tiny).to(cdtype),
                         torch.zeros_like(w))
        V[j] = vj
        amax = torch.maximum(amax, torch.where(live_v, alpha, amax))
        # u-step: beta_{j+1} u_{j+1} = orth(A v_j against U[:j+1])
        p = matvec(vj.reshape(vshape)).reshape(nu)
        p = orth(U, p, (iu <= j).to(cdtype))
        beta = rnorm(p)
        live_u = live_v & ~(beta <= torch.maximum(releps * amax, tiny * 4))
        U[j + 1] = torch.where(live_u, p / torch.maximum(beta, tiny).to(cdtype),
                               torch.zeros_like(p))
        amax = torch.maximum(amax, torch.where(live_u, beta, amax))
        # a dead process emits exact zeros, so the host extraction truncates
        alphas.append(torch.where(live_v, alpha, torch.zeros_like(alpha)))
        betas.append(torch.where(live_u, beta, torch.zeros_like(beta)))
        live = live_u
    # certificate: alpha_{m+1} = |orth(A^T u_{m+1} against V)|
    w = rmatvec(U[m].reshape(ushape)).reshape(nv)
    w = orth(V, w, torch.ones(m, dtype=cdtype, device=dev))
    alpha_cert = torch.where(live, rnorm(w), torch.zeros((), dtype=rdtype, device=dev))
    return (torch.stack(alphas), torch.stack(betas), alpha_cert, U, V), vshape


def gk_factorization(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    rmatvec: Callable[[torch.Tensor], torch.Tensor],
    b0: torch.Tensor,
    m: int = 48,
):
    """m-step Golub-Kahan bidiagonalization with full CGS2
    reorthogonalization of both bases. Returns ``(alpha, beta, alpha_cert,
    U, V)`` on b0's device: alpha (m,) the diagonal of B, beta (m,) its
    subdiagonal, alpha_cert the trailing alpha_{m+1}, U (m+1, row_size) and
    V (m, col_size) the flat orthonormal bases. ``b0`` is a row-space
    vector, nonzero and zero on any padding rows. On breakdown at step j
    the remaining alpha/beta entries are exact zeros."""
    return _gk(matvec, rmatvec, b0, m)[0]


@dataclasses.dataclass
class SVDSResult:
    s: np.ndarray              # (k,) singular-value estimates, descending
    u: torch.Tensor | None     # (k, *row_shape) left Ritz vectors
    v: torch.Tensor | None     # (k, *col_shape) right Ritz vectors
    residuals: np.ndarray      # (k,) |A^T u_i - s_i v_i| certificates
    steps: int                 # bidiagonalization steps that carry information


def svds(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    rmatvec: Callable[[torch.Tensor], torch.Tensor],
    b0: torch.Tensor,
    k: int = 6,
    m: int = 48,
    compute_vectors: bool = True,
) -> SVDSResult:
    """Estimate the ``k`` largest singular triplets of the operator behind
    ``matvec``/``rmatvec`` from an m-step Golub-Kahan run started at the
    row-space vector ``b0``.

    For a ``DistMatrix`` pass ``A.as_linear_operator()`` and
    ``A.transposed().as_linear_operator()``, with
    ``b0 = A.to_dist(b, side="row")``. Each triplet carries the certificate
    |A^T u_i - s_i v_i| = alpha_{m+1} |p_i[m]|, floored at eps * sigma_0
    (a converged triplet's true residual bottoms out at working
    precision). Extreme singular values converge first."""
    (alpha, beta, alpha_cert, U, V), vshape = _gk(matvec, rmatvec, b0, m)
    alpha = alpha.cpu().numpy().astype(np.float64)
    beta = beta.cpu().numpy().astype(np.float64)
    cert = float(alpha_cert)

    # the informative prefix: up to the first exact-zero alpha (no new right
    # vector); a zero beta[t-1] only means the left space closed
    nz = np.nonzero(alpha == 0.0)[0]
    t = int(nz[0]) if len(nz) else m
    if t == 0:
        raise ValueError("gk breakdown at step 0: b0 is zero or A^T b0 = 0")
    B = np.zeros((t + 1, t))
    B[np.arange(t), np.arange(t)] = alpha[:t]
    B[np.arange(1, t + 1), np.arange(t)] = beta[:t]
    P, s, Qt = np.linalg.svd(B, full_matrices=False)   # P (t+1, t), Qt (t, t)
    if t < m:
        cert = 0.0  # breakdown: the block is an exact invariant subspace
    kk = min(k, t)
    floor = float(torch.finfo(U.dtype).eps) * (s[0] if len(s) else 0.0)
    resid = np.maximum(cert * np.abs(P[t, :kk]), floor)

    u_out = v_out = None
    if compute_vectors:
        Pk = torch.as_tensor(P[:, :kk], device=U.device).to(U.dtype)     # (t+1, kk)
        Qk = torch.as_tensor(Qt[:kk, :].T.copy(), device=V.device).to(V.dtype)  # (t, kk)
        u_out = (Pk.T @ U[: t + 1]).reshape((kk,) + tuple(b0.shape))
        v_out = (Qk.T @ V[:t]).reshape((kk,) + tuple(vshape))
    return SVDSResult(s=s[:kk], u=u_out, v=v_out, residuals=np.asarray(resid), steps=t)
