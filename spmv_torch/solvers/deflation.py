"""Deflated (recycling) Conjugate Gradient.

Counterpart of ``spmv_tpu.solvers.deflation`` (``cg_deflated`` :41),
def-CG of Saad, Yeung, Erhel & Guyomarc'h '00. For sequences of solves
with one SPD operator, CG deflated against a known d-dimensional subspace
W (approximate bottom eigenvectors from ``lobpcg``, or earlier solutions)
converges at the effective condition number lambda_max / lambda_{d+1}:

    E = W^T A W  (d x d, factorized once)
    x0 <- x0 + W E^-1 W^T r0          Galerkin correction: W^T r0' = 0
    p0 = z0 - W E^-1 (AW)^T z0
    per iteration (on top of PCG):  mu = E^-1 (AW)^T z ;  p = z + beta p - W mu

The extra work of an iteration is two (d, n) products and two d x d
triangular solves against the cached Cholesky factor, on the vectors'
device, and no extra apply (A-symmetry gives W^T A z = (AW)^T z). Set-up
costs d applies. The loop is ``cg``'s: a Python loop with one host sync
per iteration for the convergence test, in ``cg``'s update order.
"""
from __future__ import annotations

from typing import Callable

import torch

from spmv_torch.solvers.cg import CGResult, _dot, _rel


def cg_deflated(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    W: torch.Tensor,
    x0: torch.Tensor | None = None,
    kmax: int = 100,
    rtol: float = 1e-10,
    dot: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
    preconditioner: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> CGResult:
    """Solve SPD ``A x = b`` by CG deflated against the basis ``W``.

    ``W``: (d, *b.shape), d stacked vectors in b's (padded) layout, zero on
    padding rows. They need not be orthonormal, only independent; a
    relative ridge keeps a rank-deficient W from producing NaNs (the
    redundant directions then stop helping).

    Semantics match ``cg``: the convergence test on |r|/|r0| with r0 the
    residual of x0 before the Galerkin correction, an optional SPD
    ``preconditioner``, and ``dot`` (default: the global dot). The
    returned ``r``/``p`` are valid Krylov state for ``cg_deflated`` with
    the same W."""
    if dot is None:
        dot = _dot
    if x0 is None:
        x0 = torch.zeros_like(b)
    precond = preconditioner if preconditioner is not None else (lambda r: r)
    d = W.shape[0]
    if d == 0:
        raise ValueError("empty deflation basis; call cg() instead")
    vshape = b.shape
    Wf = W.reshape(d, -1)
    fi = torch.finfo(b.dtype)

    # set-up: AW (d applies), E = W^T A W, its Cholesky factor once
    AW = torch.stack([matvec(W[i]).reshape(-1) for i in range(d)])
    E = Wf @ AW.T
    E = 0.5 * (E + E.T)
    # a relative ridge: a rank-deficient W degrades gracefully, never NaN
    jitter = fi.eps * torch.clamp(torch.max(torch.abs(torch.diagonal(E))), min=fi.tiny)
    L = torch.linalg.cholesky_ex(E + jitter * torch.eye(d, dtype=E.dtype, device=E.device))[0]

    def esolve(y):                      # E^-1 y through the cached factor
        return torch.cholesky_solve(y[:, None], L)[:, 0]

    def wapply(coef):                   # W @ coef in b's layout
        return (coef @ Wf).reshape(vshape)

    def project_p(z, p_prev, beta):
        # p = z + beta p - W E^-1 (AW)^T z, A-conjugate to W
        return z + beta * p_prev - wapply(esolve(AW @ z.reshape(-1)))

    # the Galerkin correction: W^T r0 = 0
    r_pre = b - matvec(x0)
    gamma = esolve(Wf @ r_pre.reshape(-1))
    x = x0 + wapply(gamma)
    r = r_pre - (gamma @ AW).reshape(vshape)
    z = precond(r)
    p = project_p(z, torch.zeros_like(b), torch.zeros((), dtype=b.dtype, device=b.device))
    rho = dot(r, z)
    rnorm2 = dot(r, r)
    # rtol relative to the residual before the correction: the same meaning
    # as in an undeflated cg() from the same x0
    rnorm0 = torch.sqrt(dot(r_pre, r_pre))
    eps = fi.tiny
    k = 0
    while k < kmax and bool(_rel(rnorm2, rnorm0, eps) >= rtol):
        ap = matvec(p)
        alpha = rho / dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        # the Galerkin correction again each iteration: zero in exact
        # arithmetic, but in float32 the W-component leaking into r grows
        # along the deflated directions and diverges on approximate bases
        # (the reference measured rel. residual 6.8 without it)
        gamma = esolve(Wf @ r.reshape(-1))
        x = x + wapply(gamma)
        r = r - (gamma @ AW).reshape(vshape)
        z = precond(r)
        rho_new = dot(r, z)
        beta = rho_new / rho
        p = project_p(z, p, beta)
        rnorm2 = dot(r, r) if preconditioner is not None else rho_new
        rho = rho_new
        k += 1
    rnorm = torch.sqrt(rnorm2)
    return CGResult(x=x, iterations=k, rnorm=rnorm, rnorm0=rnorm0,
                    converged=bool(_rel(rnorm2, rnorm0, eps) < rtol), r=r, p=p)
