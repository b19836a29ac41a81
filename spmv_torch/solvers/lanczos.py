"""Lanczos extreme-eigenvalue estimation (SPD operators).

Counterpart of ``spmv_tpu.solvers.lanczos``. A short Lanczos run with full
(CGS2) reorthogonalization estimates lambda_min/lambda_max of the operator
behind ``matvec`` for the cost of ``m`` applies; ``chebyshev_bounds``
(solvers/chebyshev.py) turns them into a safe spectrum enclosure.

The loop runs on the vectors' device with no host sync: the breakdown test
is a device flag that zeroes the basis from the breakdown step on, as the
reference's ``lax.scan`` does. The small tridiagonal eigenproblem goes to
``torch.linalg.eigh`` on the host. The operator's padding rows must map zero
to zero and ``v0`` must be zero in the padding.
"""
from __future__ import annotations

from typing import Callable

import torch


def lanczos_extreme(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v0: torch.Tensor,
    m: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Estimate (lambda_min, lambda_max) of the SPD operator behind
    ``matvec`` from an m-step Lanczos process started at ``v0`` (nonzero,
    zero on padding). Returns 0-d tensors; for error bars use
    ``lanczos_extreme_with_bounds``."""
    lmin, lmax, _errs = _lanczos_impl(matvec, v0, m)
    return lmin, lmax


def lanczos_factorization(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v0: torch.Tensor,
    m: int = 64,
):
    """m-step Lanczos with CGS2 full reorthogonalization:
    A V_m = V_m T_m + beta_m v_{m+1} e_m^T. Returns
    ``(alphas, betas, basis, nrm0)``: the tridiagonal coefficients (betas[j]
    = 0 from the breakdown step on, and the matching alphas replaced by
    alphas[0] so dead steps cannot extend the spectrum), the flat
    orthonormal basis (m+1, n) and |v0|."""
    rdtype = v0.real.dtype if v0.is_complex() else v0.dtype
    fi = torch.finfo(v0.dtype)
    dev = v0.device
    eps = torch.tensor(fi.eps, dtype=rdtype, device=dev)
    tiny = torch.tensor(fi.tiny, dtype=rdtype, device=dev)
    vshape = v0.shape
    n_flat = v0.numel()

    nrm0 = torch.sqrt(torch.vdot(v0.reshape(-1), v0.reshape(-1)).real.to(rdtype))
    basis = torch.zeros((m + 1, n_flat), dtype=v0.dtype, device=dev)
    basis[0] = (v0 / nrm0.to(v0.dtype)).reshape(n_flat)
    live = torch.ones((), dtype=torch.bool, device=dev)
    scale = torch.zeros((), dtype=rdtype, device=dev)
    alphas, betas, lives = [], [], []
    idx = torch.arange(m + 1, device=dev)
    for j in range(m):
        w = matvec(basis[j].reshape(vshape)).reshape(n_flat)
        alpha = torch.vdot(basis[j], w).real.to(rdtype)
        # CGS2 full reorthogonalization against the basis so far
        mask = (idx <= j).to(w.dtype)
        for _ in range(2):
            proj = (basis.conj() @ w) * mask
            w = w - proj @ basis
        beta = torch.sqrt(torch.vdot(w, w).real.to(rdtype))
        # breakdown test relative to the operator scale seen so far
        scale = torch.maximum(scale, torch.maximum(torch.abs(alpha), beta))
        alive = live & (beta > eps * 16 * torch.maximum(scale, tiny))
        wn = torch.maximum(beta, tiny)
        basis[j + 1] = torch.where(alive, w / wn.to(w.dtype), torch.zeros_like(w))
        alphas.append(alpha)
        betas.append(beta * alive.to(rdtype))
        lives.append(live)
        live = alive
    alphas_t = torch.stack(alphas)
    # dead steps decouple with beta = 0; give them the first Ritz value
    alphas_t = torch.where(torch.stack(lives), alphas_t, alphas_t[0])
    return alphas_t, torch.stack(betas), basis, nrm0


def _lanczos_impl(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v0: torch.Tensor,
    m: int = 64,
):
    """m-step Lanczos; returns (theta_min, theta_max, ritz_residuals), on
    v0's device."""
    alphas, betas, _basis, _nrm0 = lanczos_factorization(matvec, v0, m)
    a, b = alphas.cpu(), betas.cpu()
    t = torch.diag(a) + torch.diag(b[:-1], 1) + torch.diag(b[:-1], -1)
    evals, evecs = torch.linalg.eigh(t)
    errs = b[-1] * torch.abs(evecs[-1, :])
    dev = v0.device
    return evals[0].to(dev), evals[-1].to(dev), errs.to(dev)


def lanczos_extreme_with_bounds(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v0: torch.Tensor,
    m: int = 64,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lambda_min_est, lambda_max_est, err_min, err_max) where err_* are the
    Ritz residual bounds beta_m * |s[m-1]|: each Ritz value lies within err
    of some eigenvalue of A (on clustered spectra possibly one above the
    true minimum)."""
    lmin, lmax, errs = _lanczos_impl(matvec, v0, m)
    return lmin, lmax, errs[0], errs[-1]


def condition_estimate(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v0: torch.Tensor,
    m: int = 64,
) -> torch.Tensor:
    """kappa_2(A) ~= lambda_max / lambda_min for SPD A. Short runs
    underestimate kappa on clustered bottoms; prefer
    ``condition_interval``."""
    lmin, lmax = lanczos_extreme(matvec, v0, m=m)
    return lmax / torch.clamp(lmin, min=torch.finfo(lmax.dtype).tiny)


def condition_interval(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v0: torch.Tensor,
    m: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(kappa_lower, kappa_upper) from the Ritz values and their residual
    error bars; kappa_upper is +inf until the bottom Ritz value has
    converged onto an eigenvalue (theta_min - err <= 0)."""
    lmin, lmax, err_min, err_max = lanczos_extreme_with_bounds(matvec, v0, m=m)
    tiny = torch.finfo(lmax.dtype).tiny
    lo = torch.clamp(lmax - err_max, min=0) / torch.clamp(lmin + err_min, min=tiny)
    denom = lmin - err_min
    hi = torch.where(denom > 0, (lmax + err_max) / torch.clamp(denom, min=tiny),
                     torch.full_like(lmax, float("inf")))
    return lo, hi
