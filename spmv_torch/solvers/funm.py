"""Matrix-function actions f(A) v for symmetric (SPD) operators via Lanczos,
and stochastic Lanczos quadrature (SLQ) for tr f(A) and log det A.

Counterpart of ``spmv_tpu.solvers.funm`` (``funm_multiply`` :42,
``expm_multiply`` :67, ``inv_sqrt_multiply`` :80, ``sqrt_multiply`` :95,
``slq_trace`` :107, ``slq_logdet`` :153). m Lanczos steps
(``lanczos_factorization``, CGS2-reorthogonalized, on the vectors' device)
give

    f(A) v  ~=  |v| * V_m U f(Theta) U^T e_1

with T_m = U Theta U^T the m x m tridiagonal eigendecomposition. The
applies and the basis stay on the device; the tridiagonal ``eigh`` runs on
the host in float64, as the port's ``lanczos``, ``arnoldi`` and ``lobpcg``
do, so ``f`` acts on a numpy array of Ritz values (use ``np``, not
``torch``). One read of the tridiagonal (and of |v|) a factorization is
the only host sync.

``err_est = |v| * beta_m * |c_m|`` (the next Lanczos weight times the last
Krylov coefficient of f) is the generalized-residual heuristic: exact for
f(x) = x, asymptotically tight for exp; raise m until it is small.

SLQ draws Rademacher probes from a ``torch.Generator`` (the reference
draws them from ``jax.random``, so the two packages' estimates differ by
Monte-Carlo noise; the per-probe quadrature ``slq_quadrature`` is the same
function of the probe in both). Probes run one after another, so memory
stays one Lanczos basis.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from spmv_torch.solvers.lanczos import lanczos_factorization


def _tridiag_eigh(alphas: torch.Tensor, betas: torch.Tensor):
    """Eigenpairs of the Lanczos tridiagonal, on the host in float64."""
    a = alphas.detach().cpu().numpy().astype(np.float64)
    b = betas.detach().cpu().numpy().astype(np.float64)
    t = np.diag(a) + np.diag(b[:-1], 1) + np.diag(b[:-1], -1)
    evals, evecs = np.linalg.eigh(t)
    return evals, evecs, b


def funm_multiply(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v0: torch.Tensor,
    f: Callable[[np.ndarray], np.ndarray],
    m: int = 48,
) -> tuple[torch.Tensor, float]:
    """Return ``(y, err_est)`` with ``y ~= f(A) v0`` for the symmetric
    operator behind ``matvec``; ``f`` maps a float64 numpy array of Ritz
    values elementwise. ``v0``: any vector in the operator's padded layout,
    zero on padding rows; ``y`` has its shape, dtype and device. ``err_est``
    (a float) is the generalized-residual heuristic in the scale of |y|."""
    alphas, betas, basis, nrm0 = lanczos_factorization(matvec, v0, m)
    evals, evecs, b = _tridiag_eigh(alphas, betas)
    c = evecs @ (f(evals) * evecs[0, :])          # U f(Theta) U^T e_1, (m,)
    cd = torch.as_tensor(c, device=v0.device).to(v0.dtype)
    y = (nrm0.to(v0.dtype) * (cd @ basis[:m])).reshape(v0.shape)
    err_est = float(nrm0) * float(b[-1]) * abs(float(c[-1]))
    return y, err_est


def expm_multiply(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v0: torch.Tensor,
    t: float = 1.0,
    m: int = 48,
) -> tuple[torch.Tensor, float]:
    """``exp(t A) v0`` (scipy.sparse.linalg.expm_multiply semantics: pass
    ``t < 0`` for decay/diffusion with an SPD A). m ~ sqrt(|t| lambda_max)
    plus a margin gives full accuracy; check ``err_est``."""
    t = float(t)
    return funm_multiply(matvec, v0, lambda th: np.exp(t * th), m=m)


def inv_sqrt_multiply(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v0: torch.Tensor,
    m: int = 48,
) -> tuple[torch.Tensor, float]:
    """``A^{-1/2} v0`` for SPD A (z ~ N(0, I) gives A^{-1/2} z ~ N(0,
    A^{-1})). Ritz values are clipped at the float64 tiny so that a bottom
    not yet converged cannot produce inf."""
    tiny = np.finfo(np.float64).tiny
    return funm_multiply(matvec, v0, lambda th: 1.0 / np.sqrt(np.maximum(th, tiny)), m=m)


def sqrt_multiply(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v0: torch.Tensor,
    m: int = 48,
) -> tuple[torch.Tensor, float]:
    """``A^{1/2} v0`` for symmetric positive semi-definite A."""
    return funm_multiply(matvec, v0, lambda th: np.sqrt(np.maximum(th, 0.0)), m=m)


def slq_quadrature(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    z: torch.Tensor,
    f: Callable[[np.ndarray], np.ndarray],
    m: int = 32,
) -> float:
    """One probe's Gauss quadrature of z^T f(A) z from an m-step Lanczos
    run started at ``z``: ``|z|^2 * sum_i U[0, i]^2 f(theta_i)``."""
    alphas, betas, _basis, nrm0 = lanczos_factorization(matvec, z, m)
    del _basis
    evals, evecs, _b = _tridiag_eigh(alphas, betas)
    return float(nrm0) ** 2 * float(np.sum(evecs[0, :] ** 2 * f(evals)))


def rademacher_probe(template: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """A Rademacher +-1 vector on ``template``'s nonzero support (zero
    where the template is zero: its padding), drawn on the generator's
    device and returned on the template's, in its dtype."""
    signs = torch.randint(0, 2, template.shape, generator=generator,
                          device=generator.device, dtype=torch.int8)
    z = (2 * signs - 1).to(device=template.device, dtype=template.dtype)
    return torch.where(template != 0, z, torch.zeros_like(z))


def slq_trace(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    f: Callable[[np.ndarray], np.ndarray],
    template: torch.Tensor,
    generator: torch.Generator,
    n_probes: int = 16,
    m: int = 32,
) -> tuple[float, float]:
    """Stochastic Lanczos quadrature (Ubaru, Chen & Saad '17): estimate
    ``tr(f(A))`` for symmetric A as ``(mean, stderr)`` over ``n_probes``
    Rademacher probes drawn from ``generator``, each quadratured by an
    m-step Lanczos run (``slq_quadrature``). ``template``: any vector in
    the operator's padded layout whose zero entries mark padding (e.g.
    ``A.to_dist(np.ones(n))``); probes live on its nonzero support. The
    probes run one after another; ``stderr`` is the standard error of the
    mean (numpy's ``std`` over the samples, / sqrt(n_probes))."""
    samples = np.array([
        slq_quadrature(matvec, rademacher_probe(template, generator), f, m)
        for _ in range(n_probes)])
    return float(np.mean(samples)), float(np.std(samples) / np.sqrt(float(n_probes)))


def slq_logdet(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    template: torch.Tensor,
    generator: torch.Generator,
    n_probes: int = 16,
    m: int = 32,
) -> tuple[float, float]:
    """``log det A = tr(log A)`` for SPD A via ``slq_trace``. Ritz values
    are clipped at the float64 tiny before the log; raise ``m`` until the
    estimate stabilizes, and read ``stderr`` for the Monte-Carlo bar."""
    tiny = np.finfo(np.float64).tiny
    return slq_trace(matvec, lambda th: np.log(np.maximum(th, tiny)), template,
                     generator, n_probes=n_probes, m=m)
