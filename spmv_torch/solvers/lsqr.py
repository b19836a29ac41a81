"""LSQR — least squares and consistent systems for any (also rectangular)
operator.

Counterpart of ``spmv_tpu.solvers.lsqr`` (Paige & Saunders 1982): Golub-
Kahan bidiagonalization solves

    min_x |A x - b|_2        (or  min |A x - b|^2 + damp^2 |x - x0|^2)

without forming A^T A. ``matvec`` maps the column side to the row side
and ``rmatvec`` back; for a ``DistMatrix`` pass ``A.matvec`` and
``A.transposed().matvec`` (one rebuild of A^T, then the forward kernels)
or ``A.matvec_transpose``. One apply of each, and three reductions
(|u|, |v|, |x|), an iteration.

Stopping, on running estimates that cost no applies:
  istop=1:  |r| <= btol |b| + atol |A|_F |x|      (consistent systems)
  istop=2:  |A^T r| <= atol |A|_F |r|             (least-squares solutions)
  istop=0:  kmax reached.

The scalars are 0-d tensors on the vectors' device, updated in the
reference's order and dtype; the loop is a Python loop with one host sync
per iteration (the stopping test). ``history`` holds the running |r|
estimate of every iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from spmv_torch.solvers.cg import _dot


@dataclasses.dataclass
class LSQRResult:
    x: torch.Tensor
    iterations: int           # completed bidiagonalization steps
    rnorm: torch.Tensor       # |b - A x| (damped: with the damp*|x| term)
    arnorm: torch.Tensor      # |A^T r| estimate
    rnorm0: torch.Tensor      # initial |b - A x0|
    anorm: torch.Tensor       # running |A|_F estimate
    converged: bool           # istop in {1, 2}
    istop: int                # 0 kmax, 1 residual test, 2 least-squares test
    history: torch.Tensor | None = None  # (iterations,) |r| estimates


def lsqr(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    rmatvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    damp: float = 0.0,
    kmax: int = 100,
    atol: float = 1e-10,
    btol: float = 1e-10,
) -> LSQRResult:
    """Minimize |A x - b| (+ Tikhonov ``damp``) over x. ``x0`` warm-starts
    through the shifted system min |A dx - (b - A x0)|, and ``damp`` then
    regularizes |x - x0|."""
    u0 = b if x0 is None else b - matvec(x0)
    rdtype = b.real.dtype if b.is_complex() else b.dtype
    tiny = torch.finfo(rdtype).tiny
    dampr = torch.tensor(damp, dtype=rdtype, device=b.device)

    def norm(q):
        d = _dot(q, q)
        return torch.sqrt((d.real if d.is_complex() else d).to(rdtype))

    def cplx(t):
        return t.to(b.dtype)

    beta0 = norm(u0)
    u = u0 / cplx(torch.clamp(beta0, min=tiny))
    v = rmatvec(u)
    alpha = norm(v)
    v = v / cplx(torch.clamp(alpha, min=tiny))
    x = torch.zeros_like(v) if x0 is None else x0
    w = v
    rhobar, phibar = alpha, beta0
    anorm2 = alpha ** 2
    res2 = torch.zeros((), dtype=rdtype, device=b.device)
    arnorm, rnorm = alpha * beta0, beta0
    istop, k, hist = 0, 0, []
    while k < kmax and istop == 0:
        # bidiagonalization: beta u+ = A v - alpha u; alpha+ v+ = A^T u+ - beta v
        u = matvec(v) - cplx(alpha) * u
        beta = norm(u)
        u = u / cplx(torch.clamp(beta, min=tiny))
        v_new = rmatvec(u) - cplx(beta) * v
        alpha_new = norm(v_new)
        v_new = v_new / cplx(torch.clamp(alpha_new, min=tiny))
        anorm2 = anorm2 + alpha ** 2 + beta ** 2 + dampr ** 2
        # eliminate the damping term
        rhobar1 = torch.sqrt(rhobar ** 2 + dampr ** 2)
        c1 = rhobar / torch.clamp(rhobar1, min=tiny)
        phibar1 = c1 * phibar
        psi = (dampr / torch.clamp(rhobar1, min=tiny)) * phibar
        # the rotation zeroing beta on the lower bidiagonal
        rho = torch.sqrt(rhobar1 ** 2 + beta ** 2)
        cs = rhobar1 / torch.clamp(rho, min=tiny)
        sn = beta / torch.clamp(rho, min=tiny)
        theta = sn * alpha_new
        rhobar = -cs * alpha_new
        phi = cs * phibar1
        phibar = sn * phibar1
        x = x + cplx(phi / torch.clamp(rho, min=tiny)) * w
        w = v_new - cplx(theta / torch.clamp(rho, min=tiny)) * w
        # running estimates; phibar carries a sign through the rotations,
        # the norms take its magnitude
        res2 = res2 + psi ** 2
        rnorm = torch.sqrt(phibar ** 2 + res2)
        arnorm = torch.abs(phibar * alpha_new * cs)
        anorm = torch.sqrt(anorm2)
        xnorm = norm(x)
        s1 = rnorm <= btol * beta0 + atol * anorm * xnorm
        s2 = arnorm <= atol * anorm * torch.clamp(rnorm, min=tiny)
        dead = alpha_new <= tiny * 4  # A^T u+ in span(v): solved
        istop = int(torch.where(s1, 1, torch.where(s2 | dead, 2, 0)))
        v, alpha = v_new, alpha_new
        hist.append(rnorm)
        k += 1
    return LSQRResult(
        x=x, iterations=k, rnorm=rnorm, arnorm=arnorm, rnorm0=beta0,
        anorm=torch.sqrt(anorm2), converged=istop > 0, istop=istop,
        history=torch.stack(hist) if hist else rnorm.new_zeros((0,)))
