"""MINRES for symmetric, possibly indefinite, systems.

Counterpart of ``spmv_tpu.solvers.minres`` (Paige & Saunders 1975): the
symmetric Lanczos recurrence with Givens rotations, minimizing |b - A x|
over the Krylov space, so it converges for any symmetric A where CG needs
a definite one. One apply and two reductions an iteration. An optional
symmetric positive definite ``preconditioner`` (M^-1 apply) gives
preconditioned MINRES: the recurrence runs in the M^-1 inner product and
the test is on the preconditioned residual norm phibar, the quantity
MINRES minimizes.

The reference keeps the loop and its eleven scalars on the device; here
the scalars are 0-d tensors on the vectors' device, updated in the
reference's order and dtype, and the loop is a Python loop with one host
sync per iteration (the test).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from spmv_torch.solvers.cg import _dot


@dataclasses.dataclass
class MINRESResult:
    x: torch.Tensor
    iterations: int           # completed iterations
    rnorm: torch.Tensor       # final |r| estimate (phibar)
    rnorm0: torch.Tensor      # initial |r| (in the M^-1 norm when preconditioned)
    converged: bool


def minres(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    kmax: int = 100,
    rtol: float = 1e-10,
    preconditioner: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> MINRESResult:
    """Solve symmetric A x = b to phibar/|r0| < ``rtol`` within ``kmax``
    steps. A must be symmetric (indefinite is fine); ``preconditioner``, if
    given, symmetric positive definite. Vectors share b's (padded) shape
    with zero padding entries."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    precond = preconditioner if preconditioner is not None else (lambda r: r)
    rdtype = b.real.dtype if b.is_complex() else b.dtype
    fin = torch.finfo(rdtype)
    eps, tiny = fin.eps, fin.tiny

    def real(t):
        return (t.real if t.is_complex() else t).to(rdtype)

    def cplx(t):
        return t.to(b.dtype)

    r1 = b - matvec(x0)
    y = precond(r1)
    # a negative beta1^2 means M is not SPD: clamp, so phibar = 0 ends the
    # loop at once instead of producing NaN
    beta1 = torch.sqrt(torch.clamp(real(_dot(r1, y)), min=0.0))
    rnorm0 = beta1
    zero = torch.zeros_like(beta1)
    x, r2, w, w2 = x0, r1, torch.zeros_like(b), torch.zeros_like(b)
    beta, oldb, dbar, epsln, phibar = beta1, zero, zero, zero, beta1
    cs, sn = -torch.ones_like(beta1), zero
    k = 0
    while k < kmax and bool(phibar / torch.clamp(rnorm0, min=tiny) >= rtol):
        v = y / cplx(torch.clamp(beta, min=tiny))
        av = matvec(v)
        # three-term Lanczos; the (beta/oldb) r1 term is absent on step one
        if k > 0:
            av = av - cplx(beta / torch.clamp(oldb, min=tiny)) * r1
        alfa = real(_dot(v, av))
        av = av - cplx(alfa / torch.clamp(beta, min=tiny)) * r2
        r1, r2 = r2, av
        y = precond(r2)
        oldb = beta
        beta = torch.sqrt(torch.clamp(real(_dot(r2, y)), min=0.0))
        # the previous rotation, then the new one
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = torch.clamp(torch.sqrt(gbar * gbar + beta * beta), min=eps)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar
        w1, w2 = w2, w
        w = (v - cplx(oldeps) * w1 - cplx(delta) * w2) / cplx(gamma)
        x = x + cplx(phi) * w
        k += 1
    return MINRESResult(x=x, iterations=k, rnorm=phibar, rnorm0=rnorm0,
                        converged=bool(phibar / torch.clamp(rnorm0, min=tiny) < rtol))
