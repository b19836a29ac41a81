"""BiCGStab — the Krylov solver for non-symmetric systems.

Counterpart of ``spmv_tpu.solvers.bicgstab`` (van der Vorst 1992), in its
update order: two applies an iteration, right preconditioning (the
convergence test is on the true residual of the original system, so
``rtol`` means what it means in ``cg``), and the reference's relative
breakdown guards (rho = <rhat, r> against |rhat||r|, <rhat, v> against
|rhat||v|, t.s against |t||s|).

On breakdown the iteration's quotients are not trusted: the loop stops
with ``breakdown=True`` and returns the last good iterate, from which a
caller may restart. The reference keeps the loop on the device; here it is
a Python loop with one host sync per iteration (the convergence and
breakdown test); the pick between the new and the old state is made on
the device, as the reference makes it. Complex vectors work as they do in
the reference (the dots conjugate their first argument).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from spmv_torch.solvers.cg import _dot


@dataclasses.dataclass
class BiCGStabResult:
    x: torch.Tensor
    iterations: int           # completed iterations
    rnorm: torch.Tensor       # final |r|_2 (0-d)
    rnorm0: torch.Tensor      # initial |r|_2 (0-d)
    converged: bool
    breakdown: bool           # rho/omega collapsed; restart from x


def _real(t: torch.Tensor) -> torch.Tensor:
    return t.real if t.is_complex() else t


def _safe(d: torch.Tensor, tiny: float) -> torch.Tensor:
    """Keep divisions finite on the breakdown path (the flag, not the
    quotient, decides what happens next); the sign of the clamp follows
    the real part."""
    clamp = torch.where(_real(d) < 0, -tiny, tiny).to(d.dtype)
    return torch.where(d.abs() <= tiny, clamp, d)


def bicgstab(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    kmax: int = 100,
    rtol: float = 1e-10,
    preconditioner: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> BiCGStabResult:
    """Solve (possibly non-symmetric) A x = b to relative true residual
    ``rtol`` within ``kmax`` iterations of two applies each. All vectors
    share b's (padded) shape with zero padding entries, so the dots are
    exact."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    precond = preconditioner if preconditioner is not None else (lambda r: r)
    fin = torch.finfo(b.dtype)
    tiny, releps = fin.tiny, fin.eps * 4

    r = b - matvec(x0)
    rhat = r  # the fixed shadow residual
    rnorm2 = _real(_dot(r, r))
    rnorm0 = torch.sqrt(rnorm2)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    x, p, v = x0, torch.zeros_like(b), torch.zeros_like(b)
    rho, alpha, omega = one, one, one
    brk = torch.zeros((), dtype=torch.bool, device=b.device)

    def rel(rn2):
        return torch.sqrt(rn2) / torch.clamp(rnorm0, min=tiny)

    k = 0
    while k < kmax and not bool((rel(rnorm2) < rtol) | brk):
        rho_new = _dot(rhat, r)
        brk = rho_new.abs() <= torch.clamp(releps * rnorm0 * torch.sqrt(rnorm2),
                                           min=tiny * 4)
        beta = (rho_new / _safe(rho, tiny)) * (alpha / _safe(omega, tiny))
        p_new = r + beta * (p - omega * v)
        phat = precond(p_new)
        v_new = matvec(phat)
        denom = _dot(rhat, v_new)
        vnorm2 = _real(_dot(v_new, v_new))
        brk = brk | (denom.abs() <= torch.clamp(releps * rnorm0 * torch.sqrt(vnorm2),
                                                min=tiny * 4))
        alpha_new = rho_new / _safe(denom, tiny)
        s = r - alpha_new * v_new
        shat = precond(s)
        t = matvec(shat)
        ts = _dot(t, s)
        tt = _dot(t, t)
        ss = _real(_dot(s, s))
        omega_new = ts / _safe(tt, tiny)
        brk = brk | (ts.abs() <= torch.clamp(releps * torch.sqrt(_real(tt) * ss),
                                             min=tiny * 4))
        x_new = x + alpha_new * phat + omega_new * shat
        r_new = s - omega_new * t
        rnorm2_new = _real(_dot(r_new, r_new))

        # on breakdown keep the state from before the update: the returned
        # x is the last good iterate
        def pick(new, old):
            return torch.where(brk, old, new)

        x, r, p, v = pick(x_new, x), pick(r_new, r), pick(p_new, p), pick(v_new, v)
        rho, alpha, omega = pick(rho_new, rho), pick(alpha_new, alpha), pick(omega_new, omega)
        rnorm2 = pick(rnorm2_new, rnorm2)
        k += 1
    broke = bool(brk)
    if broke:
        k -= 1  # the iteration that broke down did not complete
    rnorm = torch.sqrt(rnorm2)
    return BiCGStabResult(x=x, iterations=k, rnorm=rnorm, rnorm0=rnorm0,
                          converged=bool(rel(rnorm2) < rtol), breakdown=broke)
