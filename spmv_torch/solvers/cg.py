"""Conjugate Gradient (optionally Jacobi/any-M preconditioned).

Counterpart of ``spmv_tpu.solvers.cg`` with the reference's update order
(``cg.py:134-148``):

    Ap = A p;  alpha = rho / (p.Ap);  x += alpha p;  r -= alpha Ap;
    z = M^-1 r;  rho' = r.z;  beta = rho'/rho;  p = z + beta p

The reference keeps the loop on the device (``lax.while_loop``); here it is
a Python loop with one host sync per iteration, for the convergence test.
The test is evaluated in the vectors' dtype, as the reference does, so
iteration counts match it. Under a torch profiler, ``cg`` records its
spans (``utils.profiling``): ``spmv_torch.cg`` around the solve,
``spmv_torch.cg.iteration`` around each loop body and the check that ends
it, ``spmv_torch.cg.sync`` around each blocking host read.

Two loops, chosen by what ``cg`` is given: an unpreconditioned solve of
float32 or float64 vectors on the card runs the fused loop, whose vector
work is three kernels (``ops/cg_update_cuda.py``: 10 passes over the
vectors an iteration where the torch loop makes 19) that update x, r and p
in place and keep alpha, rho, beta and the convergence flag on the card;
every other solve (a preconditioner, complex or bfloat16 vectors, the CPU)
runs the torch loop. A preconditioner puts an apply and a second reduction
between the two updates, so the loops share no per-iteration logic.
``iterations`` counts the iterations each loop ran, over the process.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from spmv_torch.ops import cg_update_cuda
from spmv_torch.utils.profiling import profile_region

iterations = {"fused": 0, "plain": 0}


@dataclasses.dataclass
class CGResult:
    x: torch.Tensor
    iterations: int           # completed iterations
    rnorm: torch.Tensor       # final |r|_2 (0-d)
    rnorm0: torch.Tensor      # initial |r|_2 (0-d)
    converged: bool
    r: torch.Tensor | None = None  # final residual + search direction:
    p: torch.Tensor | None = None  # the Krylov state for ``resume``


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    # over every stacked shard at once: the global dot
    return torch.vdot(u.reshape(-1), v.reshape(-1))


def _rel(rnorm2, rnorm0, eps):
    return torch.sqrt(rnorm2) / torch.clamp(rnorm0, min=eps)


def _read(flag: torch.Tensor) -> bool:
    """A blocking host read of a 0-d boolean, in a span of its own (the
    tensor is computed before the span starts)."""
    with profile_region("spmv_torch.cg.sync"):
        return bool(flag)


def cg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    kmax: int = 100,
    rtol: float = 1e-10,
    preconditioner: Callable[[torch.Tensor], torch.Tensor] | None = None,
    resume: tuple | None = None,
) -> CGResult:
    """Solve A x = b to relative residual ``rtol`` within ``kmax`` iterations.

    All vectors share b's (padded) shape; padding entries of b must be zero
    so the dots are exact. ``preconditioner``: optional M^-1 apply
    (standard PCG; the convergence test stays on the true residual
    |r|/|r0|). ``resume``: optional ``(r, p, rnorm0)`` warm-start state from
    a previous CGResult; with it (and ``x0`` = the saved solution) the solve
    continues the original Krylov sequence.
    """
    with profile_region("spmv_torch.cg"):
        if _takes_fused(b, preconditioner):
            return _cg_fused(matvec, b, x0, kmax, rtol, resume)
        return _cg_plain(matvec, b, x0, kmax, rtol, preconditioner, resume)


def _takes_fused(b, preconditioner) -> bool:
    """The fused loop's solves: unpreconditioned, real float32 or float64
    vectors on the card."""
    return (preconditioner is None and b.device.type == "cuda"
            and b.dtype in cg_update_cuda.DTYPES)


def _cg_fused(matvec, b, x0, kmax, rtol, resume) -> CGResult:
    """The fused loop. It updates x, r and p in place, so it clones what
    the caller gave (x0, resume's r and p); p starts as a copy of r."""
    eps = torch.finfo(b.dtype).tiny
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    if resume is not None:
        r_in, p_in, rnorm0_in = resume
        r, p = r_in.clone(), p_in.clone()
        rho = _dot(r, r)
        rnorm0 = torch.as_tensor(rnorm0_in, dtype=b.dtype, device=b.device)
    else:
        r = b - matvec(x)
        p = r.clone()
        rho = _dot(r, r)
        rnorm0 = torch.sqrt(rho)
    ws = cg_update_cuda.workspace(rho, rnorm0)
    k = 0
    more = k < kmax and _read(_rel(rho, rnorm0, eps) >= rtol)
    while more:
        with profile_region("spmv_torch.cg.iteration"):
            ap = matvec(p)
            cg_update_cuda.cg_pap(p, ap, ws)
            cg_update_cuda.cg_update_r(r, ap, ws, rtol)
            cg_update_cuda.cg_update_xp(x, p, r, ws)
            k += 1
            more = k < kmax and _read(ws.flag)
    iterations["fused"] += k
    return CGResult(
        x=x, iterations=k, rnorm=torch.sqrt(ws.rho), rnorm0=rnorm0,
        converged=_read(_rel(ws.rho, rnorm0, eps) < rtol), r=r, p=p,
    )


def _cg_plain(matvec, b, x0, kmax, rtol, preconditioner, resume) -> CGResult:
    """The torch loop."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    precond = preconditioner if preconditioner is not None else (lambda r: r)
    eps = torch.finfo(b.dtype).tiny

    if resume is not None:
        r_in, p_in, rnorm0_in = resume
        r = r_in
        p = p_in  # continue with the saved search direction
        rho = _dot(r, precond(r))
        rnorm2 = _dot(r, r)
        rnorm0 = torch.as_tensor(rnorm0_in, dtype=b.dtype, device=b.device)
    else:
        # r0 = b - A x0
        r = b - matvec(x0)
        p = precond(r)
        rho = _dot(r, p)
        rnorm2 = _dot(r, r)
        rnorm0 = torch.sqrt(rnorm2)

    x = x0
    k = 0
    more = k < kmax and _read(_rel(rnorm2, rnorm0, eps) >= rtol)
    while more:
        # an iteration span ends with the convergence check that ends it
        with profile_region("spmv_torch.cg.iteration"):
            ap = matvec(p)
            alpha = rho / _dot(p, ap)
            x = x + alpha * p
            r = r - alpha * ap
            z = precond(r)
            rho_new = _dot(r, z)
            beta = rho_new / rho
            p = z + beta * p
            # unpreconditioned: rho IS |r|^2; PCG pays one extra
            # reduction for the true residual the convergence test is
            # defined on
            rnorm2 = _dot(r, r) if preconditioner is not None else rho_new
            rho = rho_new
            k += 1
            more = k < kmax and _read(_rel(rnorm2, rnorm0, eps) >= rtol)
    iterations["plain"] += k
    return CGResult(
        x=x, iterations=k, rnorm=torch.sqrt(rnorm2), rnorm0=rnorm0,
        converged=_read(_rel(rnorm2, rnorm0, eps) < rtol), r=r, p=p,
    )


def cg_residual_history(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    iters: int,
    x0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run exactly ``iters`` unpreconditioned CG iterations and return
    (x, |r| history of length ``iters``)."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    x = x0
    r = b - matvec(x0)
    p = r
    rnorm2 = _dot(r, r)
    hist = []
    for _ in range(iters):
        ap = matvec(p)
        alpha = rnorm2 / _dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rnorm2_new = _dot(r, r)
        beta = rnorm2_new / rnorm2
        p = r + beta * p
        rnorm2 = rnorm2_new
        hist.append(torch.sqrt(rnorm2))
    return x, torch.stack(hist) if hist else b.new_zeros((0,))


def cg_pipelined(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    kmax: int = 100,
    rtol: float = 1e-10,
    preconditioner: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> CGResult:
    """Single-reduction CG (the Chronopoulos-Gear recurrence), the
    reference's ``cg_pipelined``: s = A p is kept by recurrence, so both
    scalars of an iteration (gamma = r.u and delta = w.u) come from vectors
    that are ready together, one reduction where a distributed run has
    one. The same math as ``cg`` in exact arithmetic, other rounding. One
    apply (and one preconditioner apply) an iteration, plus one each to
    start."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    precond = preconditioner if preconditioner is not None else (lambda r: r)
    eps = torch.finfo(b.dtype).tiny

    r = b - matvec(x0)
    u = precond(r)
    w = matvec(u)
    gamma = _dot(r, u)
    delta = _dot(w, u)
    rnorm2 = _dot(r, r) if preconditioner is not None else gamma
    rnorm0 = torch.sqrt(rnorm2)
    alpha = gamma / delta
    beta = torch.zeros_like(gamma)
    x, p, s = x0, torch.zeros_like(b), torch.zeros_like(b)
    k = 0
    while k < kmax and bool(_rel(rnorm2, rnorm0, eps) >= rtol):
        p = u + beta * p
        s = w + beta * s
        x = x + alpha * p
        r = r - alpha * s
        u = precond(r)
        w = matvec(u)
        gamma_new = _dot(r, u)
        delta = _dot(w, u)
        rnorm2 = _dot(r, r) if preconditioner is not None else gamma_new
        beta = gamma_new / gamma
        alpha = gamma_new / (delta - beta * gamma_new / alpha)
        gamma = gamma_new
        k += 1
    rnorm = torch.sqrt(rnorm2)
    return CGResult(x=x, iterations=k, rnorm=rnorm, rnorm0=rnorm0,
                    converged=bool(_rel(rnorm2, rnorm0, eps) < rtol), r=r, p=None)
