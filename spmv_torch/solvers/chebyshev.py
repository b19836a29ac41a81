"""Chebyshev iteration — the reduction-free inner solver and smoother.

Counterpart of ``spmv_tpu.solvers.chebyshev``. On an SPD operator with
spectrum in [lmin, lmax], Chebyshev iteration needs no dot products: the
step scalars come from the recurrence, so a sweep is applies and axpys
only. AMG smooths with it (solvers/amg.py) and the refined block solvers
use it as their inner solver (solvers/block_cg.py).

The step scalars are computed on the host in the reference's dtypes: theta
and delta from the bounds in float64 and cast to the vectors' dtype, then
sigma, rho and the step weights in that dtype (numpy scalars of it), so
each vector update multiplies by the same value the reference does. The
adaptive variant pays one norm (one host sync) per sweep of
``sweep_iters`` steps, as the reference pays one reduction.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch


def _np_dtype(t: torch.Tensor):
    return np.float64 if t.dtype == torch.float64 else np.float32


def _norm32(v: torch.Tensor) -> np.float32:
    """sqrt(v . v) in v's dtype, as a float32 (the reference's control
    scalars)."""
    f = v.reshape(-1)
    return np.float32(torch.sqrt(torch.vdot(f, f)).item())


@dataclasses.dataclass
class ChebyshevResult:
    x: torch.Tensor
    iterations: int


def chebyshev(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    lmin: float,
    lmax: float,
    iters: int,
    x0: torch.Tensor | None = None,
) -> ChebyshevResult:
    """``iters`` Chebyshev steps on SPD A with spectrum in [lmin, lmax].
    ``b`` may be one vector or a multi-RHS block (the recurrence is
    elementwise). No reductions; exactly ``iters`` + (0 if x0 is None else
    1) operator applications."""
    dt = _np_dtype(b)
    lo, hi = float(lmin), float(lmax)
    theta = dt((hi + lo) / 2)
    delta = dt((hi - lo) / 2)
    sigma = theta / delta
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    d = r / float(theta)
    rho_old = dt(1.0) / sigma
    for _ in range(iters):
        x = x + d
        r = r - matvec(d)
        rho = dt(1.0) / (dt(2.0) * sigma - rho_old)
        d = float(rho * rho_old) * d + float(dt(2.0) * rho / delta) * r
        rho_old = rho
    return ChebyshevResult(x=x, iterations=iters)


def chebyshev_bounds(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v0: torch.Tensor,
    m: int = 32,
    safety: float = 1.1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Safe spectrum enclosure [lmin, lmax] for ``chebyshev`` from an m-step
    Lanczos run: lmax inflated by its Ritz residual and ``safety`` (an
    underestimated top bound diverges); lmin deflated likewise, with a
    proportional quarter-theta floor where the bottom Ritz value has not
    converged (a too-small bottom bound merely slows convergence)."""
    from spmv_torch.solvers.lanczos import lanczos_extreme_with_bounds

    lmin, lmax, err_min, err_max = lanczos_extreme_with_bounds(matvec, v0, m=m)
    hi = (lmax + err_max) * safety
    lo = torch.maximum(lmin - err_min, lmin * 0.25) / safety
    return torch.maximum(lo, hi * 1e-12), hi


def chebyshev_preconditioner(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    lmin: float,
    lmax: float,
    degree: int = 8,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Polynomial preconditioner M^-1 r = p_degree(A) r, the
    ``degree``-step Chebyshev approximation of A^-1 on [lmin, lmax]: one
    apply costs ``degree`` operator applications and no reductions, and
    the fixed-degree polynomial is SPD on the enclosed spectrum (a valid
    PCG preconditioner)."""
    def apply(r: torch.Tensor) -> torch.Tensor:
        return chebyshev(matvec, r, lmin, lmax, degree).x

    return apply


def chebyshev_iterations_for(kappa: float, rtol: float) -> int:
    """Iteration count for a target contraction ``rtol`` given a condition
    bound: error_k <= 2 * ((sqrt(k)-1)/(sqrt(k)+1))**k_steps."""
    kappa = max(float(kappa), 1.0 + 1e-12)
    r = (math.sqrt(kappa) - 1.0) / (math.sqrt(kappa) + 1.0)
    if r <= 0:
        return 1
    return max(1, int(math.ceil(math.log(rtol / 2.0) / math.log(r))))


@dataclasses.dataclass
class ChebyshevAdaptiveResult:
    x: torch.Tensor
    rnorm: float          # final true-recurrence residual norm (Frobenius)
    lmin_final: float     # the bottom bound after stall corrections
    sweeps: int           # outer sweeps executed
    sweep_iters: int = 0  # steps per sweep

    @property
    def iterations(self) -> int:
        """Total operator applications (sweeps * sweep_iters)."""
        return self.sweeps * self.sweep_iters


def chebyshev_adaptive(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    lmin: float,
    lmax: float,
    rtol: float = 1e-6,
    sweep_iters: int = 16,
    max_sweeps: int = 64,
    check_every: int = 4,
    grace: int = 4,
    slack: float = 1.5,
    safety: float = 0.25,
    x0: torch.Tensor | None = None,
) -> ChebyshevAdaptiveResult:
    """Chebyshev iteration with rate-consistent bottom-bound correction
    (the reference's ``chebyshev_adaptive``): the recurrence runs in sweeps
    of ``sweep_iters`` steps with one residual norm each. Every
    ``check_every`` sweeps since the last correction, the observed per-step
    contraction rho_hat over the growing window is compared with the
    assumed rate q = (sqrt(kappa)-1)/(sqrt(kappa)+1); markedly worse
    (beyond the ``slack``-th root, implying a bound at least 4x lower)
    means spectrum below ``lmin``, and the bound jumps to
    ``safety * lmax * ((1-rho_hat)/(1+rho_hat))^2``; the recurrence then
    restarts from the current residual after ``grace`` sweeps. ``b`` may be
    a multi-RHS block; decisions use the Frobenius norm."""
    dt = _np_dtype(b)
    f32 = np.float32
    bn = _norm32(b)
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    hi = f32(lmax)
    lo = f32(lmin)
    eps_floor = f32(np.finfo(np.float32).eps * 64)
    lo_clamp = hi * f32(1e-12)
    tiny = f32(1e-30)

    def scalars(lo_):
        theta = dt((hi + lo_) / f32(2))
        delta = dt((hi - lo_) / f32(2))
        return theta, delta, theta / delta

    rn = _norm32(r)
    theta, delta, sigma = scalars(lo)
    d = r / float(theta)
    rho = dt(1.0) / sigma
    rn_mark = rn
    s_since = 0
    i = 0
    done = bool(rn <= f32(rtol) * bn)
    while not done and i < max_sweeps:
        theta, delta, sigma = scalars(lo)
        for _ in range(sweep_iters):
            x = x + d
            r = r - matvec(d)
            rho_new = dt(1.0) / (dt(2.0) * sigma - rho)
            d = float(rho_new * rho) * d + float(dt(2.0) * rho_new / delta) * r
            rho = rho_new
        rn = _norm32(r)
        done = bool(rn <= f32(rtol) * bn)
        s_since += 1
        if s_since == 0:
            # grace just ended: the window starts here, past the restart
            # transient
            rn_mark = rn
        # the observed per-step contraction over the growing window since
        # the last correction (short windows are noise-limited)
        steps = f32(max(s_since * sweep_iters, 1))
        rho_hat = f32(np.exp(np.log(max(rn, tiny) / max(rn_mark, tiny)) / steps))
        kap = hi / max(lo, lo_clamp)
        q = (np.sqrt(kap) - f32(1)) / (np.sqrt(kap) + f32(1))
        at_floor = rn <= eps_floor * bn
        checking = s_since >= check_every and not done and not at_floor
        q_imp = f32(min(max(rho_hat, f32(0)), f32(0.99999)))
        lo_imp = hi * ((f32(1) - q_imp) / (f32(1) + q_imp)) ** 2 * f32(safety)
        wrong = (checking and rho_hat > q ** f32(1.0 / slack)
                 and lo_imp < lo * f32(0.25))
        if wrong:
            # bounds changed: rebuild the momentum from r and enter the
            # grace period
            lo = max(lo_imp, lo_clamp)
            theta_n, _, sigma_n = scalars(lo)
            d = r / float(theta_n)
            rho = dt(1.0) / sigma_n
            s_since = -grace
        i += 1
    return ChebyshevAdaptiveResult(x=x, rnorm=float(_norm32(r)), lmin_final=float(lo),
                                   sweeps=i, sweep_iters=sweep_iters)
