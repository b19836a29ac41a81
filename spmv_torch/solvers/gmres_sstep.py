"""s-step (communication-avoiding) GMRES for general non-symmetric systems.

Counterpart of ``spmv_tpu.solvers.gmres_sstep`` (``gmres_sstep`` :74),
CA-GMRES in the Demmel / Hoemmen / Mohiyuddin line. Per block of s Arnoldi
steps (m = t*s steps done, q_m the last orthonormal vector):

1. the block basis V = [rho_0(A) q_m, ..., rho_s(A) q_m]: shifted
   Chebyshev (``solvers/cg_sstep.chebyshev_basis``) or, with ``shifts`` /
   ``newton_ops``, the Leja-ordered real Newton basis
   (``solvers/newton_basis``): s applies and no reductions, or one halo
   exchange when the matrix-powers kernel supplies ``basis_builder``
   (``spmv_torch.parallel.powers``). A V[:s] = B^T V exactly for a known
   (s+1, s) matrix B;
2. BCGS2 against every previous basis row (two (M+1, n) @ (n, s)
   projections) and CholQR2 inside the block (two Gram + Cholesky
   passes), all on the vectors' device: the reference's 4 fused
   reductions per s steps are the same 4 device matmuls here;
3. one host sync per block (``cg_sstep.host_sync``) reads the projection
   coefficients and the two Cholesky factors; on the host, in the vectors'
   dtype, the s new Hessenberg columns come from the basis-change algebra
   H @ Rbar[:, :s] = Rbar @ B (one triangular solve), and a least-squares
   solve of min |beta e_0 - H y| gives the running residual estimate, on
   which the block loop exits early (overshoot at most s-1 steps).

So a block costs s applies, 4 device reductions and 1 host sync where the
reference pays 4 fused collectives; a cycle adds one apply and one host
read for its true residual. Standard ``gmres`` pays 3 reductions and one
host sync a step.

The basis interval [lo, hi] only conditions the basis (any basis of the
Krylov space gives the same Arnoldi space in exact arithmetic); omitted, a
12-step power iteration estimates |lambda|max once. Spectra far off the
real axis want the Newton basis (``shifts``), small s, or ``gmres``.
CholQR2 needs the block basis's condition number squared to be
representable (about 3e3 per block in float32, 1e8 in float64).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from spmv_torch.solvers.cg import _dot
from spmv_torch.solvers.cg_sstep import (
    _mm,
    _np_dtype,
    basis_interval,
    chebyshev_basis,
    chebyshev_recurrence,
    host_sync,
)
from spmv_torch.solvers.gmres import GMRESResult


def _chol_qr(W: torch.Tensor, rdt) -> tuple[torch.Tensor, torch.Tensor]:
    """One CholQR pass on the device: W = L @ Qn with L lower triangular.
    A relative jitter (trace * 4s eps) keeps the factor finite at lucky
    breakdown; ``cholesky_ex`` reports failure as NaN downstream instead
    of a host sync. Qn = L^-1 W is one (s, s) @ (s, n) product with the
    inverted (s x s) factor, a wide product; torch's triangular solve
    with n right-hand sides is not one on the card."""
    s = W.shape[0]
    eye = torch.eye(s, dtype=W.dtype, device=W.device)
    G = _mm(W, W.T)
    jit = torch.trace(G) * float(np.finfo(rdt).eps * (4 * s))
    L, _info = torch.linalg.cholesky_ex(G + jit * eye)
    return _mm(torch.linalg.solve_triangular(L, eye, upper=False), W), L


def gmres_sstep(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    s: int = 4,
    restart: int = 32,
    max_cycles: int = 20,
    rtol: float = 1e-10,
    lambda_bounds: tuple | None = None,
    basis_builder: Callable | None = None,
    shifts=None,
    newton_ops=None,
) -> GMRESResult:
    """Solve general ``A x = b`` with s-step GMRES(restart) (module
    docstring). Semantics follow ``gmres``: vectors keep b's (padded)
    layout with zero padding, restart cycles until |r|/|r0| < ``rtol`` or
    ``max_cycles``; ``rnorm`` is the true residual of the final iterate and
    ``iterations`` counts the Arnoldi steps of completed blocks.
    ``restart`` is rounded up to whole s-blocks. A cycle whose true
    residual is non-finite or grew past 4x the previous one keeps the
    previous iterate and ends the solve.

    ``lambda_bounds=(lo, hi)``: the Chebyshev basis interval, defaults to
    (0, 1.1 |lambda|) from a power iteration. ``basis_builder(q, c, e)``
    (Chebyshev) or ``basis_builder(q)`` (Newton) returns the (s+1,
    *q.shape) block basis, e.g. the matrix-powers kernel's.

    Preconditioning composes by operator composition: for a fixed linear
    M solve A M u = b with ``matvec=lambda v: A(M(v))`` and take x = M u.

    ``shifts``: complex shift candidates (numpy, e.g. Ritz values from
    ``newton_shifts_from_operator``) switching to the Newton basis; then
    ``lambda_bounds`` is ignored. ``newton_ops``: a precomputed
    ``newton_basis_ops`` tuple (takes precedence): pass the same object to
    the builder's ``newton_powers_basis(pp, q, ops)``, so B comes from
    exactly the ops the builder runs."""
    if s < 1:
        raise ValueError(f"s must be >= 1, got {s}")
    if b.is_complex():
        raise ValueError("gmres_sstep supports real dtypes; use gmres "
                         "for complex systems")
    if x0 is None:
        x0 = torch.zeros_like(b)
    T_blocks = -(-restart // s)
    M = T_blocks * s
    vshape, n = b.shape, b.numel()
    cdt = _np_dtype(b)
    tiny = np.finfo(cdt).tiny

    def mv(v):
        return matvec(v.reshape(vshape)).reshape(n)

    def dev(arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, device=b.device)

    def norm(v) -> torch.Tensor:
        return torch.sqrt(torch.clamp(_dot(v, v), min=0))

    r = (b - matvec(x0)).reshape(n)
    rnorm0_t = norm(r)
    rnorm0 = cdt.type(host_sync(rnorm0_t))

    if shifts is not None or newton_ops is not None:
        from spmv_torch.solvers.newton_basis import (
            newton_basis_ops,
            newton_recurrence_matrix,
        )

        if newton_ops is not None:
            ops = tuple(newton_ops)
            if len(ops) != s:
                raise ValueError(f"newton_ops length {len(ops)} != s={s}")
        else:
            ops = newton_basis_ops(np.asarray(shifts), s)
        B = newton_recurrence_matrix(ops, cdt)

        def build_basis(q):
            if basis_builder is not None:
                return basis_builder(q.reshape(vshape)).reshape(s + 1, n)
            vs = [q]
            for alpha, gamma, sigma in ops:
                w = mv(vs[-1]) - alpha * vs[-1]
                if gamma != 0.0:
                    w = w + gamma * vs[-2]
                vs.append(w / sigma)
            return torch.stack(vs)
    else:
        c, e = basis_interval(mv, r, lambda_bounds, cdt)
        c, e = cdt.type(c), cdt.type(e)
        B = chebyshev_recurrence(s, c, e, cdt)

        def build_basis(q):
            if basis_builder is not None:
                return basis_builder(q.reshape(vshape), c, e).reshape(s + 1, n)
            return chebyshev_basis(mv, q, s, float(c), float(e))

    from scipy.linalg import solve_triangular

    def cycle(x, r, beta_t, beta):
        """One restart cycle from residual r (|r| = beta): (x2, steps)."""
        Q = torch.zeros((M + 1, n), dtype=b.dtype, device=b.device)
        Q[0] = r / torch.clamp(beta_t, min=tiny)
        H = np.zeros((M + 1, M), cdt)
        g = np.zeros(M + 1, cdt)
        g[0] = beta
        t = 0
        while t < T_blocks:
            m = t * s
            V = build_basis(Q[m])                       # (s+1, n), V[0] = q_m
            # BCGS2 against every previous row (unwritten rows are zero)
            W = V[1:]
            C2 = torch.zeros((M + 1, s), dtype=b.dtype, device=b.device)
            for _ in range(2):
                Cp = _mm(Q, W.T)                        # (M+1, s)
                W = W - _mm(Cp.T, Q)
                C2 = C2 + Cp
            # CholQR2: W = L1 Qn1, Qn1 = L2 Qn, so W = (L1 L2) Qn
            Qn, L1 = _chol_qr(W, cdt)
            Qn, L2 = _chol_qr(Qn, cdt)
            Q[m + 1: m + 1 + s] = Qn
            small = host_sync(torch.cat([C2.reshape(-1), L1.reshape(-1), L2.reshape(-1)]))
            C2h = small[: (M + 1) * s].reshape(M + 1, s)
            L1h, L2h = small[(M + 1) * s:].reshape(2, s, s)
            # coefficients of V in the orthonormal basis: Rbar[:, 0] = e_m,
            # Rbar[i, j >= 1] = C2[i, j-1], Rbar[m+1+k, j >= 1] = (L1 L2)[j-1, k]
            Rbar = np.zeros((M + 1, s + 1), cdt)
            Rbar[m, 0] = 1
            Rbar[:, 1:] = C2h
            Rbar[m + 1: m + 1 + s, 1:] = (L1h @ L2h).T
            # H @ Rbar[:, :s] = Rbar @ B; the unknowns are columns m..m+s-1
            # and T = Rbar[m:m+s, :s] is upper triangular
            rhs = Rbar @ B - H @ Rbar[:M, :s]
            h_new = solve_triangular(Rbar[m:m + s, :s].T, rhs.T, lower=True).T
            h_new[m + s + 1:] = 0  # the exact support is rows <= m+s
            H[:, m:m + s] = h_new
            t += 1
            y = np.linalg.lstsq(H, g, rcond=None)[0]
            res = g - H @ y
            est = np.sqrt(max(res @ res, cdt.type(0)))
            if not (est >= rtol * max(rnorm0, tiny) and np.isfinite(est)):
                break
        y = np.linalg.lstsq(H, g, rcond=None)[0]
        return x + (dev(y) @ Q[:M]).reshape(vshape), t * s

    x = x0
    rnorm_t, rnorm = rnorm0_t, rnorm0
    k_total = cycles = 0
    failed = False
    while cycles < max_cycles and rnorm / max(rnorm0, tiny) >= rtol and not failed:
        x2, steps = cycle(x, r, rnorm_t, rnorm)
        r2 = (b - matvec(x2)).reshape(n)
        rnorm2_t = norm(r2)
        rnorm2 = cdt.type(host_sync(rnorm2_t))
        # a breakdown-corrupted cycle (a non-finite basis, or residual growth
        # past any healthy restart transient) keeps the previous iterate
        ok = bool(np.isfinite(rnorm2) and rnorm2 <= 4 * rnorm + tiny)
        if ok:
            x, r, rnorm_t, rnorm = x2, r2, rnorm2_t, rnorm2
        failed = not ok
        k_total += steps
        cycles += 1
    return GMRESResult(x=x, iterations=k_total, cycles=cycles, rnorm=rnorm_t,
                       rnorm0=rnorm0_t,
                       converged=bool(rnorm / max(rnorm0, tiny) < rtol))
