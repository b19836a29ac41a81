"""s-step (communication-avoiding) Conjugate Gradient.

Counterpart of ``spmv_tpu.solvers.cg_sstep`` (``_mm`` :81, ``_pinv_solve``
:90, ``_estimate_lmax`` :105, ``cg_sstep`` :125), s-step CG in the
Chronopoulos & Gear '89 form with the basis conditioning of the
communication-avoiding Krylov line (Hoemmen '10, Carson '15). One block of
s CG iterations:

1. the Krylov basis V = [rho_0(A) r, ..., rho_s(A) r], rho_j the Chebyshev
   polynomials shifted to [lo, hi] (s applies, no reductions; or one halo
   exchange with the matrix-powers kernel, ``basis_builder``); the
   three-term recurrence gives A V[:, :s] = V @ B for a known (s+1, s)
   tridiagonal B, so every A-product below is small-matrix algebra;
2. one Gram Z = [Q_prev; V] V^T ((2s+1, s+1)), a single ``torch.matmul``
   on the vectors' device (the reference's one fused reduction);
3. one host sync reads Z (``host_sync``); the (s x s) algebra — block
   A-conjugation against the previous block, the Galerkin solve through an
   eigh pseudo-inverse that drops directions already converged — runs on
   the host in numpy, in the vectors' dtype, as ``gmres.py`` does its
   Givens work;
4. [P'; A P'] from V and the previous [P; A P] in two (2s, .) @ (., n)
   products, then x += P' a and r -= (A P') a, on the device, the small
   matrices sent back.

The reference runs the whole loop in one ``lax.while_loop`` with one
global reduction per block; here a Python loop pays one host sync per
block, and the loop's exit test reads |r|^2 at the block's entry, G[0, 0],
from that sync: a true dot of an actual residual, one block stale (at most
s applies of overshoot), never a small-matrix identity, which cancels in
float32. The true residual is recomputed once after the loop.

Behaviour kept from the reference: the divergence exits (a non-finite
|r|, or |r| grown past max(1e4, 1/sqrt(eps)) |r0|), the best block-entry
iterate (returned when the final one is non-finite or 4x worse),
``replace_every`` (residual replacement), ``basis_builder`` and
``lambda_bounds``. The reference's ``_mm`` runs every product at
``Precision.HIGHEST``, a TPU workaround (the MXU rounds float32 operands
to bf16); torch's float32 matmul is full precision as long as TF32 stays
off, which this package never enables.

Envelope (the reference's docstring, :56-66): SPD operators, modest s
(4-8). In float32 the block updates floor near kappa * eps and beyond
kappa ~ 1e4 the iteration stalls or diverges; use float64 there.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from spmv_torch.solvers.cg import CGResult, _dot


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def host_sync(t: torch.Tensor) -> np.ndarray:
    """Every device-to-host read of the s-step solvers: in a block, one (the
    Gram of ``cg_sstep``, the small factors of ``gmres_sstep``); outside
    the blocks, the set-up norms and the final residual. Tests count the
    calls."""
    return t.detach().cpu().numpy()


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A device matrix product at the operands' full precision: the
    reference's ``_mm`` (:81) without its TPU-only ``Precision.HIGHEST``
    (torch's float32 matmul is exact-precision with TF32 off)."""
    return torch.matmul(a, b)


def _pinv_solve(M: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Solve symmetric-PSD ``M x = y`` through an eigh pseudo-inverse:
    eigenvalues below a relative floor are dropped (their directions carry
    no information, e.g. search directions already converged inside the
    block), not inverted into noise. Host numpy, in M's dtype."""
    dt = M.dtype
    w, U = np.linalg.eigh(M)
    w = w.astype(np.finfo(dt).dtype, copy=False)
    wmax = max(np.max(np.abs(w)), np.finfo(dt).tiny)
    tol = wmax * np.finfo(dt).eps * M.shape[0] * 8
    good = w > tol
    winv = np.where(good, 1 / np.where(good, w, 1), 0).astype(w.dtype)
    z = U.T.conj() @ y
    scale = winv if z.ndim == 1 else winv[:, None]
    return U @ (scale * z)


def _estimate_lmax(matvec_flat, v0: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """A one-time power-iteration estimate of lambda_max (SPD A), a 0-d
    tensor on v0's device. Slight under-estimates are harmless for the
    Chebyshev basis; the caller adds 10% headroom."""
    rdtype = v0.real.dtype if v0.is_complex() else v0.dtype
    tiny = torch.tensor(torch.finfo(v0.dtype).tiny, dtype=rdtype, device=v0.device)
    v = v0 / torch.maximum(torch.sqrt(_dot(v0, v0).real), tiny).to(v0.dtype)
    lam = torch.zeros((), dtype=rdtype, device=v0.device)
    for _ in range(iters):
        w = matvec_flat(v)
        lam = torch.sqrt(_dot(w, w).real)
        v = w / torch.maximum(lam, tiny).to(w.dtype)
    return lam


def chebyshev_recurrence(s: int, c, e, dtype) -> np.ndarray:
    """The (s+1, s) matrix B with A V[:, :s] = V @ B for the shifted
    Chebyshev basis on [c - e, c + e]: A v_0 = c v_0 + e v_1 and
    A v_j = c v_j + e/2 (v_{j+1} + v_{j-1}). c and e in the vectors' real
    dtype; B in ``dtype``."""
    B = np.zeros((s + 1, s), dtype)
    B[np.arange(s), np.arange(s)] = c
    B[np.arange(1, s + 1), np.arange(s)] = np.where(np.arange(s) == 0, e, e / 2)
    if s > 1:
        B[np.arange(s - 1), np.arange(1, s)] = e / 2
    return B


def chebyshev_basis(mv, q: torch.Tensor, s: int, c: float, e: float) -> torch.Tensor:
    """[rho_0(A) q, ..., rho_s(A) q] as (s+1, n) rows: s applies, no
    reductions."""
    vs = [q, (mv(q) - c * q) / e]
    for _ in range(1, s):
        vs.append(2 * (mv(vs[-1]) - c * vs[-1]) / e - vs[-2])
    return torch.stack(vs)


def basis_interval(mv, r0: torch.Tensor, lambda_bounds, rdt) -> tuple:
    """(c, e) of the Chebyshev basis in the real dtype ``rdt``: the centre
    and half-width of ``lambda_bounds``, or of [0, 1.1 lmax] from a
    12-step power iteration (one host read)."""
    tiny = np.finfo(rdt).tiny
    if lambda_bounds is None:
        lo = rdt.type(0)
        hi = rdt.type(host_sync(_estimate_lmax(mv, r0))) * rdt.type(1.1)
    else:
        lo, hi = rdt.type(lambda_bounds[0]), rdt.type(lambda_bounds[1])
    return (hi + lo) / 2, max((hi - lo) / 2, tiny)


def cg_sstep(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    s: int = 4,
    kmax: int = 100,
    rtol: float = 1e-10,
    lambda_bounds: tuple | None = None,
    basis_builder: Callable | None = None,
    replace_every: int = 0,
) -> CGResult:
    """Solve SPD ``A x = b`` with s-step CG, one host sync per ``s``
    iterations (module docstring). Semantics follow ``cg``: vectors in b's
    (padded) layout with zero padding, ``kmax`` counts CG iterations
    (rounded up to whole s-blocks), convergence on |r|/|r0| < rtol. The
    returned ``rnorm`` is the true final residual norm (recomputed after
    the loop); ``iterations`` counts the applies of completed blocks.

    ``lambda_bounds=(lo, hi)``: the Chebyshev basis interval; ``(0,
    lmax)`` is valid for SPD A. Omitted, a 12-step power iteration
    estimates lmax once.

    Preconditioning composes by splitting: for M^-1 = G^T G solve
    (G A G^T) y = G b with ``matvec=lambda v: G(A(Gt(v)))`` and recover
    x = G^T y (the reference's ``test_sstep_fsai_split_preconditioned``).

    ``basis_builder(r, c, e) -> (s+1, *r.shape)``: replaces the s-apply
    basis build, returning the same shifted-Chebyshev basis for (c, e),
    e.g. ``spmv_torch.parallel.powers.chebyshev_powers_basis`` (one halo
    exchange for the whole basis).

    ``replace_every=k``: every k-th block recompute r = b - A x instead of
    carrying the recurrence residual (one extra apply per k blocks); in
    float32 it lifts the attainable floor several-fold. 0 disables it.
    """
    if s < 1:
        raise ValueError(f"s must be >= 1, got {s}")
    if x0 is None:
        x0 = torch.zeros_like(b)
    vshape, n = b.shape, b.numel()
    cdt = _np_dtype(b)
    rdt = np.finfo(cdt).dtype
    tiny = np.finfo(cdt).tiny

    def mv(v):
        return matvec(v.reshape(vshape)).reshape(n)

    def dev(arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, device=b.device)

    r0 = (b - matvec(x0)).reshape(n)
    x = x0.reshape(n)
    rnorm2_0_t = _dot(r0, r0).real
    rnorm2_0 = rdt.type(host_sync(rnorm2_0_t))
    rnorm0 = np.sqrt(rnorm2_0)
    c, e = basis_interval(mv, r0, lambda_bounds, rdt)
    B = chebyshev_recurrence(s, c, e, cdt)
    cf, ef = float(cdt.type(c)), float(cdt.type(e))

    def build_basis(r):
        if basis_builder is not None:
            return basis_builder(r.reshape(vshape), c, e).reshape(s + 1, n)
        return chebyshev_basis(mv, r, s, cf, ef)

    n_outer = -(-kmax // s)
    # growth cap keyed to the dtype: a healthy CG residual may grow ~sqrt(kappa)
    # over |r0|, and float64 handles kappa far past float32
    cap = max(rdt.type(1e4), rdt.type(1) / np.sqrt(np.finfo(cdt).eps))

    def running(k, rnorm2):
        rn = np.sqrt(max(rnorm2, rdt.type(0)))
        return (k < n_outer and rn / max(rnorm0, tiny) >= rtol and np.isfinite(rn)
                and rn <= cap * rnorm0 + tiny)

    # [P'; A P'] = Mv V - blockdiag(C^H, C^H) [Q; S]: Mv = [[I, 0], [B^T]]
    Mv = np.zeros((2 * s, s + 1), cdt)
    Mv[np.arange(s), np.arange(s)] = 1
    Mv[s:] = B.T
    Mv_dev = dev(Mv)
    r = r0
    QS = torch.zeros((2 * s, n), dtype=b.dtype, device=b.device)  # [Q; S] = [P; A P]
    D = np.eye(s, dtype=cdt)
    k, rnorm2 = 0, rnorm2_0
    x_best, rn2_best = x, rnorm2_0
    while running(k, rnorm2):
        V = build_basis(r)                              # s applies (halo only)
        # the Gram [Q; V]^H V, read in the block's one host sync
        Z = host_sync(torch.cat([_mm(QS[:s].conj(), V.T), _mm(V.conj(), V.T)]))
        QtV, G = Z[:s], Z[s:]
        # G[0, 0] = |r|^2 of the current x: snapshot the best iterate, so a
        # later float32 divergence cannot destroy delivered progress
        g00 = rdt.type(G[0, 0].real)
        if np.isfinite(g00) and g00 < rn2_best:
            x_best, rn2_best = x, g00
        E = QtV @ B                                     # Q^T A P  (s, s)
        C = _pinv_solve(D, E)                           # block A-conjugation
        Dn = G[:s] @ B - E.T.conj() @ C                 # P'^T A P'
        Dn = (Dn + Dn.T.conj()) * cdt.type(0.5)
        g = G[:s, 0] - C.T.conj() @ QtV[:, 0]           # P'^T r
        a = dev(_pinv_solve(Dn, g))
        Mqs = np.zeros((2 * s, 2 * s), cdt)
        Mqs[:s, :s] = Mqs[s:, s:] = -C.T.conj()
        # the conjugated directions P' and A P' (no apply), in place of [Q; S]
        QS = torch.addmm(_mm(Mv_dev, V), dev(Mqs), QS)
        x = torch.addmv(x, QS[:s].T, a)
        r = torch.addmv(r, QS[s:].T, a, alpha=-1)
        k += 1
        if replace_every and k % replace_every == 0:
            # residual replacement (van der Vorst / Carson): re-anchor the
            # recurrence residual to b - A x
            r = (b - matvec(x.reshape(vshape))).reshape(n)
        D, rnorm2 = Dn, g00

    # the true residual after the loop; a non-finite final iterate, or one
    # 4x worse than the best block-entry snapshot (healthy CG is not
    # monotone in |r|_2, hence the slack), gives way to the snapshot
    r_true = (b - matvec(x.reshape(vshape))).reshape(n)
    rn_x = torch.sqrt(_dot(r_true, r_true).real)
    rn_x_h = rdt.type(host_sync(rn_x))
    if not np.isfinite(rn_x_h) or rn_x_h > 4 * np.sqrt(max(rn2_best, rdt.type(0))):
        x = x_best
        r_true = (b - matvec(x.reshape(vshape))).reshape(n)
        rn_x = torch.sqrt(_dot(r_true, r_true).real)
        rn_x_h = rdt.type(host_sync(rn_x))
    return CGResult(
        x=x.reshape(vshape),
        iterations=k * s,
        rnorm=rn_x,
        rnorm0=torch.sqrt(rnorm2_0_t),
        converged=bool(rn_x_h / max(rnorm0, tiny) < rtol),
        r=r_true.reshape(vshape),
        p=None,
    )
