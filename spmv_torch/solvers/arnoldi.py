"""Arnoldi Ritz-value estimation for general (non-symmetric) operators.

Counterpart of ``spmv_tpu.solvers.arnoldi`` (``arnoldi_factorization``
:34, ``ArnoldiRitz`` :90, ``arnoldi_ritz`` :98). The companion of
``solvers/lanczos.py`` for operators that are not symmetric: m applies
give the leading Ritz values (spectral radius, rightmost eigenvalue), and
the Newton s-step basis (``solvers/newton_basis.py``) takes its shifts
from them.

The split is the reference's:
- the factorization (the applies and the CGS2 orthogonalization, the only
  part that touches the operator) runs on the vectors' device with no host
  sync: the breakdown test is a device flag that zeroes the basis and the
  Hessenberg columns from the breakdown step on, as the reference's
  ``lax.scan`` does (``solvers/lanczos.py`` does the same);
- the extraction (the eigenproblem of the m x m Hessenberg) runs on the
  host in numpy, after one read of H.

Ritz residual bounds are |h_{m+1,m}| * |last eigenvector component|, the
certificate ``lanczos_extreme_with_bounds`` gives in the symmetric case.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


def arnoldi_factorization(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v0: torch.Tensor,
    m: int = 48,
) -> torch.Tensor:
    """m-step Arnoldi, A V_m = V_{m+1} H: returns the (m+1, m) Hessenberg H
    on v0's device. ``v0`` must be nonzero and zero on any padding rows.
    On lucky breakdown at step j the remaining columns of H are zero and
    the leading j x j block is exact (an invariant subspace)."""
    cdtype = v0.dtype
    rdtype = v0.real.dtype if v0.is_complex() else v0.dtype
    fi = torch.finfo(v0.dtype)
    dev = v0.device
    tiny = torch.tensor(fi.tiny, dtype=rdtype, device=dev)
    releps = torch.tensor(fi.eps, dtype=rdtype, device=dev) * 8
    vshape = v0.shape
    n_flat = v0.numel()

    def rnorm(w):
        return torch.sqrt(torch.vdot(w, w).real.to(rdtype))

    flat0 = v0.reshape(n_flat)
    basis = torch.zeros((m + 1, n_flat), dtype=cdtype, device=dev)
    basis[0] = flat0 / torch.maximum(rnorm(flat0), tiny).to(cdtype)
    h = torch.zeros((m + 1, m), dtype=cdtype, device=dev)
    live = torch.ones((), dtype=torch.bool, device=dev)
    idx = torch.arange(m + 1, device=dev)
    for j in range(m):
        w = matvec(basis[j].reshape(vshape)).reshape(n_flat)
        mask = (idx <= j).to(cdtype)
        coeffs = torch.zeros(m + 1, dtype=cdtype, device=dev)
        for _ in range(2):  # CGS2: batched dots against the whole basis
            proj = (basis.conj() @ w) * mask
            w = w - proj @ basis
            coeffs = coeffs + proj
        wnorm = rnorm(w)
        wscale = torch.sqrt(torch.sum(torch.abs(coeffs) ** 2).to(rdtype) + wnorm ** 2)
        brk = wnorm <= torch.maximum(releps * wscale, tiny * 4)
        # on breakdown an exact zero subdiagonal, so the host extraction
        # truncates to the invariant block
        sub = torch.where(brk, torch.zeros_like(wnorm), wnorm).to(cdtype)
        hcol = torch.cat([coeffs[: j + 1], sub.reshape(1), coeffs[j + 2:]])
        # after breakdown the process is dead: zero columns keep H exactly
        # block-triangular
        h[:, j] = torch.where(live, hcol, torch.zeros_like(hcol))
        basis[j + 1] = torch.where(live & ~brk, w / torch.maximum(wnorm, tiny).to(cdtype),
                                   torch.zeros_like(w))
        live = live & ~brk
    return h


@dataclasses.dataclass
class ArnoldiRitz:
    values: np.ndarray        # (m,) complex Ritz values, by decreasing modulus
    residuals: np.ndarray     # (m,) |h_{m+1,m} * y_m[i]| error certificates
    spectral_radius: float    # max |theta| (a lower bound on rho(A))
    rightmost: complex        # the Ritz value of largest real part
    steps: int                # Arnoldi steps that carry information


def arnoldi_ritz(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v0: torch.Tensor,
    m: int = 48,
) -> ArnoldiRitz:
    """Leading Ritz values of the operator behind ``matvec`` from an m-step
    Arnoldi run started at ``v0``: the factorization on the vectors'
    device, the Hessenberg eigendecomposition on the host. The extreme
    eigenvalues (spectral radius, rightmost) converge first; interior Ritz
    values are approximations only."""
    h = arnoldi_factorization(matvec, v0, m).cpu().numpy()
    # the informative prefix: columns up to the first zero subdiagonal
    sub = np.abs(np.diagonal(h, offset=-1))
    nz = np.nonzero(sub == 0.0)[0]
    k = int(nz[0]) + 1 if len(nz) else m
    k = min(k, m)
    theta, y = np.linalg.eig(h[:k, :k])
    # |h_{k+1,k}|: zero on lucky breakdown, where the k x k block is an
    # exact restriction to an invariant subspace
    resid = sub[k - 1] * np.abs(y[-1, :])
    order = np.argsort(-np.abs(theta))
    theta, resid = theta[order], resid[order]
    return ArnoldiRitz(
        values=theta,
        residuals=resid,
        spectral_radius=float(np.max(np.abs(theta))) if len(theta) else 0.0,
        rightmost=complex(theta[np.argmax(theta.real)]) if len(theta) else 0j,
        steps=k,
    )
