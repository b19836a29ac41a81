"""GMRES(m) — restarted GMRES for general (non-symmetric) systems, and
FGMRES.

Counterpart of ``spmv_tpu.solvers.gmres``, with its choices:
- classical Gram-Schmidt applied twice (CGS2): each pass projects the new
  vector against the whole basis in one (m+1, n) @ (n,) product (at the
  vectors' full precision: torch's default matmul precision, no TF32);
- the Hessenberg column is reduced at once by Givens rotations, so every
  Arnoldi step has a running residual estimate |g[j+1]|, and the cycle
  stops early on lucky breakdown (the new vector vanishes relative to
  |A v_j|) and on mid-cycle convergence: a cycle that converges at step j
  costs j applies, not m;
- right preconditioning, with the convergence test on the true residual
  b - A x computed at the end of each cycle (that residual starts the next
  cycle, so a cycle costs its steps plus one apply);
- ``flexible=True`` (FGMRES) keeps the preconditioned directions
  z_j = M^-1 v_j as a second basis and builds the update from them, so the
  preconditioner may change between applies.

The basis and the projections stay on the vectors' device. The small
scalar work of a step (the column's rotations, the new rotation, the
residual estimate) runs on the host in the vectors' dtype, numpy scalars of
it, after one host sync that reads the column's m + 2 numbers; the final
least-squares solve is a back-substitution on the rotated R there too.
Complex vectors work as in the reference (conjugating rotations).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from spmv_torch.solvers.cg import _dot


@dataclasses.dataclass
class GMRESResult:
    x: torch.Tensor
    iterations: int        # total Arnoldi steps (one apply each)
    cycles: int            # restart cycles run
    rnorm: torch.Tensor    # final true |r|_2 (0-d)
    rnorm0: torch.Tensor
    converged: bool


def _np_dtype(dtype: torch.dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


def _real_norm(v: torch.Tensor) -> torch.Tensor:
    d = _dot(v, v)
    return torch.sqrt(d.real if d.is_complex() else d)


def gmres(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    restart: int = 30,
    max_cycles: int = 20,
    rtol: float = 1e-10,
    preconditioner: Callable[[torch.Tensor], torch.Tensor] | None = None,
    flexible: bool = False,
) -> GMRESResult:
    """Solve A x = b with restarted GMRES(m), m = ``restart``, at most
    ``max_cycles`` cycles. Vectors keep b's (padded) shape; padding entries
    of b must be zero. A warm start from a saved solution (``x0``) is the
    exact resume, since every cycle rebuilds its Krylov space from the
    current residual."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    precond = preconditioner if preconditioner is not None else (lambda r: r)
    m = restart
    vshape, n_flat = b.shape, b.numel()
    cdt = _np_dtype(b.dtype)                    # the vectors' dtype
    rdt = np.finfo(cdt).dtype                   # its real counterpart
    tiny = rdt.type(np.finfo(cdt).tiny)
    releps = rdt.type(np.finfo(cdt).eps * 8)
    one_c, zero_c = cdt.type(1), cdt.type(0)

    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    x = x0
    r = b - matvec(x0)
    rnorm0 = _real_norm(r)
    rnorm0_h = rdt.type(host(rnorm0))
    rnorm = rnorm0
    k_total = cycles = 0
    while cycles < max_cycles and rdt.type(host(rnorm)) / max(rnorm0_h, tiny) >= rtol:
        beta = rdt.type(host(_real_norm(r)))
        basis = torch.zeros((m + 1, n_flat), dtype=b.dtype, device=b.device)
        basis[0] = r.reshape(n_flat) / torch.as_tensor(max(beta, tiny), dtype=b.dtype)
        zbasis = (torch.zeros((m, n_flat), dtype=b.dtype, device=b.device)
                  if flexible else None)
        h = np.zeros((m + 1, m), dtype=cdt)     # rotated columns: R
        cs = np.zeros(m, dtype=rdt)
        sn = np.zeros(m, dtype=cdt)
        g = np.zeros(m + 1, dtype=cdt)
        g[0] = beta
        steps = 0
        while steps < m:
            j = steps
            zj = precond(basis[j].reshape(vshape)).reshape(n_flat)
            if flexible:
                zbasis[j] = zj
            w = matvec(zj.reshape(vshape)).reshape(n_flat)
            # CGS2: two passes of projecting against the basis (its rows
            # past j are still zero, so they project to zero)
            coeffs = torch.zeros(m + 1, dtype=b.dtype, device=b.device)
            for _ in range(2):
                proj = basis.conj() @ w
                w = w - proj @ basis
                coeffs = coeffs + proj
            wnorm_t = _real_norm(w)
            col = host(torch.cat([coeffs, wnorm_t.to(b.dtype).reshape(1)]))
            hcol, wnorm = col[: m + 1].copy(), rdt.type(col[m + 1].real)
            # lucky breakdown: w vanished relative to the unprojected
            # |A z_j|; the column stays valid (h[j+1, j] = 0)
            wscale = np.sqrt(rdt.type(np.sum(np.abs(hcol) ** 2)) + wnorm * wnorm)
            brk = wnorm <= max(releps * wscale, tiny * 4)
            if not brk:
                basis[j + 1] = w / torch.as_tensor(max(wnorm, tiny), dtype=b.dtype)
            hcol[j + 1] = wnorm
            for i in range(j):  # the existing rotations
                a_, b_ = hcol[i], hcol[i + 1]
                hcol[i] = cs[i] * a_ + sn[i] * b_
                hcol[i + 1] = -np.conj(sn[i]) * a_ + cs[i] * b_
            # the new rotation zeroing hcol[j+1]: [[c, s], [-conj(s), c]]
            a_, b_ = hcol[j], hcol[j + 1]
            aabs = rdt.type(np.abs(a_))
            t = np.sqrt(aabs * aabs + rdt.type(np.abs(b_)) ** 2)
            phase = one_c if aabs <= tiny else a_ / cdt.type(max(aabs, tiny))
            if t <= tiny * 4:  # a dead step: the identity rotation
                c_new, s_new = rdt.type(1), zero_c
            else:
                c_new = aabs / max(t, tiny)
                s_new = phase * np.conj(b_) / cdt.type(max(t, tiny))
            hcol[j] = cdt.type(t) * phase
            hcol[j + 1] = zero_c
            h[:, j] = hcol
            cs[j], sn[j] = c_new, s_new
            gj = g[j]
            g[j], g[j + 1] = c_new * gj, -np.conj(s_new) * gj
            steps += 1
            # the running residual estimate: leave the cycle once it clears
            # rtol, or once the Krylov space is invariant
            if brk or rdt.type(np.abs(g[j + 1])) < rtol * max(rnorm0_h, tiny):
                break
        y = np.zeros(m, dtype=cdt)
        for i in range(steps - 1, -1, -1):  # back-substitution on R
            y[i] = (g[i] - h[i, i + 1:steps] @ y[i + 1:steps]) / h[i, i]
        yt = torch.as_tensor(y[:steps], device=b.device)
        if flexible:
            x = x + (yt @ zbasis[:steps]).reshape(vshape)
        else:
            x = x + precond((yt @ basis[:steps]).reshape(vshape))
        # the true residual, which also starts the next cycle
        r = b - matvec(x)
        rnorm = _real_norm(r)
        k_total += steps
        cycles += 1
    return GMRESResult(
        x=x, iterations=k_total, cycles=cycles, rnorm=rnorm, rnorm0=rnorm0,
        converged=bool(rdt.type(host(rnorm)) / max(rnorm0_h, tiny) < rtol))
