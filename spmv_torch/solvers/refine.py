"""Mixed-precision iterative refinement: float64-class solves from fp32 CG.

Counterpart of ``spmv_tpu.solvers.refine``. Wilkinson refinement with a
double-single residual:

    repeat:
        r = b - A x          # double-single SpMV (DS kernel), exact to ~2^-48
        d ~= A^{-1} r        # inner CG in fp32 (the fp32 kernel), loose tol
        x = x + d            # accumulated in double-single

Each outer pass multiplies the error by about the inner tolerance, down to
the attainable floor of about kappa * 2^-48 relative; the loop stops when
the residual reaches ``rtol * |b|`` or stalls there (two consecutive passes
that each contract by less than 0.95x). The outer loop runs on the host;
the hot work is the fp32 CG and the DS SpMV on the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spmv_torch.ds import ds_add, ds_from_f64, ds_to_f64
from spmv_torch.formats.csr import CSRHost
from spmv_torch.formats.dia import LANES, csr_to_dia
from spmv_torch.ops.spmv_dia_cuda import spmv_dia_2d
from spmv_torch.ops.spmv_dia_ds import csr_to_dia_ds, spmv_dia_ds_2d
from spmv_torch.solvers.cg import cg


@dataclasses.dataclass
class RefineResult:
    x: np.ndarray            # float64 solution (length nrows)
    outer_iterations: int
    inner_iterations: int
    rnorm: float             # final residual norm (the DS residual's hi plane)
    converged: bool
    history: list            # per-outer-pass |r|


def _refine(residual, inner_solve, update, bnorm: float, rtol: float,
            max_outer: int):
    """The reference's outer loop. ``residual()`` -> (r hi plane, |r|);
    ``inner_solve(r, scale)`` -> (d, iterations); ``update(d, rnorm,
    scale)`` accumulates x. Returns (history, inner total, converged)."""
    history = []
    inner_total = 0
    converged = False
    stalls = 0
    for _ in range(max_outer):
        rh, rnorm = residual()
        history.append(rnorm)
        if rnorm <= rtol * bnorm:
            converged = True
            break
        if len(history) > 1 and rnorm > 0.95 * history[-2]:
            stalls += 1
            if stalls >= 2:
                # two consecutive near-flat passes: the attainable floor
                # (~ kappa * 2^-48 relative); a single slow pass is not a
                # stall, since contraction per pass is ~eps_f32 * kappa
                break
        else:
            stalls = 0
        # scale the residual to unit norm: keeps the fp32 inner solve away
        # from under/overflow as r shrinks
        scale = np.float32(1.0 / max(rnorm, 1e-300))
        d, it = inner_solve(rh, float(scale))
        inner_total += it
        update(d, rnorm, scale)
    return history, inner_total, converged


def _result(x, history, inner_total, converged) -> RefineResult:
    return RefineResult(
        x=x,
        outer_iterations=len(history) - (1 if converged else 0),
        inner_iterations=inner_total,
        rnorm=history[-1],
        converged=converged,
        history=history,
    )


def cg_refined(
    a: CSRHost,
    b: np.ndarray,
    rtol: float = 1e-12,
    max_outer: int = 6,
    inner_rtol: float = 1e-6,
    inner_kmax: int = 500,
    jacobi: bool = False,
    *,
    device="cuda",
) -> RefineResult:
    """Solve SPD ``a x = b`` to a float64-class true residual with fp32
    compute, on one device (the card unless the caller asks for another).
    ``a`` must be banded (DIA-convertible): the inner solves run the fp32
    DIA operator, the residuals its double-single twin. ``jacobi=True``
    diagonal-scales the fp32 inner solves."""
    d32 = csr_to_dia(a, row_align=1024, dtype=np.float32, device=device)
    dds = csr_to_dia_ds(a, row_align=1024, device=device)
    npad = dds.nrows_pad
    n = a.nrows

    def lanes(v):
        return torch.as_tensor(v.reshape(-1, LANES), device=device)

    bh, bl = ds_from_f64(np.pad(np.asarray(b, np.float64), (0, npad - n)))
    bh2, bl2 = lanes(bh), lanes(bl)
    bnorm = float(np.linalg.norm(b))

    precond = None
    if jacobi:
        rows = np.repeat(np.arange(n), a.row_nnz())
        on_diag = a.colind == rows
        diag = np.zeros(npad, np.float32)
        diag[rows[on_diag]] = a.values[on_diag]
        diag2 = lanes(diag)
        nz = diag2 != 0
        safe = torch.where(nz, diag2, torch.ones_like(diag2))

        def precond(r2):
            return torch.where(nz, r2 / safe, r2)

    x = [torch.zeros_like(bh2), torch.zeros_like(bh2)]

    def residual():
        # high plane only: the correctly rounded f32 image of the exactly
        # accumulated residual, all the fp32 inner solve can consume
        yh, yl = spmv_dia_ds_2d(dds, *x)
        rh, _ = ds_add(bh2, bl2, -yh, -yl)
        return rh, float(torch.linalg.vector_norm(rh.reshape(-1)[:n]))

    def inner_solve(rh, scale):
        res = cg(lambda p: spmv_dia_2d(d32, p), rh * scale, kmax=inner_kmax,
                 rtol=inner_rtol, preconditioner=precond)
        return res.x, res.iterations

    def update(d, rnorm, scale):
        # x += d / scale, accumulated in double-single
        dh = d * float(np.float32(1.0 / float(scale)))
        x[:] = ds_add(*x, dh, torch.zeros_like(dh))

    history, inner_total, converged = _refine(residual, inner_solve, update,
                                              bnorm, rtol, max_outer)
    xs = ds_to_f64(x[0].cpu().numpy().reshape(-1), x[1].cpu().numpy().reshape(-1))
    return _result(xs[:n], history, inner_total, converged)


def cg_refined_dist(
    a: CSRHost,
    b: np.ndarray,
    n_devices: int = 1,
    rtol: float = 1e-12,
    max_outer: int = 8,
    inner_rtol: float = 1e-6,
    inner_kmax: int = 500,
    jacobi: bool = False,
    amg: bool | dict = False,
    local_format: str = "dia",
    *,
    device="cuda",
) -> RefineResult:
    """Distributed mixed-precision refinement: fp32 inner CG on a
    DistMatrix with ``n_devices`` stacked shards, double-single residuals
    through its DS twin's ``matvec_ds`` (DS halo exchange + DS kernels).
    ``local_format``: "dia" for banded operators, "well" for general
    sparsity (RCM-reorder first for window locality). ``jacobi=True``
    diagonal-scales the inner solves. ``amg`` preconditions the fp32 inner
    solves with an AMG hierarchy built on the internal fp32 operator: True
    picks the reference's configuration (interval2d 4x4 grid blocks and a
    W-cycle where a grid stride is detected, matching otherwise); a dict
    passes through to ``amg_setup``."""
    if local_format not in ("dia", "well"):
        raise ValueError("local_format must be 'dia' or 'well'")
    from spmv_torch.parallel.dist_matrix import build_dist_matrix

    a32 = build_dist_matrix(a, n_devices=n_devices, dtype=np.float32,
                            local_format=local_format, device=device)
    ads = build_dist_matrix(a, n_devices=n_devices,
                            local_format=local_format + "_ds", device=device)
    precond = a32.jacobi_preconditioner() if jacobi else None
    if amg:
        from spmv_torch.solvers.amg import _detect_strides, amg_setup

        kw: dict = dict(local_format=local_format)
        if isinstance(amg, dict):
            kw.update(amg)
        elif _detect_strides(a):
            # grid-like operator: the mesh-independent 2-D grid-block
            # configuration (demo_cg --amg-aggregate auto)
            kw.update(aggregate="interval2d", interval_size=4, cycle=2)
        precond = amg_setup(a, a32, **kw).as_preconditioner()
    n = a.nrows
    bh, bl = ds_from_f64(np.asarray(b, np.float64))
    bh_d, bl_d = a32.to_dist(bh), a32.to_dist(bl)
    bnorm = float(np.linalg.norm(b))
    x = [torch.zeros_like(bh_d), torch.zeros_like(bh_d)]

    def residual():
        # high plane only, as in cg_refined
        yh, yl = ads.matvec_ds(*x)
        rh, _ = ds_add(bh_d, bl_d, -yh, -yl)
        return rh, float(torch.linalg.vector_norm(rh))

    def inner_solve(rh, scale):
        res = cg(a32.as_linear_operator(), rh * scale, kmax=inner_kmax,
                 rtol=inner_rtol, preconditioner=precond)
        return res.x, res.iterations

    def update(d, rnorm, scale):
        dh = d * float(np.float32(rnorm))
        x[:] = ds_add(*x, dh, torch.zeros_like(dh))

    history, inner_total, converged = _refine(residual, inner_solve, update,
                                              bnorm, rtol, max_outer)
    xs = ds_to_f64(a32.from_dist(x[0]), a32.from_dist(x[1]))
    return _result(xs[:n], history, inner_total, converged)
