"""Block CG (O'Leary 1980): solve A X = B for nrhs right-hand sides at once.

Counterpart of ``spmv_tpu.solvers.block_cg``. One block apply per
iteration (the SpMM kernels read the matrix once for the whole block);
the block recurrences are small (nrhs, nrhs) dense solves. Vectors live
in the SpMM lane layout (rows, nrhs*128), element (i, r*128 + j) being flat
element i*128 + j of column r (``ops/spmm_dia.py``), so repeated applies
chain with no data movement; block dots and updates view it as
(rows, nrhs, 128).

Rank deficiency (columns converging early make P^T A P singular) is
handled as the reference does: the small solves carry a ridge of
(trace/nrhs + tiny) * eps * 16, which leaves well-conditioned blocks
untouched.

The reference runs its loops on the device (``lax.while_loop``); here
each is a Python loop with one host sync per iteration, for the
convergence test, as in ``solvers/cg.py``. The refined solvers' outer
loop is the reference's block loop (one pass in which every column
contracts by less than 0.5x stops it), not ``solvers/refine._refine``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from spmv_torch.ds import ds_add, ds_from_f64
from spmv_torch.formats.csr import CSRHost
from spmv_torch.formats.dia import LANES, csr_to_dia
from spmv_torch.ops.spmm_dia import spmm_dia_2d, spmm_from_layout, spmm_to_layout
from spmv_torch.ops.spmv_dia_cuda import spmv_dia_2d
from spmv_torch.ops.spmv_dia_ds import csr_to_dia_ds, spmm_dia_ds_2d


@dataclasses.dataclass
class BlockCGResult:
    x: torch.Tensor        # (rows, nrhs*128) lane layout
    iterations: int        # block iterations (= block applies after the first)
    rnorm: torch.Tensor    # (nrhs,) final per-column |r|_2
    rnorm0: torch.Tensor   # (nrhs,)
    converged: bool        # every column below rtol


def _as3(v: torch.Tensor, nrhs: int) -> torch.Tensor:
    return v.reshape(v.shape[0], nrhs, LANES)


def block_cg(
    matmat: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    nrhs: int,
    x0: torch.Tensor | None = None,
    kmax: int = 100,
    rtol: float = 1e-10,
    independent: bool = False,
) -> BlockCGResult:
    """Solve SPD A X = B. ``b`` is (rows, nrhs*128) in the SpMM lane layout
    (zero padding entries); ``matmat`` maps that layout to itself (e.g.
    ``DistMatrix.matmat``). Stops when EVERY column's relative residual is
    below ``rtol``.

    ``independent=True`` runs nrhs simultaneous single-vector CGs (diagonal
    alpha/beta instead of the coupled (nrhs, nrhs) block solves) that still
    share one block apply per iteration: single-vector CG's stability at
    the block's matrix traffic. The refined solvers use it for their inner
    passes (the coupled recurrences lose conjugacy in fp32 after a few
    hundred iterations on ill-conditioned systems)."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    fi = torch.finfo(b.dtype)
    eps, tiny = fi.eps, fi.tiny
    if independent:
        return _simultaneous_cg(matmat, b, nrhs, x0, kmax, rtol, tiny)

    def gram(u, v):
        """(nrhs, nrhs) block dot in the lane layout."""
        return torch.einsum("rac,rbc->ab", _as3(u, nrhs), _as3(v, nrhs))

    def colmix(u, m):
        """u @ m over the column axis: out[:, b] = sum_a u[:, a] m[a, b]."""
        return torch.einsum("rac,ab->rbc", _as3(u, nrhs), m.to(b.dtype)).reshape(u.shape)

    eye = torch.eye(nrhs, dtype=b.dtype, device=b.device)

    def rsolve(m, rhs):
        """The small SPD-ish (nrhs, nrhs) solve with a trace-scaled ridge:
        identity action on well-conditioned blocks, keeps converged
        (near-zero) columns from blowing up the others."""
        ridge = (torch.trace(m) / nrhs + tiny) * eps * 16
        return torch.linalg.solve(m + ridge * eye, rhs)

    def rel(gamma):
        rn = torch.sqrt(torch.clamp(torch.diagonal(gamma), min=0))
        return rn, rn / torch.clamp(rnorm0, min=tiny)

    r = b - matmat(x0)
    gamma = gram(r, r)
    rnorm0 = torch.sqrt(torch.clamp(torch.diagonal(gamma), min=0))
    x, p = x0, r
    k = 0
    while k < kmax and bool((rel(gamma)[1] >= rtol).any()):
        q = matmat(p)                      # one matrix pass for the block
        alpha = rsolve(gram(p, q), gamma)  # (nrhs, nrhs)
        x = x + colmix(p, alpha)
        r = r - colmix(q, alpha)
        gamma_new = gram(r, r)
        beta = rsolve(gamma, gamma_new)
        p = r + colmix(p, beta)
        gamma = gamma_new
        k += 1
    rnorm, rr = rel(gamma)
    return BlockCGResult(x=x, iterations=k, rnorm=rnorm, rnorm0=rnorm0,
                         converged=bool((rr < rtol).all()))


def _simultaneous_cg(matmat, b, nrhs, x0, kmax, rtol, tiny) -> BlockCGResult:
    """nrhs independent CG recurrences over one shared block apply per
    iteration (see block_cg(independent=True))."""

    def dots(u, v):
        return torch.einsum("rac,rac->a", _as3(u, nrhs), _as3(v, nrhs))

    def colscale(u, s):
        return (_as3(u, nrhs) * s[None, :, None].to(b.dtype)).reshape(u.shape)

    def rel(gamma):
        rn = torch.sqrt(torch.clamp(gamma, min=0))
        return rn, rn / torch.clamp(rnorm0, min=tiny)

    r = b - matmat(x0)
    gamma = dots(r, r)
    rnorm0 = torch.sqrt(torch.clamp(gamma, min=0))
    x, p = x0, r
    k = 0
    while k < kmax and bool((rel(gamma)[1] >= rtol).any()):
        q = matmat(p)
        alpha = gamma / torch.clamp(dots(p, q), min=tiny)
        # freeze converged columns (their alpha would be noise over noise)
        live = rel(gamma)[1] >= rtol
        alpha = torch.where(live, alpha, 0)
        x = x + colscale(p, alpha)
        r = r - colscale(q, alpha)
        gamma_new = dots(r, r)
        beta = torch.where(live, gamma_new / torch.clamp(gamma, min=tiny), 0)
        p = r + colscale(p, beta)
        gamma = gamma_new
        k += 1
    rnorm, rr = rel(gamma)
    return BlockCGResult(x=x, iterations=k, rnorm=rnorm, rnorm0=rnorm0,
                         converged=bool((rr < rtol).all()))


def block_cg_dia(a, B, kmax: int = 100, rtol: float = 1e-10
                 ) -> tuple[torch.Tensor, BlockCGResult]:
    """Convenience wiring for a DiaMatrix ``a`` (on its device): B is
    (n, nrhs) columns; returns (X (n, nrhs), BlockCGResult). Each block
    iteration is one block kernel launch (``dia_spmm``, or
    ``dia_sym_spmm`` for symmetric storage)."""
    n, nrhs = B.shape
    b2 = spmm_to_layout(a, torch.as_tensor(B, dtype=a.dtype))
    res = block_cg(lambda x2: spmm_dia_2d(a, x2), b2, nrhs, kmax=kmax, rtol=rtol)
    return spmm_from_layout(res.x, nrhs)[:n], res


def _check_inner(inner_solver: str) -> None:
    if inner_solver not in ("cg", "chebyshev"):
        raise ValueError(f"unknown inner_solver {inner_solver!r}")


def _inner(inner_solver: str, matvec, v0: torch.Tensor, inner_kmax: int,
           inner_rtol: float):
    """The refinement's inner block solve, ``(matmat, r2, nrhs) ->
    result``: independent block CG, or (``"chebyshev"``) the reference's
    reduction-free adaptive Chebyshev sweeps, 16 steps a sweep, between
    bounds from a 48-step Lanczos run of ``matvec`` from ``v0``."""
    if inner_solver == "cg":
        return lambda matmat, r2, nrhs: block_cg(
            matmat, r2, nrhs, kmax=inner_kmax, rtol=inner_rtol, independent=True)
    from spmv_torch.solvers.chebyshev import chebyshev_adaptive, chebyshev_bounds

    lo, hi = (float(t) for t in chebyshev_bounds(matvec, v0, m=48))
    return lambda matmat, r2, nrhs: chebyshev_adaptive(
        matmat, r2, lo, hi, rtol=inner_rtol, sweep_iters=16,
        max_sweeps=-(-inner_kmax // 16))


def _refine_block(matmat, matmat_ds, bh, bl, bnorm, rtol, max_outer, inner):
    """The reference's block refinement loop (``block_cg.py:367-393``) over
    an fp32 block apply ``matmat`` and its double-single twin ``matmat_ds``,
    for the (hi, lo) right-hand-side blocks ``bh``, ``bl`` in the lane
    layout, with the inner solver ``inner`` (``_inner``). Returns
    ((xh, xl), outer passes, inner iterations, final per-column |r|)."""
    nrhs = bh.shape[1] // LANES
    x = [torch.zeros_like(bh), torch.zeros_like(bh)]

    def residual():
        # the high plane: the correctly rounded f32 image of the exactly
        # accumulated residual, all the fp32 inner solve can consume
        yh, yl = matmat_ds(*x)
        rh, _ = ds_add(bh, bl, -yh, -yl)
        return rh, _col_norms(rh, nrhs)

    inner_total = 0
    history = []
    corrected = False  # True while the last inner update is unmeasured
    for _ in range(max_outer):
        rh, rnorms = residual()
        corrected = False
        history.append(rnorms.copy())
        if np.all(rnorms <= rtol * bnorm):
            break
        if len(history) > 1 and np.all(rnorms > 0.5 * history[-2]):
            break  # stalled at the kappa * eps_ds floor
        # each column scaled to unit norm for the fp32 inner solve
        res = inner(matmat, _scaled(rh, 1.0 / np.maximum(rnorms, 1e-300), nrhs),
                    nrhs)
        inner_total += res.iterations
        dh = _scaled(res.x, rnorms, nrhs)
        x[:] = ds_add(*x, dh, torch.zeros_like(dh))
        corrected = True
    if corrected:
        # the loop ran out with a correction applied after the last
        # measurement: measure once more, so the last entry describes the
        # returned X
        history.append(residual()[1].copy())
    return x, len(history), inner_total, history[-1]


def _col_norms(rh: torch.Tensor, nrhs: int) -> np.ndarray:
    v3 = _as3(rh, nrhs)
    return torch.sqrt(torch.einsum("rnc,rnc->n", v3, v3)).cpu().numpy().astype(np.float64)


def _scaled(v: torch.Tensor, s, nrhs: int) -> torch.Tensor:
    """Column r of the lane-layout block times s[r] (float32, on v's
    device)."""
    s = torch.as_tensor(np.asarray(s, np.float32), device=v.device)
    return (_as3(v, nrhs) * s[None, :, None]).reshape(v.shape)


def block_cg_refined(
    a: CSRHost,
    B,
    rtol: float = 1e-12,
    max_outer: int = 10,
    inner_kmax: int = 400,
    inner_rtol: float = 1e-4,
    inner_solver: str = "cg",
    *,
    device="cuda",
):
    """float64-class multi-RHS solves at fp32 block speed, on one device
    (the card unless the caller asks for another).

    Wilkinson refinement around fp32 block CG: double-single TRUE residuals
    (the DS block kernel ``dia_ds_spmm``, both matrix planes read once for
    every column) restore accuracy to the kappa * 2^-48 floor, and each
    outer pass restarts the inner simultaneous CG (``dia_spmm``, one
    launch per inner iteration). ``a``: host CSR, banded (DIA-convertible)
    and SPD; ``B``: (n, nrhs). ``inner_solver="chebyshev"`` replaces the
    inner CG by reduction-free adaptive Chebyshev sweeps (``dia_spmm`` as
    well). For general sparsity use
    ``block_cg_refined_dist(..., local_format="well")``. Returns
    (X (n, nrhs) float64, outer passes, inner iterations, final per-column
    true residual norms)."""
    _check_inner(inner_solver)
    B = np.asarray(B, np.float64)
    n, nrhs = B.shape
    d32 = csr_to_dia(a, row_align=1024, dtype=np.float32, device=device)
    dds = csr_to_dia_ds(a, row_align=1024, device=device)
    npad = dds.nrows_pad
    bh, bl = (spmm_to_layout(dds, p)
              for p in ds_from_f64(np.pad(B, ((0, npad - n), (0, 0)))))
    v0 = np.zeros(npad, np.float32)
    v0[:n] = np.random.default_rng(0).standard_normal(n)
    solver = _inner(inner_solver, lambda u: spmv_dia_2d(d32, u),
                    torch.as_tensor(v0.reshape(-1, LANES), device=device),
                    inner_kmax, inner_rtol)
    x, outer, inner, rnorms = _refine_block(
        lambda v: spmm_dia_2d(d32, v), lambda h, lo: spmm_dia_ds_2d(dds, h, lo),
        bh, bl, np.linalg.norm(B, axis=0), rtol, max_outer, solver)
    X = sum(spmm_from_layout(t, nrhs).cpu().numpy().astype(np.float64) for t in x)
    return X[:n], outer, inner, rnorms


def block_cg_refined_dist(
    a: CSRHost,
    B,
    n_devices: int = 1,
    rtol: float = 1e-12,
    max_outer: int = 10,
    inner_kmax: int = 400,
    inner_rtol: float = 1e-4,
    inner_solver: str = "cg",
    local_format: str = "dia",
    *,
    device="cuda",
):
    """Distributed float64-class multi-RHS solves at fp32 block speed.

    Inner iterations run the fp32 block apply of a DistMatrix with
    ``n_devices`` stacked shards (``matmat``: one block kernel launch and
    one block halo per iteration); true residuals run its double-single
    twin's ``matmat_ds`` (the DS block kernel, the DS block halo).
    ``inner_solver``: "cg" or "chebyshev" (as in ``block_cg_refined``;
    its bounds from a Lanczos run of ``matvec``).
    ``local_format``: "dia" (banded operators) or "well" (general
    sparsity; RCM-reorder first to keep the window split tight). ``a``:
    global host CSR (SPD); ``B``: (n, nrhs) float64. Returns
    (X (n, nrhs) float64, outer passes, inner iterations, final per-column
    true residual norms)."""
    from spmv_torch.parallel.dist_matrix import build_dist_matrix

    if local_format not in ("dia", "well"):
        raise ValueError("local_format must be 'dia' or 'well'")
    _check_inner(inner_solver)
    B = np.asarray(B, np.float64)
    n, nrhs = B.shape
    a32 = build_dist_matrix(a, n_devices=n_devices, dtype=np.float32,
                            local_format=local_format, device=device)
    ads = build_dist_matrix(a, n_devices=n_devices,
                            local_format=local_format + "_ds", device=device)
    if a32.col_pad != ads.col_pad:
        raise AssertionError("fp32/DS layouts must coincide")
    bh, bl = (ads.to_dist_block(p) for p in ds_from_f64(B))
    v0 = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    solver = _inner(inner_solver, a32.as_linear_operator(), a32.to_dist(v0),
                    inner_kmax, inner_rtol)
    x, outer, inner, rnorms = _refine_block(
        a32.matmat, ads.matmat_ds, bh, bl, np.linalg.norm(B, axis=0), rtol,
        max_outer, solver)
    X = sum(ads.from_dist_block(t).astype(np.float64) for t in x)
    return X[:n], outer, inner, rnorms
