#!/usr/bin/env python
"""demo_eig — distributed eigenpair, singular-value and log-determinant CLI
(PyTorch/CUDA port).

Counterpart of ``spmv_tpu/demos/demo_eig.py``, with the same flags and
printed lines: the k smallest (or largest) eigenpairs of a symmetric
operator by LOBPCG, whose hot operation is the block apply
``DistMatrix.matmat`` in the SpMM lane layout (on the default DIA operator,
the ``dia_spmm`` kernel), optionally behind a Chebyshev filter
(``--cheb``); the leading Ritz values of a nonsymmetric operator by
Arnoldi (``--arnoldi``, ELL); the k largest singular triplets by
Golub-Kahan (``--svd``, on A and ``A.transposed()``); log det A by
stochastic Lanczos quadrature (``--logdet``, with the dense ``slogdet``
beside it for n <= 8192). Each result is checked on the host against the
CSR oracle, as the reference demo does. ``--cpu``, which the reference
uses to pick JAX's CPU backend, is ``--device cpu`` here.

The reference compiles each solve, runs it once to warm up and times a
second run; here one apply warms up (it builds the CUDA kernels on first
use) and the solve runs once. The SLQ probes come from a
``torch.Generator`` seeded with ``--seed``, so ``--logdet`` differs from
the reference's estimate by Monte-Carlo noise (ROADMAP.md §3).

Usage:
  python -m spmv_torch.demos.demo_eig --lap2d 1024 -k 4 --cheb 16 --maxiter 100
  python -m spmv_torch.demos.demo_eig --lap2d 1024 --svd 48 -k 4
  python -m spmv_torch.demos.demo_eig --lap2d 3200 --logdet 32 --probes 16
  python -m spmv_torch.demos.demo_eig --convdiff 1024 --arnoldi 60
  python -m spmv_torch.demos.demo_eig --petsc A.petsc -k 2 --largest
  python -m spmv_torch.demos.demo_eig --lap2d 64 -k 4 --cheb 16 --device cpu
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

# flags of the reference demo that this port does not run (ROADMAP.md),
# with the reference's argparse settings
_NOT_PORTED = {
    "--cpu": dict(action="store_true"),
}


def convection_diffusion(g: int):
    """The reference demo's --convdiff operator (:106-124): the g x g
    upwind convection-diffusion stencil, nonsymmetric."""
    from spmv_torch.formats.csr import CSRHost

    n2 = g * g
    h = 1.0 / (g + 1)
    iy, ix = np.divmod(np.arange(n2), g)
    rows = [np.arange(n2)]
    cols = [np.arange(n2)]
    vals = [np.full(n2, 4.0 + 20.0 * h)]
    for di, dj, v in ((0, -1, -1.0 - 12.0 * h), (0, 1, -1.0),
                      (-1, 0, -1.0 - 8.0 * h), (1, 0, -1.0)):
        ok = (ix + dj >= 0) & (ix + dj < g) & (iy + di >= 0) & (iy + di < g)
        i = np.arange(n2)[ok]
        rows.append(i)
        cols.append(i + dj + di * g)
        vals.append(np.full(len(i), v))
    return CSRHost.from_coo(np.concatenate(rows), np.concatenate(cols),
                            np.concatenate(vals), n2, n2)


def parse_args(argv=None) -> argparse.Namespace:
    """The reference demo's flags (``--device`` in place of ``--cpu``)."""
    ap = argparse.ArgumentParser(description=__doc__)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--petsc", help="PETSc binary matrix file")
    src.add_argument("--lap2d", type=int, help="generate NxN 2-D Laplacian")
    src.add_argument("--lap3d", type=int, help="generate NxNxN 3-D Laplacian")
    src.add_argument("--mtx", help="Matrix Market file (.mtx / .mtx.gz)")
    src.add_argument("--convdiff", type=int, metavar="N",
                     help="generate NxN upwind convection-diffusion "
                          "(NONSYMMETRIC; use with --arnoldi)")
    ap.add_argument("-k", type=int, default=4, help="number of eigenpairs")
    ap.add_argument("--arnoldi", type=int, default=0, metavar="M",
                    help="NONSYMMETRIC mode: report the leading Ritz values "
                         "from an M-step Arnoldi run (spectral radius, "
                         "rightmost eigenvalue, residual certificates) "
                         "instead of LOBPCG eigenpairs")
    ap.add_argument("--svd", type=int, default=0, metavar="M",
                    help="estimate the k LARGEST singular triplets via an "
                         "M-step Golub-Kahan run (any operator, incl. "
                         "nonsymmetric; certificates printed per triplet)")
    ap.add_argument("--logdet", type=int, default=0, metavar="M",
                    help="estimate log det A (SPD) by stochastic Lanczos "
                         "quadrature with M-step quadratures; prints "
                         "mean +- stderr over --probes Rademacher probes "
                         "(and the exact dense value when n is small)")
    ap.add_argument("--probes", type=int, default=16,
                    help="Monte-Carlo probes for --logdet")
    ap.add_argument("--largest", action="store_true",
                    help="largest eigenpairs (default: smallest)")
    ap.add_argument("--maxiter", type=int, default=300)
    ap.add_argument("--tol", type=float, default=1e-6,
                    help="converged when |A x - theta x| <= tol * max|theta|")
    ap.add_argument("--cheb", type=int, default=0, metavar="DEGREE",
                    help="Chebyshev spectral-filter preconditioning for "
                         "SMALLEST eigenpairs: a degree-DEGREE polynomial "
                         "approximating A^-1 on [(2/D)^2*lmax, lmax] (lmax "
                         "from Lanczos) damps the upper spectrum")
    ap.add_argument("--devices", type=int, default=0,
                    help="number of stacked shards (default 1)")
    ap.add_argument("--format", choices=["ell", "dia", "well", "auto"],
                    default=None, help="local-block format (default: dia)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the operator and vectors live (default cuda)")
    for flag, kw in _NOT_PORTED.items():
        ap.add_argument(flag, help="not ported yet", **kw)
    args = ap.parse_args(argv)

    for flag in _NOT_PORTED:
        dest = flag[2:].replace("-", "_")
        if getattr(args, dest) != ap.get_default(dest):
            ap.error(f"{flag} is not yet ported, see ROADMAP.md")
    if args.cheb and args.largest:
        ap.error("--cheb targets SMALLEST eigenpairs (the filter "
                 "approximates A^-1); drop --largest")

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available (pass --device "
                 "cpu to run on the CPU)")
    return args


def load_matrix(args):
    """The host CSR of the source flag."""
    from spmv_torch.gen import create_laplace_2d, create_laplace_3d

    if args.petsc:
        from spmv_torch.io.petsc import read_petsc_binary_matrix_host

        return read_petsc_binary_matrix_host(args.petsc)
    if args.mtx:
        from spmv_torch.io.matrix_market import read_matrix_market

        return read_matrix_market(args.mtx)
    if args.lap3d:
        return create_laplace_3d(args.lap3d)
    if args.convdiff:
        return convection_diffusion(args.convdiff)
    return create_laplace_2d(args.lap2d, args.lap2d)


def build_operator(args, a):
    """The demo's operator: ``--format``, else ELL for the nonsymmetric
    modes (``--arnoldi``, ``--convdiff``), else vanilla DIA; float64
    unless ``--fp32``."""
    import torch

    from spmv_torch.parallel.dist_matrix import build_dist_matrix

    nonsym_fmt = "ell" if (args.arnoldi or args.convdiff) else None
    return build_dist_matrix(a, n_devices=args.devices or 1,
                             dtype=np.float32 if args.fp32 else np.float64,
                             local_format=args.format or nonsym_fmt or "dia",
                             device=torch.device(args.device))


def run(args, a, A, timer):
    """Run the mode the flags select on operator ``A`` (of host matrix
    ``a``), after one warm-up apply (it builds the CUDA kernels on first
    use), timing it into ``timer``. Returns (the result lines, as the
    reference demo prints them after the timings; the solver's result)."""
    import torch

    from spmv_torch.utils.timing import device_sync

    dtype = np.float32 if args.fp32 else np.float64
    ones = A.to_dist(np.ones(a.ncols, dtype))
    device_sync(A.matvec(ones))  # warm-up
    lines = []
    t0 = time.perf_counter()
    if args.logdet:
        from spmv_torch.solvers.funm import slq_logdet

        mean, err = slq_logdet(A.as_linear_operator(), A.to_dist(np.ones(a.nrows, dtype)),
                               torch.Generator().manual_seed(args.seed),
                               n_probes=args.probes, m=args.logdet)
        timer.add("2.SLQ", time.perf_counter() - t0)
        lines.append(f"SLQ(m={args.logdet}, probes={args.probes}): "
                     f"log det A = {mean:.9e} +- {err:.3e} (stderr)")
        if a.nrows <= 8192:
            sign, exact = np.linalg.slogdet(a.to_dense().astype(np.float64))
            dev = abs(mean - exact) / max(err, 1e-300)
            lines.append(f"  exact (dense slogdet): {exact:.9e}  "
                         f"sign={sign:+.0f}  deviation = {dev:.2f} sigma")
        return lines, (mean, err)

    if args.svd:
        from spmv_torch.solvers.svds import svds

        At = A.transposed()
        timer.add("1.Transpose", time.perf_counter() - t0)
        b0 = A.to_dist(np.random.default_rng(args.seed)
                       .standard_normal(a.nrows).astype(dtype), side="row")
        t0 = time.perf_counter()
        r = svds(A.as_linear_operator(), At.as_linear_operator(), b0, k=args.k, m=args.svd)
        timer.add("2.GolubKahan", time.perf_counter() - t0)
        lines.append(f"Golub-Kahan({args.svd}, {r.steps} informative steps): "
                     f"{len(r.s)} largest singular triplets")
        at_host = a.transpose()
        for j in range(len(r.s)):
            # independent host check: |A^T u - s v| via the CSR oracle
            uj = A.from_dist(r.u[j], side="row").astype(np.float64)
            vj = A.from_dist(r.v[j], side="col").astype(np.float64)
            true_res = np.linalg.norm(at_host.matvec(uj) - float(r.s[j]) * vj)
            lines.append(f"  sigma[{j}] = {r.s[j]:.9e}   cert = {r.residuals[j]:.3e}"
                         f"   |A^T u - s v| = {true_res:.3e}")
        return lines, r

    if args.arnoldi:
        from spmv_torch.solvers.arnoldi import arnoldi_ritz

        v0 = A.to_dist(np.random.default_rng(args.seed)
                       .standard_normal(a.nrows).astype(dtype))
        r = arnoldi_ritz(A.as_linear_operator(), v0, m=args.arnoldi)
        timer.add("2.Arnoldi", time.perf_counter() - t0)
        lines.append(f"Arnoldi({args.arnoldi}, {r.steps} informative steps): "
                     f"spectral radius >= {r.spectral_radius:.9e}, "
                     f"rightmost = {r.rightmost:.9e}")
        for j in range(min(args.k, len(r.values))):
            lines.append(f"  ritz[{j}] = {r.values[j]:.9e}   "
                         f"cert = {r.residuals[j]:.3e}")
        return lines, r

    from spmv_torch.solvers.lobpcg import lane_block_ops, lobpcg

    X0 = A.to_dist_block(np.random.default_rng(args.seed).standard_normal(
        (a.nrows, args.k)).astype(dtype))
    precond = None
    if args.cheb:
        from spmv_torch.solvers.chebyshev import chebyshev_preconditioner
        from spmv_torch.solvers.lanczos import lanczos_extreme

        _, lmax_d = lanczos_extreme(A.as_linear_operator(), A.to_dist(np.ones(a.nrows, dtype)),
                                    m=32)
        lmax = float(lmax_d) * 1.05
        lo = (2.0 / args.cheb) ** 2 * lmax
        timer.add("2.ChebBounds", time.perf_counter() - t0)
        print(f"Chebyshev filter: degree {args.cheb} on [{lo:.4g}, {lmax:.4g}]",
              file=sys.stderr)
        precond = chebyshev_preconditioner(A.matmat, lo, lmax, degree=args.cheb)
        t0 = time.perf_counter()
    res = lobpcg(A.matmat, X0, k=args.k, maxiter=args.maxiter, tol=args.tol,
                 largest=args.largest, preconditioner=precond, block_ops=lane_block_ops())
    device_sync(res.X)
    timer.add("2.LOBPCG", time.perf_counter() - t0)

    # independent host verification: r_j = A x_j - theta_j x_j via CSR
    X = A.from_dist_block(res.X)
    theta = np.asarray(res.eigenvalues)
    which = "largest" if args.largest else "smallest"
    lines.append(f"LOBPCG ({which} {args.k}): converged={bool(res.converged)} "
                 f"in {int(res.iterations)} iterations")
    for j in range(args.k):
        xj = X[:, j].astype(np.float64)
        rel = (np.linalg.norm(a.matvec(xj) - float(theta[j]) * xj)
               / max(np.abs(theta).max(), 1e-300))
        lines.append(f"  theta[{j}] = {float(theta[j]):.12e}   "
                     f"|Ax-tx|/max|t| = {rel:.3e}")
    return lines, res


def main(argv=None) -> int:
    from spmv_torch.utils.timing import PhaseTimer

    args = parse_args(argv)
    timer = PhaseTimer()
    t0 = time.perf_counter()
    a = load_matrix(args)
    timer.add("0.MatCreate", time.perf_counter() - t0)
    t0 = time.perf_counter()
    A = build_operator(args, a)
    timer.add("1.Assemble", time.perf_counter() - t0)
    lines, _result = run(args, a, A, timer)
    print(timer.report())
    for line in lines:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
