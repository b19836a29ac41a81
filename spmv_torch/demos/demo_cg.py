#!/usr/bin/env python
"""demo_cg — distributed CG solver CLI (PyTorch/CUDA port).

Generates a Laplacian or reads a Matrix Market or PETSc file (and a PETSc
right-hand side), optionally reorders it (RCM), assembles the distributed
operator with its shards stacked on one device, solves with CG, MINRES,
BiCGStab or GMRES (preconditioned by Jacobi, AMG, SPAI or FSAI), s-step CG
or GMRES (``--sstep``, with the matrix-powers basis ``--mpk`` and the
Newton basis ``--newton``), or CG deflated against LOBPCG's bottom
eigenvectors (``--deflated``), and verifies by recomputing r = A x - b on
the host. Same flags and output lines as ``spmv_tpu/demos/demo_cg.py``;
``--cpu``, which the reference uses to pick JAX's CPU backend, is
``--device cpu`` here and exits with an error naming ROADMAP.md.

Usage:
  python -m spmv_torch.demos.demo_cg --lap2d 3200 --dia --symmetric --fp32
  python -m spmv_torch.demos.demo_cg --mtx A.mtx --reorder rcm --format auto \
      --symmetric --fp32 --kmax 20000 --rtol 1e-6
  python -m spmv_torch.demos.demo_cg --lap2d 3200 --format auto --kmax 20000 \
      --rtol 1e-6                    # float64: auto picks double-single dia_ds
  python -m spmv_torch.demos.demo_cg --lap2d 1024 --refine --kmax 20000
  python -m spmv_torch.demos.demo_cg --lap2d 3200 --dia --fp32 --amg --rtol 1e-6
  python -m spmv_torch.demos.demo_cg --lap2d 1024 --refine --amg --rtol 1e-12
  python -m spmv_torch.demos.demo_cg --lap2d 3200 --dia --fp32 --amg --solver gmres \
      --rtol 1e-6
  python -m spmv_torch.demos.demo_cg --petsc A.petsc --rhs b.petsc --solver bicgstab
  python -m spmv_torch.demos.demo_cg --mtx A.mtx --format auto --fp32 --fsai
  python -m spmv_torch.demos.demo_cg --lap2d 1024 --dia --sstep 4 --mpk --devices 4 \
      --kmax 20000 --rtol 1e-6
  python -m spmv_torch.demos.demo_cg --petsc A.petsc --rhs b.petsc --dia --sstep 4 \
      --solver gmres --newton 16 --mpk --devices 4
  python -m spmv_torch.demos.demo_cg --lap2d 1024 --dia --symmetric --fp32 --deflated 4 \
      --kmax 20000 --rtol 1e-6
  python -m spmv_torch.demos.demo_cg --lap2d 48 --device cpu
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


def _krylov(solver: str):
    """The solve call of ``--solver``, as ``cg``'s signature: GMRES runs
    restart min(30, kmax) and enough cycles for kmax steps, as the
    reference demo does."""
    if solver == "gmres":
        from spmv_torch.solvers.gmres import gmres

        def run(mv, b, kmax, rtol, preconditioner):
            m = min(30, kmax)
            return gmres(mv, b, restart=m, max_cycles=-(-kmax // m), rtol=rtol,
                         preconditioner=preconditioner)
        return run
    if solver == "bicgstab":
        from spmv_torch.solvers.bicgstab import bicgstab
        return bicgstab
    if solver == "minres":
        from spmv_torch.solvers.minres import minres
        return minres
    from spmv_torch.solvers.cg import cg
    return cg


def deflation_basis(A, d: int, dtype):
    """The reference demo's deflation basis (``spmv_tpu/demos/demo_cg.py``
    :272-296): d approximate bottom eigenvectors of A from a short LOBPCG
    run (maxiter 100, tol 1e-3, random start from seed 0) behind a degree-16
    Chebyshev filter on [(2/16)^2 lmax, lmax], lmax from a 32-step Lanczos
    run (plain LOBPCG stalls on the Laplacian's clustered bottom; deflation
    needs the subspace, not converged pairs). Returns (W, the LOBPCG
    result), W of shape (d, *vector shape): column j of the block layout is
    the single-vector lane layout."""
    import torch

    from spmv_torch.ops.spmm_dia import columns
    from spmv_torch.solvers.chebyshev import chebyshev_preconditioner
    from spmv_torch.solvers.lanczos import lanczos_extreme
    from spmv_torch.solvers.lobpcg import lane_block_ops, lobpcg

    n = A.nrows_global
    _, lmax_d = lanczos_extreme(A.as_linear_operator(), A.to_dist(np.ones(n, dtype)), m=32)
    lmax = float(lmax_d) * 1.05
    deg = 16
    X0 = A.to_dist_block(np.random.default_rng(0).standard_normal((n, d)).astype(dtype))
    eig = lobpcg(A.matmat, X0, k=d, maxiter=100, tol=1e-3,
                 preconditioner=chebyshev_preconditioner(
                     A.matmat, (2.0 / deg) ** 2 * lmax, lmax, degree=deg),
                 block_ops=lane_block_ops())
    return torch.stack(columns(eig.X)), eig


def sstep_solve(args, a, A, b, timer):
    """The ``--sstep`` solve of the reference demo (:321-391): s-step CG, or
    s-step GMRES(min(32, kmax)) with ``--solver gmres``; ``--newton M``
    harvests M-step Arnoldi Ritz values once for the Newton basis, and
    ``--mpk`` builds each block's basis through a depth-S powers plan
    (plan seconds timed, ghost growth printed). Returns the solve call."""
    from spmv_torch.solvers.cg_sstep import cg_sstep
    from spmv_torch.solvers.gmres_sstep import gmres_sstep

    s = args.sstep
    restart = min(32, args.kmax)
    cycles = -(-args.kmax // restart)
    ritz = newton_ops = None
    if args.newton:
        from spmv_torch.solvers.arnoldi import arnoldi_ritz
        from spmv_torch.solvers.newton_basis import newton_basis_ops

        t0 = time.perf_counter()
        ritz = arnoldi_ritz(A.as_linear_operator(), b, m=args.newton).values
        newton_ops = newton_basis_ops(ritz, s)
        timer.add("0.RitzHarvest", time.perf_counter() - t0)
        print(f"Newton basis: {args.newton}-step Ritz harvest, "
              f"max |Im| = {float(abs(ritz.imag).max()):.3g}", file=sys.stderr)
    builder = None
    if args.mpk:
        from spmv_torch.parallel.powers import (
            build_powers_plan,
            chebyshev_powers_basis,
            newton_powers_basis,
            powers_ghost_stats,
        )

        t0 = time.perf_counter()
        pp = build_powers_plan(a, A, s=s)
        timer.add("0.PowersPlan", time.perf_counter() - t0)
        st = powers_ghost_stats(pp, A)
        print(f"MPK: depth-{s} ghosts {st['nghost_pad_depth_s']} vs depth-1 "
              f"{st['nghost_pad_depth_1']} (growth {st['growth']:.1f}x)", file=sys.stderr)
        if args.newton:
            def builder(r):
                return newton_powers_basis(pp, r, newton_ops)
        else:
            def builder(r, c, e):
                return chebyshev_powers_basis(pp, r, c, e)

    def solve():
        if args.solver == "gmres":
            return gmres_sstep(A.as_linear_operator(), b, s=s, restart=restart,
                               max_cycles=cycles, rtol=args.rtol, shifts=ritz,
                               basis_builder=builder)
        return cg_sstep(A.as_linear_operator(), b, s=s, kmax=args.kmax, rtol=args.rtol,
                        basis_builder=builder)

    return solve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--lap2d", type=int, help="generate NxN 2-D Laplacian")
    src.add_argument("--lap1d", type=int, help="generate N-row 1-D operator")
    src.add_argument("--lap3d", type=int, help="generate NxNxN 3-D Laplacian")
    src.add_argument("--petsc", help="PETSc binary matrix file")
    src.add_argument("--mtx", help="Matrix Market file (.mtx / .mtx.gz)")
    ap.add_argument("--rhs", help="PETSc binary RHS vector (default: Gaussian bump)")
    ap.add_argument("--kmax", type=int, default=100, help="max iterations")
    ap.add_argument("--rtol", type=float, default=1e-10, help="relative tolerance")
    ap.add_argument("--devices", type=int, default=0,
                    help="number of stacked shards (default 1)")
    ap.add_argument("--format", choices=["ell", "dia", "dia_ds", "well",
                                         "well_ds", "auto"], default=None,
                    help="local-block format (default: ell; 'auto' selects, "
                         "double-single dia_ds/well_ds for float64)")
    ap.add_argument("--dia", action="store_true", help="DIA local blocks (stencil fast path)")
    ap.add_argument("--jacobi", action="store_true", help="Jacobi (diagonal) preconditioning")
    ap.add_argument("--spai", type=int, nargs="?", const=1, default=0,
                    metavar="LEVEL",
                    help="SPAI (sparse approximate inverse) preconditioning "
                         "for the nonsymmetric solvers; LEVEL=1 uses "
                         "pattern(A), 2 the denser pattern(|A|^2+|A|)")
    ap.add_argument("--fsai", action="store_true",
                    help="FSAI (factorized sparse approximate inverse) SPD "
                         "preconditioning: M^-1 = G^T G, two SpMVs an apply "
                         "(cg/minres)")
    ap.add_argument("--sstep", type=int, default=0, metavar="S",
                    help="s-step (communication-avoiding) Krylov: one host "
                         "sync per S iterations for CG, per S Arnoldi steps "
                         "with --solver gmres (CA-GMRES, non-symmetric)")
    ap.add_argument("--mpk", action="store_true",
                    help="with --sstep: build the Krylov basis through the "
                         "matrix-powers kernel (depth-S ghost plan): one "
                         "halo exchange per S iterations; ghost growth printed")
    ap.add_argument("--newton", type=int, default=0, metavar="M",
                    help="with --sstep --solver gmres: harvest M-step Arnoldi "
                         "Ritz values once and run the Leja-ordered Newton "
                         "basis instead of shifted Chebyshev (composes with "
                         "--mpk)")
    ap.add_argument("--deflated", type=int, default=0, metavar="D",
                    help="deflated CG: project out D approximate bottom "
                         "eigenvectors (a short LOBPCG run behind a Chebyshev "
                         "filter, set-up timed separately)")
    ap.add_argument("--solver", choices=["cg", "minres", "bicgstab", "gmres"],
                    default="cg",
                    help="bicgstab/gmres handle non-symmetric operators, "
                         "minres symmetric indefinite ones")
    ap.add_argument("--reorder", choices=["rcm"], default=None,
                    help="bandwidth-reduction reordering before assembly "
                         "(solves the permuted system; the printed solution "
                         "is mapped back to the original numbering)")
    ap.add_argument("--symmetric", action="store_true")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--refine", action="store_true",
                    help="mixed-precision iterative refinement: fp32 inner "
                         "CG (--kmax iterations each) with double-single "
                         "residuals, to a float64-class true residual")
    ap.add_argument("--amg", action="store_true",
                    help="smoothed-aggregation algebraic-multigrid "
                         "preconditioning (mesh-independent iteration "
                         "counts on SPD operators; setup timed separately)")
    ap.add_argument("--amg-aggregate",
                    choices=["auto", "match", "interval", "interval2d"],
                    default="auto",
                    help="AMG aggregation: 'auto' picks interval2d (4x4 "
                         "grid blocks + W-cycle, mesh-independent, banded "
                         "coarse grids) when a grid stride is detected, "
                         "else graph matching")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the operator and vectors live (default cuda)")
    for flag, kw in _NOT_PORTED.items():
        ap.add_argument(flag, help="not ported yet", **kw)
    args = ap.parse_args(argv)

    for flag in _NOT_PORTED:
        dest = flag[2:].replace("-", "_")
        if getattr(args, dest) != ap.get_default(dest):
            ap.error(f"{flag} is not yet ported, see ROADMAP.md")
    fmt = args.format or ("dia" if args.dia else "ell")

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available (pass --device "
                 "cpu to run on the CPU)")

    from spmv_torch.gen import (
        create_laplace_1d,
        create_laplace_2d,
        create_laplace_3d,
        gaussian_bump,
    )
    from spmv_torch.parallel.dist_matrix import build_dist_matrix
    from spmv_torch.utils.timing import PhaseTimer, device_sync

    device = torch.device(args.device)
    dtype = np.float32 if args.fp32 else np.float64
    timer = PhaseTimer()

    t0 = time.perf_counter()
    if args.petsc:
        from spmv_torch.io.petsc import read_petsc_binary_matrix_host

        a = read_petsc_binary_matrix_host(args.petsc)
    elif args.mtx:
        from spmv_torch.io.matrix_market import read_matrix_market

        a = read_matrix_market(args.mtx)
    elif args.lap3d:
        a = create_laplace_3d(args.lap3d)
    elif args.lap2d:
        a = create_laplace_2d(args.lap2d, args.lap2d)
    else:
        a = create_laplace_1d(args.lap1d)
    if args.rhs:
        from spmv_torch.io.petsc import read_petsc_binary_vector_host

        b_host = read_petsc_binary_vector_host(args.rhs).astype(dtype)
    else:
        b_host = gaussian_bump(a.nrows, dtype=dtype)
    timer.add("0.ReadPetsc", time.perf_counter() - t0)

    order = None
    if args.reorder == "rcm":
        from spmv_torch.reorder import bandwidth, rcm_reorder

        t0 = time.perf_counter()
        b0 = bandwidth(a)
        a, order = rcm_reorder(a)
        b_host = b_host[order]
        timer.add("0.Reorder", time.perf_counter() - t0)
        print(f"RCM: bandwidth {b0} -> {bandwidth(a)}", file=sys.stderr)

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if args.refine:
        from spmv_torch.solvers.refine import cg_refined, cg_refined_dist

        b64 = b_host.astype(np.float64)
        t0 = time.perf_counter()
        if (args.devices and args.devices > 1) or args.amg:
            # --refine --amg: AMG-preconditioned fp32 inner solves
            res = cg_refined_dist(a, b64, n_devices=args.devices or 1,
                                  rtol=args.rtol, inner_kmax=args.kmax,
                                  jacobi=args.jacobi, amg=args.amg,
                                  device=device)
        else:
            res = cg_refined(a, b64, rtol=args.rtol, inner_kmax=args.kmax,
                             device=device)
        timer.add("1.Solve", time.perf_counter() - t0)
        r = a.matvec(res.x) - b64
        print(f"device: {name}, {args.devices or 1} stacked shard(s), "
              f"refinement: fp32 inner {'AMG-P' if args.amg else ''}CG, "
              "double-single residuals", file=sys.stderr)
        print(timer.report())
        print(f"Converged: {res.converged} in {res.outer_iterations} outer / "
              f"{res.inner_iterations} inner iterations")
        print(f"r.norm = {np.linalg.norm(r):.12e}  (TRUE f64 residual)")
        print(f"x.norm = {np.linalg.norm(res.x):.12e}")
        return 0

    if args.mpk and not args.sstep:
        ap.error("--mpk builds the s-step Krylov basis; it needs --sstep S")
    if args.newton and not (args.sstep and args.solver == "gmres"):
        ap.error("--newton is the CA-GMRES Newton basis; it needs "
                 "--sstep S --solver gmres")
    if args.sstep and (args.amg or args.spai or args.fsai or args.deflated):
        ap.error("--sstep is unpreconditioned s-step CG; it cannot combine "
                 "with --amg/--spai/--fsai/--deflated")

    try:
        A = build_dist_matrix(a, n_devices=args.devices or 1,
                              symmetric=args.symmetric, dtype=dtype,
                              local_format=fmt, device=device)
    except NotImplementedError as e:
        ap.error(str(e))
    b = A.to_dist(b_host)
    krylov = _krylov(args.solver)
    precond = None
    solve = None  # a solve other than krylov(..., preconditioner=precond)
    if args.amg:
        from spmv_torch.solvers.amg import _detect_strides, amg_setup

        agg = args.amg_aggregate
        amg_kw = {}
        if agg == "auto":
            # grid-like operators get the headline configuration (4x4 grid
            # blocks, W-cycle); pattern-free ones graph matching
            if _detect_strides(a):
                agg, amg_kw = "interval2d", dict(interval_size=4, cycle=2)
            else:
                agg = "match"
        elif agg == "interval2d":
            amg_kw = dict(interval_size=4, cycle=2)
        t0 = time.perf_counter()
        hier = amg_setup(a, A, aggregate=agg, **amg_kw)
        timer.add("0.AMGSetup", time.perf_counter() - t0)
        print(f"AMG: {hier.n_levels} levels, grid complexity "
              f"{hier.grid_complexity():.2f}", file=sys.stderr)
        precond = hier.as_preconditioner()
    elif args.fsai:
        from spmv_torch.solvers.fsai import fsai_preconditioner

        t0 = time.perf_counter()
        # G is triangular, not symmetric: plain storage whatever --symmetric,
        # in the demo's own format (A's layout restored around each apply)
        precond = fsai_preconditioner(A, local_format=fmt)
        timer.add("0.FSAISetup", time.perf_counter() - t0)
    elif args.deflated:
        from spmv_torch.solvers.deflation import cg_deflated

        if args.solver != "cg":
            ap.error("--deflated is a CG variant; drop --solver")
        t0 = time.perf_counter()
        W, _eig = deflation_basis(A, args.deflated, dtype)
        timer.add("0.DeflSetup", time.perf_counter() - t0)
        jacobi = A.jacobi_preconditioner() if args.jacobi else None

        def solve():
            return cg_deflated(A.as_linear_operator(), b, W, kmax=args.kmax,
                               rtol=args.rtol, preconditioner=jacobi)
    elif args.spai:
        from spmv_torch.solvers.spai import spai_preconditioner

        t0 = time.perf_counter()
        # M in ELL, as the reference demo builds it
        precond = spai_preconditioner(A, pattern_level=args.spai, local_format="ell")
        timer.add("0.SPAISetup", time.perf_counter() - t0)
    elif args.sstep:
        if args.solver not in ("cg", "gmres") or args.jacobi:
            ap.error("--sstep is unpreconditioned s-step CG (or s-step "
                     "GMRES with --solver gmres); drop --solver/--jacobi")
        solve = sstep_solve(args, a, A, b, timer)
    elif args.jacobi:
        precond = A.jacobi_preconditioner()
    if solve is None:
        def solve():
            return krylov(A.as_linear_operator(), b, kmax=args.kmax, rtol=args.rtol,
                          preconditioner=precond)
    device_sync(A.matvec(b))  # warm-up: builds the CUDA kernels on first use

    t0 = time.perf_counter()
    res = solve()
    device_sync(res.x)
    timer.add("1.Solve", time.perf_counter() - t0)

    x_host = A.from_dist(res.x)
    r = a.matvec(x_host.astype(np.float64)) - b_host.astype(np.float64)
    if order is not None:  # map the solution back to the original numbering
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        x_host = x_host[inv]

    print(f"device: {name}, {A.n_devices} stacked shard(s), "
          f"local_format={A.local_format}, symmetric={args.symmetric}, "
          f"dtype={np.dtype(dtype).name}", file=sys.stderr)
    print(timer.report())
    iters = res.iterations
    print(f"Converged: {res.converged} in {iters} iterations "
          f"({iters / max(timer.acc['1.Solve'], 1e-12):.1f} it/s)")
    print(f"r.norm = {np.linalg.norm(r):.12e}")
    print(f"x.norm = {np.linalg.norm(x_host):.12e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
