#!/usr/bin/env python
"""demo_cg — distributed CG solver CLI (PyTorch/CUDA port).

Generates a Laplacian or reads a Matrix Market or PETSc file (and a PETSc
right-hand side), optionally reorders it (RCM), assembles the distributed
operator with its shards stacked on one device, solves with CG, MINRES,
BiCGStab or GMRES (preconditioned by Jacobi, AMG, SPAI or FSAI), and
verifies by recomputing r = A x - b on the host. Same flags and output
lines as ``spmv_tpu/demos/demo_cg.py``; flags of the reference that are
not ported yet exit with an error naming ROADMAP.md.

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
  python -m spmv_torch.demos.demo_cg --lap2d 48 --device cpu
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

# flags of the reference demo that this port does not run yet (ROADMAP.md),
# with the reference's argparse settings
_NOT_PORTED = {
    "--sstep": dict(type=int, default=0),
    "--mpk": dict(action="store_true"),
    "--newton": dict(type=int, default=0),
    "--deflated": dict(type=int, default=0),
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

    try:
        A = build_dist_matrix(a, n_devices=args.devices or 1,
                              symmetric=args.symmetric, dtype=dtype,
                              local_format=fmt, device=device)
    except NotImplementedError as e:
        ap.error(str(e))
    b = A.to_dist(b_host)
    krylov = _krylov(args.solver)
    precond = None
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
    elif args.spai:
        from spmv_torch.solvers.spai import spai_preconditioner

        t0 = time.perf_counter()
        # M in ELL, as the reference demo builds it
        precond = spai_preconditioner(A, pattern_level=args.spai, local_format="ell")
        timer.add("0.SPAISetup", time.perf_counter() - t0)
    elif args.jacobi:
        precond = A.jacobi_preconditioner()
    device_sync(A.matvec(b))  # warm-up: builds the CUDA kernels on first use

    t0 = time.perf_counter()
    res = krylov(A.as_linear_operator(), b, kmax=args.kmax, rtol=args.rtol,
                 preconditioner=precond)
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
