#!/usr/bin/env python
"""demo_cg — distributed CG solver CLI (PyTorch/CUDA port).

Generates a Laplacian or reads a Matrix Market file, optionally reorders
it (RCM), assembles the distributed operator with its shards stacked on one
device, solves with CG, and verifies by recomputing r = A x - b on the
host. Same flags and output lines as ``spmv_tpu/demos/demo_cg.py``; flags
of the reference that are not ported yet exit with an error naming
ROADMAP.md.

Usage:
  python -m spmv_torch.demos.demo_cg --lap2d 3200 --dia --symmetric --fp32
  python -m spmv_torch.demos.demo_cg --mtx A.mtx --reorder rcm --format auto \
      --symmetric --fp32 --kmax 20000 --rtol 1e-6
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
    "--rhs": {},
    "--spai": dict(type=int, nargs="?", const=1, default=0),
    "--sstep": dict(type=int, default=0),
    "--mpk": dict(action="store_true"),
    "--newton": dict(type=int, default=0),
    "--fsai": dict(action="store_true"),
    "--deflated": dict(type=int, default=0),
    "--amg": dict(action="store_true"),
    "--amg-aggregate": dict(default="auto"),
    "--refine": dict(action="store_true"),
    "--cpu": dict(action="store_true"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--lap2d", type=int, help="generate NxN 2-D Laplacian")
    src.add_argument("--lap1d", type=int, help="generate N-row 1-D operator")
    src.add_argument("--lap3d", type=int, help="generate NxNxN 3-D Laplacian")
    src.add_argument("--petsc", help="PETSc binary matrix file (not ported yet)")
    src.add_argument("--mtx", help="Matrix Market file (.mtx / .mtx.gz)")
    ap.add_argument("--kmax", type=int, default=100, help="max iterations")
    ap.add_argument("--rtol", type=float, default=1e-10, help="relative tolerance")
    ap.add_argument("--devices", type=int, default=0,
                    help="number of stacked shards (default 1)")
    ap.add_argument("--format", choices=["ell", "dia", "dia_ds", "well",
                                         "well_ds", "auto"], default=None,
                    help="local-block format (default: ell; 'auto' selects; "
                         "the double-single formats are not ported)")
    ap.add_argument("--dia", action="store_true", help="DIA local blocks (stencil fast path)")
    ap.add_argument("--jacobi", action="store_true", help="Jacobi (diagonal) preconditioning")
    ap.add_argument("--solver", choices=["cg", "minres", "bicgstab", "gmres"],
                    default="cg", help="only cg is ported")
    ap.add_argument("--reorder", choices=["rcm"], default=None,
                    help="bandwidth-reduction reordering before assembly "
                         "(solves the permuted system; the printed solution "
                         "is mapped back to the original numbering)")
    ap.add_argument("--symmetric", action="store_true")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the operator and vectors live (default cuda)")
    for flag, kw in _NOT_PORTED.items():
        ap.add_argument(flag, help="not ported yet", **kw)
    args = ap.parse_args(argv)

    for flag in ("--petsc", *_NOT_PORTED):
        dest = flag[2:].replace("-", "_")
        if getattr(args, dest) != ap.get_default(dest):
            ap.error(f"{flag} is not yet ported, see ROADMAP.md")
    if args.solver != "cg":
        ap.error(f"--solver {args.solver} is not yet ported, see ROADMAP.md")
    fmt = args.format or ("dia" if args.dia else "ell")
    if fmt in ("dia_ds", "well_ds"):
        ap.error(f"--format {fmt} is not yet ported, see ROADMAP.md")

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
    from spmv_torch.solvers.cg import cg
    from spmv_torch.utils.timing import PhaseTimer, device_sync

    device = torch.device(args.device)
    dtype = np.float32 if args.fp32 else np.float64
    timer = PhaseTimer()

    t0 = time.perf_counter()
    if args.mtx:
        from spmv_torch.io.matrix_market import read_matrix_market

        a = read_matrix_market(args.mtx)
    elif args.lap3d:
        a = create_laplace_3d(args.lap3d)
    elif args.lap2d:
        a = create_laplace_2d(args.lap2d, args.lap2d)
    else:
        a = create_laplace_1d(args.lap1d)
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

    try:
        A = build_dist_matrix(a, n_devices=args.devices or 1,
                              symmetric=args.symmetric, dtype=dtype,
                              local_format=fmt, device=device)
    except NotImplementedError as e:
        ap.error(str(e))
    b = A.to_dist(b_host)
    precond = A.jacobi_preconditioner() if args.jacobi else None
    device_sync(A.matvec(b))  # warm-up: builds the CUDA kernels on first use

    t0 = time.perf_counter()
    res = cg(A.as_linear_operator(), b, kmax=args.kmax, rtol=args.rtol,
             preconditioner=precond)
    device_sync(res.x)
    timer.add("1.Solve", time.perf_counter() - t0)

    x_host = A.from_dist(res.x)
    r = a.matvec(x_host.astype(np.float64)) - b_host.astype(np.float64)
    if order is not None:  # map the solution back to the original numbering
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        x_host = x_host[inv]

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
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
