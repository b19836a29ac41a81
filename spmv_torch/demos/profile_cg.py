#!/usr/bin/env python
"""profile_cg — where the time of one CG iteration goes on the card.

Assembles a 2-D Laplacian as a DIA DistMatrix (or, with ``--fem N``, an
RCM-reordered N-node P1 FEM operator as a WELL DistMatrix solved with
Jacobi-PCG, the general-sparsity path) on one CUDA device; ``--format
auto`` lets ``select_local_format`` choose, which on float64 input (no
``--fp32``) builds the double-single ``dia_ds`` / ``well_ds`` operator that
CG applies through its float64 ``matvec``. It runs a fixed
number of CG iterations (rtol 0, so none stops early) once under the host
clock and once under ``torch.profiler``, and prints one JSON line per
device kernel (calls and device microseconds per CG iteration), then a
summary line: wall and device-busy microseconds per iteration and the
device idle share (wall minus busy, over wall).

Usage:
  python -m spmv_torch.demos.profile_cg --lap2d 3200 --symmetric --fp32
  python -m spmv_torch.demos.profile_cg --lap2d 3200 --iters 200
  python -m spmv_torch.demos.profile_cg --fem 800000 --symmetric --fp32
  python -m spmv_torch.demos.profile_cg --lap2d 3200 --format auto
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--lap2d", type=int, default=3200, help="NxN 2-D Laplacian")
    ap.add_argument("--fem", type=int, default=0,
                    help="N-node fem_p1_2d, RCM'd, WELL, Jacobi-PCG "
                         "(replaces --lap2d)")
    ap.add_argument("--format", choices=["auto"], default=None,
                    help="local format: default dia (--lap2d) or well "
                         "(--fem); auto selects (double-single on float64)")
    ap.add_argument("--iters", type=int, default=200, help="CG iterations profiled")
    ap.add_argument("--symmetric", action="store_true")
    ap.add_argument("--fp32", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        ap.error("profile_cg times the card: no CUDA device is available")

    from spmv_torch.corpus import fem_p1_2d
    from spmv_torch.gen import create_laplace_2d, gaussian_bump
    from spmv_torch.parallel.dist_matrix import build_dist_matrix
    from spmv_torch.reorder import rcm_reorder
    from spmv_torch.solvers.cg import cg

    dev = torch.device("cuda", 0)
    dtype = np.float32 if args.fp32 else np.float64
    if args.fem:
        a, _ = rcm_reorder(fem_p1_2d(args.fem), keep_best=True)
        fmt = "well"
    else:
        a = create_laplace_2d(args.lap2d, args.lap2d)
        fmt = "dia"
    A = build_dist_matrix(a, n_devices=1, symmetric=args.symmetric, dtype=dtype,
                          local_format=args.format or fmt, device=dev)
    fmt = A.local_format
    b = A.to_dist(gaussian_bump(a.nrows, dtype=dtype))
    op = A.as_linear_operator()
    precond = A.jacobi_preconditioner() if args.fem else None

    def run():
        res = cg(op, b, kmax=args.iters, rtol=0.0, preconditioner=precond)
        torch.cuda.synchronize(dev)
        return res

    run()  # warm-up: kernel build, allocator, cuBLAS handles
    t0 = time.perf_counter()
    run()
    wall_us = 1e6 * (time.perf_counter() - t0) / args.iters

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # host-side op records; their kernels are listed
        us = e.self_device_time_total / args.iters
        if us > 0:
            rows.append((us, e.key, e.count / args.iters))
    if not rows:
        print("profile_cg: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    rows.sort(reverse=True)
    busy_us = sum(us for us, _, _ in rows)
    for us, name, calls in rows:
        print(json.dumps({"kernel": name[:120], "calls_per_iter": calls,
                          "device_us_per_iter": us,
                          "share_of_wall": us / wall_us}))
    print(json.dumps({
        "rows": a.nrows, "local_format": fmt, "dtype": np.dtype(dtype).name,
        "symmetric": args.symmetric, "iters": args.iters,
        "wall_us_per_iter": wall_us, "device_busy_us_per_iter": busy_us,
        "device_idle_share": (wall_us - busy_us) / wall_us,
        "card": torch.cuda.get_device_name(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
