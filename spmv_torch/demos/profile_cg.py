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

``--amg`` profiles AMG-PCG instead (the reference bench's headline
solver: interval2d 4x4 grid blocks, W-cycle, on the fp32 DIA operator;
graph matching on --fem) and adds one JSON line per part of the cycle:
each level's smoothing (its DIA/ELL applies and the Chebyshev vector
work), each level's residual and transfers, and the dense coarse solve,
each profiled alone and scaled by its visits per PCG iteration, with the
level's operator applies split out by kernel name. Iterations continue
past convergence (rtol 0), so keep --iters near the converged count.

Usage:
  python -m spmv_torch.demos.profile_cg --lap2d 3200 --symmetric --fp32
  python -m spmv_torch.demos.profile_cg --lap2d 3200 --iters 200
  python -m spmv_torch.demos.profile_cg --fem 800000 --symmetric --fp32
  python -m spmv_torch.demos.profile_cg --lap2d 3200 --format auto
  python -m spmv_torch.demos.profile_cg --lap2d 3200 --fp32 --amg --iters 12
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
    ap.add_argument("--amg", action="store_true",
                    help="AMG-PCG (interval2d 4x4 W-cycle on --lap2d, "
                         "matching on --fem), with the cycle's split")
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
    hier = None
    if args.amg:
        from spmv_torch.solvers.amg import amg_setup

        kw = {} if args.fem else dict(aggregate="interval2d", interval_size=4,
                                      cycle=2, local_format="dia")
        t0 = time.perf_counter()
        split: dict = {}
        hier = amg_setup(a, A, timings=split, **kw)
        print(json.dumps({"amg_setup_s": time.perf_counter() - t0, **split,
                          "levels": [[lvl.A.nrows_global, lvl.A.local_format,
                                      len(lvl.A.dia_offsets)] for lvl in hier.levels],
                          "coarse_rows": hier.coarse_A.nrows_global,
                          "grid_complexity": hier.grid_complexity()}))
        precond = hier.as_preconditioner()

    def run():
        res = cg(op, b, kmax=args.iters, rtol=0.0, preconditioner=precond)
        torch.cuda.synchronize(dev)
        return res

    run()  # warm-up: kernel build, allocator, cuBLAS handles
    t0 = time.perf_counter()
    run()
    wall_us = 1e6 * (time.perf_counter() - t0) / args.iters

    busy_us, rows = _device_us(run, args.iters)
    if not rows:
        print("profile_cg: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    for name, (us, calls) in sorted(rows.items(), key=lambda kv: -kv[1][0]):
        print(json.dumps({"kernel": name[:120], "calls_per_iter": calls,
                          "device_us_per_iter": us,
                          "share_of_wall": us / wall_us}))
    if hier is not None:
        for part in _amg_parts(hier, b):
            print(json.dumps(part))
    print(json.dumps({
        "rows": a.nrows, "local_format": fmt, "dtype": np.dtype(dtype).name,
        "symmetric": args.symmetric, "amg": args.amg, "iters": args.iters,
        "wall_us_per_iter": wall_us, "device_busy_us_per_iter": busy_us,
        "device_idle_share": (wall_us - busy_us) / wall_us,
        "card": torch.cuda.get_device_name(dev)}))
    return 0


def _device_us(fn, per: int) -> tuple[float, dict]:
    """Profile one call of ``fn``: (device-busy us, {kernel name: (us,
    calls)}), each divided by ``per``."""
    import torch
    from torch.autograd import DeviceType

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
    rows = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # host-side op records; their kernels are listed
        if e.self_device_time_total > 0:
            rows[e.key] = (e.self_device_time_total / per, e.count / per)
    return sum(us for us, _ in rows.values()), rows


def _amg_parts(h, b, reps: int = 20):
    """Device us per PCG iteration of each part of the cycle, each part
    profiled alone on a vector of its level (``reps`` calls) and scaled by
    its calls per iteration: a level visited v times (cycle**l) smooths 2v
    times and computes cycle*v residuals, restrictions and prolongations;
    the coarse solve runs cycle**L times."""
    import torch

    from spmv_torch.solvers import amg

    dev = b.device
    out = []
    r = b
    for lvl_i, lvl in enumerate(h.levels):
        visits = h.cycle ** lvl_i
        gen = torch.Generator(device="cpu").manual_seed(lvl_i)
        v = torch.randn(r.shape, generator=gen).to(dev) * (lvl.dinv != 0)

        def smooth():
            for _ in range(reps):
                amg._smooth(lvl.A, lvl.dinv, lvl.lmax, lvl.lmin, lvl.degree, v,
                            x0=v)
            torch.cuda.synchronize(dev)

        def transfer():
            for _ in range(reps):
                rc = amg._restrict(lvl, v - lvl.A.matvec(v))
                amg._prolong(lvl, rc)
            torch.cuda.synchronize(dev)

        for part, fn, per_iter in (("smoothing", smooth, 2 * visits),
                                   ("residual+transfers", transfer, h.cycle * visits)):
            busy, rows = _device_us(fn, reps)
            spmv = {k: us * per_iter for k, (us, _) in rows.items()
                    if "spmv" in k or "spmm" in k}
            out.append({"amg_part": part, "level": lvl_i,
                        "rows": lvl.A.nrows_global, "calls_per_iter": per_iter,
                        "device_us_per_iter": busy * per_iter,
                        "operator_kernel_us_per_iter": spmv,
                        "other_us_per_iter": busy * per_iter - sum(spmv.values())})
        r = amg._restrict(lvl, v)
    visits = h.cycle ** len(h.levels)

    def coarse():
        for _ in range(reps):
            amg._coarse_solve(h, r)
        torch.cuda.synchronize(dev)

    busy, _ = _device_us(coarse, reps)
    out.append({"amg_part": "coarse_solve", "rows": h.coarse_A.nrows_global,
                "calls_per_iter": visits, "device_us_per_iter": busy * visits})
    return out


if __name__ == "__main__":
    sys.exit(main())
