#!/usr/bin/env python
"""demo_spmv — distributed SpMV benchmark CLI (PyTorch/CUDA port).

Counterpart of ``spmv_tpu/demos/demo_spmv.py`` and of LIBSPMV's
``spmv.cpp`` demo, with the same flags and printed lines: load or generate
a matrix, assemble the distributed operator (its shards stacked on one
device), build the Gaussian-bump input, run one untimed warm-up apply and
``--iters`` chained applies y = 0.12 A y with phase timings (0.MatCreate,
1.VecCreate, 2.SpUpdate+SpMV — the halo exchange and the local product
of each apply, timed together — and 4.Copy), and report ms per apply,
GFLOP/s and the final vector norm, the cheap correctness signal.

``--slices > 1`` needs the two-tier halo plan, which is not ported yet
(ROADMAP.md queue 1). The reference's periodic syncs in the loop are an
XLA:CPU workaround and are not carried over; ``--cpu``, which the
reference uses to pick JAX's CPU backend, is ``--device cpu`` here.

Usage:
  python -m spmv_torch.demos.demo_spmv --lap2d 3200 --dia              # dia_spmv, fp64
  python -m spmv_torch.demos.demo_spmv --lap2d 3200 --dia --symmetric --fp32
  python -m spmv_torch.demos.demo_spmv --lap2d 3200 --format auto      # dia_ds
  python -m spmv_torch.demos.demo_spmv --lap2d 3200 --format well --fp32
  python -m spmv_torch.demos.demo_spmv --petsc matrix.petsc --devices 4
  python -m spmv_torch.demos.demo_spmv --lap2d 512 --devices 8 --symmetric --device cpu
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
SCALE = 0.12  # each apply's scaling, which keeps the chained vector finite


def chain(A, x, iters: int, scale):
    """The timed loop: ``iters`` chained applies y <- scale * (A y) from
    y = x (each output feeds the next input)."""
    y = x
    for _ in range(iters):
        y = A.matvec(y) * scale
    return y


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--petsc", help="PETSc binary matrix file")
    src.add_argument("--lap2d", type=int, help="generate NxN 2-D Laplacian")
    src.add_argument("--lap1d", type=int, help="generate N-row 1-D operator")
    src.add_argument("--lap3d", type=int, help="generate NxNxN 3-D Laplacian")
    src.add_argument("--mtx", help="Matrix Market file (.mtx / .mtx.gz)")
    ap.add_argument("--iters", type=int, default=100, help="SpMV applications (reference: 100)")
    ap.add_argument("--devices", type=int, default=0,
                    help="number of stacked shards (default 1)")
    ap.add_argument("--slices", type=int, default=1,
                    help="2-D (dcn, ici) mesh: --devices D split into "
                         "--slices slow-axis groups (two-tier halo plans; not "
                         "ported yet)")
    ap.add_argument("--format", choices=["ell", "dia", "dia_ds", "well", "well_ds", "auto"],
                    default=None,
                    help="local-block format (default: ell; 'auto' selects)")
    ap.add_argument("--dia", action="store_true", help="DIA local blocks (stencil fast path)")
    ap.add_argument("--symmetric", action="store_true", help="lower-triangle storage")
    ap.add_argument("--fp32", action="store_true", help="float32 (default float64)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the operator and vectors live (default cuda)")
    for flag, kw in _NOT_PORTED.items():
        ap.add_argument(flag, help="not ported yet", **kw)
    args = ap.parse_args(argv)

    for flag in _NOT_PORTED:
        dest = flag[2:].replace("-", "_")
        if getattr(args, dest) != ap.get_default(dest):
            ap.error(f"{flag} is not yet ported, see ROADMAP.md")
    if args.slices > 1:
        raise NotImplementedError(
            "demo_spmv --slices needs the two-tier halo plan (CommPlan2), "
            "which is not ported yet; see ROADMAP.md queue 1, the two-tier slice")

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
    n_dev = args.devices or 1
    A = build_dist_matrix(a, n_devices=n_dev, symmetric=args.symmetric, dtype=dtype,
                          local_format=args.format or ("dia" if args.dia else "ell"),
                          device=device)
    timer.add("0.MatCreate", time.perf_counter() - t0)

    t0 = time.perf_counter()
    x = A.to_dist(gaussian_bump(a.nrows, dtype=dtype))
    device_sync(x)
    timer.add("1.VecCreate", time.perf_counter() - t0)

    print(f"matrix: {a.nrows} rows, {a.nnz} nnz, {n_dev} shard(s), "
          f"{'symmetric' if args.symmetric else 'vanilla'}, {np.dtype(dtype).name}, "
          f"local_format={A.local_format}, device: "
          f"{torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}",
          file=sys.stderr)

    scale = float(dtype(SCALE))
    device_sync(chain(A, x, 1, scale))  # warm-up, like the reference's untimed run

    t0 = time.perf_counter()
    y = chain(A, x, args.iters, scale)
    device_sync(y)
    timer.add("2.SpUpdate+SpMV", time.perf_counter() - t0)

    t0 = time.perf_counter()
    y_host = A.from_dist(y)
    timer.add("4.Copy", time.perf_counter() - t0)

    print(timer.report())
    per_it = timer.acc["2.SpUpdate+SpMV"] / args.iters
    gflops = 2.0 * a.nnz / per_it / 1e9
    print(f"SpMV: {per_it * 1e3:.3f} ms/apply, {gflops:.1f} GFLOP/s")
    print(f"norm(y) = {np.linalg.norm(y_host):.12e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
