#!/usr/bin/env python3
"""Smoke run of spmv_torch on one NVIDIA GPU: the quickest proof that the
port builds, is right, and runs its main path through its CUDA kernels.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and continued):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels (csrc/*.cu) with nvcc, print the build seconds;
  3. each kernel vs its plain torch version on the card, fp32 and fp64,
     vanilla and symmetric: the 3200^2 Laplacian, and a random banded
     matrix with odd offsets on D=3 stacked shards (relative L2 <= 1e-6
     fp32, <= 1e-13 fp64); fp32 also vs the host f64 CSR oracle (<= 2e-5);
  4. the main path at 3200^2 (10.24M rows): build_dist_matrix(dia) then
     cg(kmax=20000, rtol=1e-6) — symmetric fp64 (the correctness gate: the
     host-recomputed residual agrees with the reported one to 1e-8),
     symmetric fp32 and vanilla fp32 (the speed runs); the launch counters,
     zeroed just before, must show every CG apply went through a kernel;
     the fp32 runs print what their true residual is made of, and the
     symmetric fp32 solve runs again through the plain torch DIA version
     as a second witness (same iteration count within 1%);
  5. the halo path: 512^2 on D=4 stacked shards, dia and ell, symmetric and
     vanilla, fp32 and fp64 — one matvec vs the host oracle and a short CG;
  6. ms per apply of each kernel and its plain version at 3200^2 fp32
     (CUDA events, chained applies), each as a fraction of a device copy
     measured in the same run, and CG iterations/s.
The last two lines are the kernels JSON and {"ok": true, "device": ...}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from spmv_torch import _build
from spmv_torch.formats.dia import csr_to_dia
from spmv_torch.gen import create_laplace_2d, gaussian_bump
from spmv_torch.ops import spmv_dia_cuda
from spmv_torch.ops.spmv_dia import spmv_dia_stacked_plain
from spmv_torch.parallel.dist_matrix import build_dist_matrix
from spmv_torch.solvers.cg import cg
from spmv_torch.utils.timing import bench_chained, measure_copy_bandwidth_gbs

NX = 3200           # headline: 3200^2 = 10.24M rows (bench.py:358)
ROW_ALIGN = 1024    # bench.py:368
HALO_NX, HALO_D = 512, 4
TOL_KERNEL = {"float32": 1e-6, "float64": 1e-13}   # kernel vs plain
TOL_ORACLE = {"float32": 2e-5, "float64": 1e-12}   # vs host f64 CSR
TOL_SOLVE = {"float32": 1e-3, "float64": 1e-9}     # residual consistency


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAIL: {msg}")


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def show(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def compare(name, data, x2, offsets, symmetric, tol):
    """One kernel launch vs the plain version on the same inputs."""
    y_k = spmv_dia_cuda.spmv_dia_stacked(data, x2, offsets, symmetric)
    torch.cuda.synchronize()
    y_p = spmv_dia_stacked_plain(data, x2, offsets, symmetric)
    y_k, y_p = y_k.cpu().numpy(), y_p.cpu().numpy()
    if not np.all(np.isfinite(y_k)):
        fail(f"{name}: non-finite kernel output")
    err = rel_l2(y_k, y_p)
    max_abs = float(np.abs(y_k.astype(np.float64) - y_p).max())
    if err > tol:
        fail(f"{name}: kernel vs plain rel L2 {err:.3e} > {tol:.0e}")
    return y_k, err, max_abs


def phase_kernels(a, dev):
    """Phase 3. Returns {kernel name: largest abs kernel-vs-plain
    difference over all of its comparisons}."""
    rng = np.random.default_rng(0)
    max_abs = {"dia_spmv": 0.0, "dia_sym_spmv": 0.0}
    for dt in (np.float32, np.float64):
        dname = np.dtype(dt).name
        for sym in (False, True):
            kname = "dia_sym_spmv" if sym else "dia_spmv"
            d = csr_to_dia(a, row_align=ROW_ALIGN, dtype=dt, symmetric=sym,
                           device=dev)
            x = np.zeros(d.nrows_pad, dt)
            x[: a.nrows] = rng.standard_normal(a.nrows)
            x2 = torch.as_tensor(x, device=dev).view(-1, 128)
            y, err, mabs = compare(f"{kname} {dname} lap{NX}", d.data.unsqueeze(0),
                                   x2, d.offsets, sym, TOL_KERNEL[dname])
            fields = dict(kernel=kname, dtype=dname, matrix=f"laplace2d {NX}^2",
                          rel_l2_vs_plain=err, max_abs_vs_plain=mabs)
            max_abs[kname] = max(max_abs[kname], mabs)
            if dt == np.float32:
                oerr = rel_l2(y.ravel()[: a.nrows],
                              a.matvec(x[: a.nrows].astype(np.float64)))
                if oerr > TOL_ORACLE[dname]:
                    fail(f"{kname} fp32 vs host CSR oracle {oerr:.3e}")
                fields["rel_l2_vs_host_csr"] = oerr
            show("3.kernel", **fields)
            del d, x2

    # random banded, odd offsets, D=3 stacked shards: a kernel that read
    # past its shard's rows would pick up the neighbour's nonzero x
    nd, nr = 3, 1000
    full = (-301, -37, -5, -1, 0, 1, 5, 37, 301)
    for dt in (np.float32, np.float64):
        dname = np.dtype(dt).name
        for sym in (False, True):
            offs = tuple(o for o in full if o <= 0) if sym else full
            kname = "dia_sym_spmv" if sym else "dia_spmv"
            data = torch.as_tensor(
                rng.standard_normal((nd, nr, len(offs) * 128)).astype(dt),
                device=dev)
            x2 = torch.as_tensor(
                rng.standard_normal((nd * nr, 128)).astype(dt), device=dev)
            _, err, mabs = compare(f"{kname} {dname} banded D={nd}", data, x2,
                                   offs, sym, TOL_KERNEL[dname])
            max_abs[kname] = max(max_abs[kname], mabs)
            show("3.kernel", kernel=kname, dtype=dname,
                 matrix=f"random banded offsets {list(offs)}, D={nd}",
                 rel_l2_vs_plain=err, max_abs_vs_plain=mabs)
    return max_abs


def phase_main_path(a, dev):
    """Phase 4: the main path through the port's entry points."""
    # build first (host assembly is set-up), then zero the counters just
    # before the solves
    runs = []
    for dt, sym in ((np.float64, True), (np.float32, True), (np.float32, False)):
        t0 = time.perf_counter()
        A = build_dist_matrix(a, n_devices=1, symmetric=sym, dtype=dt,
                              local_format="dia", device=dev)
        b_host = gaussian_bump(a.nrows, dtype=dt)
        b = A.to_dist(b_host)
        torch.cuda.synchronize()
        runs.append((dt, sym, A, b, b_host, time.perf_counter() - t0))

    spmv_dia_cuda.reset_launches()
    results = []
    for dt, sym, A, b, b_host, t_asm in runs:
        key = "dia_sym" if sym else "dia"
        before = spmv_dia_cuda.launches[key]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cg(A.as_linear_operator(), b, kmax=20000, rtol=1e-6)
        torch.cuda.synchronize()
        t_solve = time.perf_counter() - t0
        grown = spmv_dia_cuda.launches[key] - before
        results.append((dt, sym, A, res, b_host, t_asm, t_solve, grown))
    counts = dict(spmv_dia_cuda.launches)

    its_per_s = {}
    x64 = b64 = None  # the fp64 solve runs first: the fp32 runs' yardstick
    for dt, sym, A, res, b_host, t_asm, t_solve, grown in results:
        dname = np.dtype(dt).name
        tag = f"{'symmetric' if sym else 'vanilla'} {dname}"
        if not res.converged:
            fail(f"main path CG {tag} did not converge in {res.iterations}")
        if grown < res.iterations + 1:
            fail(f"main path CG {tag}: {grown} kernel launches for "
                 f"{res.iterations + 1} applies")
        x = A.from_dist(res.x).astype(np.float64)
        if not np.all(np.isfinite(x)):
            fail(f"main path CG {tag}: non-finite solution")
        bh = b_host.astype(np.float64)
        host_rel = float(np.linalg.norm(bh - a.matvec(x)) / np.linalg.norm(bh))
        rep_rel = float(res.rnorm) / float(res.rnorm0)
        fields = dict(run=tag, rows=a.nrows, iterations=res.iterations,
                      converged=res.converged, reported_rel_residual=rep_rel,
                      host_rel_residual=host_rel, assemble_s=t_asm,
                      solve_s=t_solve, it_per_s=res.iterations / t_solve,
                      kernel_launches=grown)
        if dt == np.float64:
            if abs(host_rel - rep_rel) > 1e-8:
                fail(f"main path fp64: host residual {host_rel:.3e} vs "
                     f"reported {rep_rel:.3e}")
            x64, b64 = x, bh
        else:
            # what the fp32 true residual is made of: the floor of storing
            # x in fp32 (bench.py:233's estimate, and the fp64 solution
            # rounded to fp32, measured), the rest is drift between the
            # recursive and the true residual
            bn = float(np.linalg.norm(bh))
            x64_32 = x64.astype(np.float32).astype(np.float64)
            fields.update(
                fp32_true_residual_floor_est=float(
                    1.2e-7 * np.abs(x).max() * np.sqrt(a.nrows) / bn),
                fp64_solution_in_fp32_rel_residual=float(
                    np.linalg.norm(b64 - a.matvec(x64_32)) / np.linalg.norm(b64)),
                rel_error_vs_fp64_solution=float(
                    np.linalg.norm(x - x64) / np.linalg.norm(x64)))
        its_per_s[tag] = res.iterations / t_solve
        show("4.main_path", **fields)
    for key in ("dia", "dia_sym"):
        if counts[key] == 0:
            fail(f"main path launched no {key} kernel")
    show("4.main_path", launches=counts)
    phase_plain_witness(a, runs[1], results[1][3])
    return counts, its_per_s


def phase_plain_witness(a, run, res_kernel):
    """Phase 4b: the symmetric fp32 solve again, with the plain torch DIA
    version as the operator on the card. With D=1 the matvec is the local
    DIA apply alone, so the two solves differ only in the kernel; the same
    iteration count and host residual show that the fp32 true residual is
    the arithmetic's, not the kernel's."""
    _, sym, A, b, b_host, _ = run
    if A.n_devices != 1:
        fail("the plain witness needs D=1")

    def plain_op(p):
        return spmv_dia_stacked_plain(A.local_dia_data, p, A.dia_offsets, sym)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cg(plain_op, b, kmax=20000, rtol=1e-6)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    x = A.from_dist(res.x).astype(np.float64)
    bh = b_host.astype(np.float64)
    host_rel = float(np.linalg.norm(bh - a.matvec(x)) / np.linalg.norm(bh))
    x_k = A.from_dist(res_kernel.x).astype(np.float64)
    show("4.plain_witness", run="symmetric float32, plain torch DIA",
         iterations=res.iterations, kernel_iterations=res_kernel.iterations,
         converged=res.converged,
         reported_rel_residual=float(res.rnorm) / float(res.rnorm0),
         host_rel_residual=host_rel, solve_s=t_solve,
         it_per_s=res.iterations / t_solve,
         rel_diff_vs_kernel_solution=float(
             np.linalg.norm(x - x_k) / np.linalg.norm(x_k)))
    if not res.converged or not np.isfinite(host_rel):
        fail("plain witness CG did not converge")
    if abs(res.iterations - res_kernel.iterations) > 0.01 * res_kernel.iterations:
        fail(f"plain witness took {res.iterations} iterations, the kernel "
             f"path {res_kernel.iterations}")


def phase_halo(dev):
    """Phase 5: halo exchange on D=4 stacked shards vs the host oracle."""
    a = create_laplace_2d(HALO_NX, HALO_NX)
    rng = np.random.default_rng(5)
    for fmt in ("dia", "ell"):
        for sym in (False, True):
            for dt in (np.float32, np.float64):
                dname = np.dtype(dt).name
                tag = f"{fmt} {'symmetric' if sym else 'vanilla'} {dname}"
                A = build_dist_matrix(a, n_devices=HALO_D, symmetric=sym,
                                      dtype=dt, local_format=fmt, device=dev)
                x = rng.standard_normal(a.nrows).astype(dt)
                y = A.from_dist(A.matvec(A.to_dist(x)))
                merr = rel_l2(y, a.matvec(x.astype(np.float64)))
                if merr > TOL_ORACLE[dname]:
                    fail(f"halo matvec {tag}: rel err {merr:.3e}")
                b_host = gaussian_bump(a.nrows, dtype=dt)
                res = cg(A.as_linear_operator(), A.to_dist(b_host), kmax=30,
                         rtol=1e-30)
                xs = A.from_dist(res.x).astype(np.float64)
                bh = b_host.astype(np.float64)
                host_rel = float(np.linalg.norm(bh - a.matvec(xs))
                                 / np.linalg.norm(bh))
                rep_rel = float(res.rnorm) / float(res.rnorm0)
                if (res.iterations != 30 or not np.isfinite(host_rel)
                        or abs(host_rel - rep_rel) > TOL_SOLVE[dname]):
                    fail(f"halo CG {tag}: host residual {host_rel:.3e} vs "
                         f"reported {rep_rel:.3e} after {res.iterations}")
                show("5.halo", run=tag, shards=HALO_D, rounds=list(A.plan.rounds),
                     matvec_rel_l2_vs_host=merr, cg_iterations=res.iterations,
                     cg_host_rel_residual=host_rel, cg_reported_rel_residual=rep_rel)


def phase_timing(a, dev):
    """Phase 6: ms per apply at 3200^2 fp32, kernel and plain in turns
    (plain, kernel, kernel, plain), against a same-run device copy."""
    copy_gbs = measure_copy_bandwidth_gbs(dev)
    out = {}
    for sym in (False, True):
        kname = "dia_sym_spmv" if sym else "dia_spmv"
        d = csr_to_dia(a, row_align=ROW_ALIGN, dtype=np.float32, symmetric=sym,
                       device=dev)
        # ||A/9||_inf < 1: chained applies stay bounded (bench.py:363-367)
        d.data.mul_(1.0 / 9.0)
        x = np.zeros(d.nrows_pad, np.float32)
        x[: a.nrows] = gaussian_bump(a.nrows, dtype=np.float32)
        x2 = torch.as_tensor(x, device=dev).view(-1, 128)
        data3 = d.data.unsqueeze(0)

        def kernel(v):
            return spmv_dia_cuda.spmv_dia_2d(d, v)

        def plain(v):
            return spmv_dia_stacked_plain(data3, v, d.offsets, sym)

        t_p1 = bench_chained(plain, x2, iters=25)
        t_k1 = bench_chained(kernel, x2, iters=100)
        t_k2 = bench_chained(kernel, x2, iters=100)
        t_p2 = bench_chained(plain, x2, iters=25)
        ms_k = 1e3 * (t_k1 + t_k2) / 2
        ms_p = 1e3 * (t_p1 + t_p2) / 2
        nbytes = (d.ndiags + 2) * d.nrows_pad * 4  # stored data + x + y
        frac_k = nbytes / (ms_k / 1e3) / 1e9 / copy_gbs
        frac_p = nbytes / (ms_p / 1e3) / 1e9 / copy_gbs
        out[kname] = (ms_k, ms_p)
        show("6.timing", kernel=kname, dtype="float32", rows=a.nrows,
             ndiags=d.ndiags, bytes_per_apply=nbytes, ms=ms_k, plain_ms=ms_p,
             ms_runs=[1e3 * t_k1, 1e3 * t_k2], plain_ms_runs=[1e3 * t_p1, 1e3 * t_p2],
             copy_gbs=copy_gbs, copy_fraction=frac_k, plain_copy_fraction=frac_p)
        del d, data3, x2
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # phase 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)

    # phase 2
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    show("2.build", seconds=time.perf_counter() - t0, library=lib_path.name)

    t0 = time.perf_counter()
    a = create_laplace_2d(NX, NX)
    show("0.generate", rows=a.nrows, nnz=a.nnz, seconds=time.perf_counter() - t0)

    max_abs = phase_kernels(a, dev)
    counts, its_per_s = phase_main_path(a, dev)
    phase_halo(dev)
    times = phase_timing(a, dev)
    show("6.cg", it_per_s=its_per_s)

    kernels = []
    for kname, key, line in (("dia_spmv", "dia", 191),
                             ("dia_sym_spmv", "dia_sym", 265)):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "spmv_torch/csrc/spmv_dia.cu",
            "replaces": f"spmv_tpu/ops/spmv_dia_pallas.py:{line}",
            "launches": counts[key], "max_abs_err": max_abs[kname],
            "ms": times[kname][0], "plain_ms": times[kname][1],
        })
    print(smi[0], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
