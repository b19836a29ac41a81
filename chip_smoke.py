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
     measured in the same run, and CG iterations/s;
  7. the WELL kernel vs its plain torch version, fp32 and fp64: the 4M-row
     banded-random bench matrix (bench.py:114, tile_groups 64, int16 pos),
     a pair=True packing and an int32-pos packing (tile_groups 8) of 200k
     rows of the same generator, D=3 stacked shards of a DistMatrix, and
     spmv_well_sym on a matrix whose window split leaves a far remainder
     (relative L2 <= 1e-6 fp32, <= 1e-13 fp64; fp32 also <= 2e-5 vs the
     host f64 CSR oracle);
  8. the general-sparsity main path at full size: fem_p1_2d(800_000) ->
     rcm_reorder(keep_best=True) -> build_dist_matrix, symmetric fp32 via
     local_format="auto" (must select "well"), symmetric fp64 via "well"
     and vanilla fp32 via "well", each -> Jacobi-PCG (kmax=20000,
     rtol=1e-6); before the solves, the kernel vs its plain version on
     every stack they launch (L K=48 and L^T K=32 of both symmetric
     operators, the vanilla stack; tolerances as in phase 7); the WELL
     launch counter, zeroed just before the solves, must show every apply
     went through the kernel (2 launches per symmetric apply, 1 per
     vanilla one); A x at each solution, through the kernel, must agree
     with the host CSR (1e-12 fp64, 2e-5 fp32, relative to || |A| |x| ||);
     the fp64 solve runs again through the plain torch WELL version (8b),
     which must take the same iterations within 1% and reach a solution
     within 1e-8 (relative L2) of the kernel path's — on this operator
     (|| |A| |x| || ~ 1e9 ||b||) CG's reported and true residuals part in
     fp64 too, and the witness shows that is not the kernel's doing; 8c
     runs the symmetric fp32 and fp64 solves as plain CG with no
     preconditioner and prints whether they reach 1e-6 in 20000
     iterations (the reason the path is Jacobi-PCG; not gated);
  9. the WELL halo path: an RCM'd 50k-node FEM on D=4 stacked shards,
     vanilla and symmetric, fp32 and fp64 — one matvec vs the host oracle
     and a 30-iteration Jacobi-PCG;
 10. ms per apply of every ported kernel, kernel and plain in turns, with
     the library yardstick (one torch CSR @ x call, cuSPARSE; the port never
     calls it) and the bytes bound at 3.35 TB/s (the H100 SXM's published
     HBM rate): the DIA kernels at 3200^2, spmv_well on the 4M bench matrix
     and on the 800k FEM's lower-triangle stack.
The last two lines are the kernels JSON and {"ok": true, "device": ...}.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from spmv_torch import _build
from spmv_torch.corpus import circuit_network, fem_p1_2d
from spmv_torch.formats.csr import CSRHost
from spmv_torch.formats.dia import csr_to_dia
from spmv_torch.formats.well import csr_to_well, csr_to_well_sym
from spmv_torch.gen import create_laplace_2d, gaussian_bump
from spmv_torch.ops import spmv_dia_cuda, spmv_well_cuda
from spmv_torch.ops.spmv_dia import spmv_dia_stacked_plain
from spmv_torch.ops.spmv_well import (
    far_add,
    spmv_well_stacked_plain,
    spmv_well_sym,
)
from spmv_torch.parallel.dist_matrix import build_dist_matrix
from spmv_torch.reorder import rcm_reorder
from spmv_torch.solvers.cg import cg
from spmv_torch.utils.timing import bench_chained, measure_copy_bandwidth_gbs

NX = 3200           # headline: 3200^2 = 10.24M rows (bench.py:358)
ROW_ALIGN = 1024    # bench.py:368
HALO_NX, HALO_D = 512, 4
TOL_KERNEL = {"float32": 1e-6, "float64": 1e-13}   # kernel vs plain
TOL_ORACLE = {"float32": 2e-5, "float64": 1e-12}   # vs host f64 CSR
TOL_SOLVE = {"float32": 1e-3, "float64": 1e-9}     # residual consistency
# fp64 FEM solution through the plain WELL version vs through the kernel
# (relative L2); fma contraction alone leaves them ~1e-11 apart
WITNESS_SOLUTION_TOL = 1e-8
N_WELL = 4_000_000   # bench.py:359, the WELL audit shape
N_WELL_SMALL = 200_000
N_FEM = 800_000      # bench.py:254, the corpus fem2d size
HALO_FEM = 50_000
CIRCUIT_NX = 400     # circuit_network(400): 160k nodes with long-range edges
HBM_TBS = 3.35       # H100 SXM published HBM rate (TB/s)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAIL: {msg}")


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def show(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def reset_counters() -> None:
    spmv_dia_cuda.reset_launches()
    spmv_well_cuda.reset_launches()


def check_close(name, y_k, y_p, tol):
    """(kernel output on the host, rel L2 and max abs difference vs the
    plain output); fails past ``tol`` or on a non-finite kernel value."""
    y_k, y_p = y_k.cpu().numpy(), y_p.cpu().numpy()
    if not np.all(np.isfinite(y_k)):
        fail(f"{name}: non-finite kernel output")
    err = rel_l2(y_k, y_p)
    max_abs = float(np.abs(y_k.astype(np.float64) - y_p).max())
    if err > tol:
        fail(f"{name}: kernel vs plain rel L2 {err:.3e} > {tol:.0e}")
    return y_k, err, max_abs


def compare(name, data, x2, offsets, symmetric, tol):
    """One kernel launch vs the plain version on the same inputs."""
    y_k = spmv_dia_cuda.spmv_dia_stacked(data, x2, offsets, symmetric)
    torch.cuda.synchronize()
    y_p = spmv_dia_stacked_plain(data, x2, offsets, symmetric)
    return check_close(name, y_k, y_p, tol)


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

    reset_counters()
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
        out[kname] = (ms_k, ms_p, nbytes)
        show("6.timing", kernel=kname, dtype="float32", rows=a.nrows,
             ndiags=d.ndiags, bytes_per_apply=nbytes, ms=ms_k, plain_ms=ms_p,
             ms_runs=[1e3 * t_k1, 1e3 * t_k2], plain_ms_runs=[1e3 * t_p1, 1e3 * t_p2],
             copy_gbs=copy_gbs, copy_fraction=frac_k, plain_copy_fraction=frac_p)
        del d, data3, x2
    return out


def build_well_matrix(n: int, rng) -> CSRHost:
    """bench.py:114 ``_build_well_matrix``: banded random with holes,
    offsets (-1500, -130, -1, 0, 1, 128, 1400), 85% of entries kept."""
    rows, cols, vals = [], [], []
    for off in (-1500, -130, -1, 0, 1, 128, 1400):
        i = np.arange(max(0, -off), min(n, n - off))
        i = i[rng.random(len(i)) < 0.85]
        rows.append(i)
        cols.append(i + off)
        vals.append(rng.standard_normal(len(i)))
    return CSRHost.from_coo(np.concatenate(rows), np.concatenate(cols),
                            np.concatenate(vals).astype(np.float32), n, n)


def scale_rows(a: CSRHost) -> None:
    """bench.py:384-387: scale so ||A||_inf = 0.9, so chained applies stay
    bounded."""
    row_sums = np.bincount(np.repeat(np.arange(a.nrows), a.row_nnz()),
                           weights=np.abs(a.values), minlength=a.nrows)
    a.values *= np.float32(0.9 / max(row_sums.max(), 1e-30))


def as_dtype(w, dt):
    """The same WellMatrix with values cast to ``dt`` (exact from fp32)."""
    return dataclasses.replace(w, values=w.values.to(dt))


def well_compare(name, values, pos, w0, x2, tg, tol):
    """One WELL kernel launch vs the plain version on the same inputs."""
    y_k = spmv_well_cuda.spmv_well_stacked(values, pos, w0, x2, tg)
    torch.cuda.synchronize()
    y_p = spmv_well_stacked_plain(values, pos, w0, x2, tg)
    return check_close(name, y_k, y_p, tol)


def phase_well_kernel(dev):
    """Phase 7. Returns (largest abs kernel-vs-plain difference, the 4M
    bench matrix scaled as bench.py scales it, its fp32 WellMatrix)."""
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    a4 = build_well_matrix(N_WELL, rng)
    t_gen = time.perf_counter() - t0
    scale_rows(a4)
    t0 = time.perf_counter()
    w4 = csr_to_well(a4, tile_groups=64, dtype=np.float32, device=dev)
    show("7.well_pack", matrix=f"bench banded-random {N_WELL}", nnz=a4.nnz,
         k_slots=w4.k_slots, wseg=w4.wseg, tile_groups=64,
         pos_dtype=str(w4.pos.dtype), occupancy=w4.occupancy,
         generate_s=t_gen, pack_s=time.perf_counter() - t0)
    small = build_well_matrix(N_WELL_SMALL, np.random.default_rng(1))
    cases = [(f"bench {N_WELL} tg64", a4, w4)]
    for tg, pair in ((64, True), (8, False)):
        w = csr_to_well(small, tile_groups=tg, dtype=np.float32, pair=pair,
                        device=dev)
        cases.append((f"bench {N_WELL_SMALL} tg{tg}{' paired' if pair else ''}",
                      small, w))
    max_abs = 0.0
    for tag, a, w in cases:
        if "paired" in tag and not w.paired:
            fail(f"{tag}: pair=True packed no paired slot")
        for dt in (torch.float32, torch.float64):
            dname = str(dt).split(".")[1]
            wd = as_dtype(w, dt)
            x = np.zeros(wd.ncols_pad)
            x[: a.ncols] = rng.standard_normal(a.ncols)
            x2 = torch.as_tensor(x, dtype=dt, device=dev).view(-1, 128)
            y, err, mabs = well_compare(
                f"spmv_well {tag} {dname}", wd.values.unsqueeze(0),
                wd.pos.unsqueeze(0), wd.w0.unsqueeze(0), x2, wd.tile_groups,
                TOL_KERNEL[dname])
            max_abs = max(max_abs, mabs)
            fields = dict(kernel="spmv_well", dtype=dname, matrix=tag,
                          k_slots=wd.k_slots, paired=wd.paired,
                          pos_dtype=str(wd.pos.dtype), rel_l2_vs_plain=err,
                          max_abs_vs_plain=mabs)
            if dt == torch.float32:
                oerr = rel_l2(y.ravel()[: a.nrows], a.matvec(x[: a.ncols]))
                if oerr > TOL_ORACLE[dname]:
                    fail(f"spmv_well {tag} fp32 vs host CSR oracle {oerr:.3e}")
                fields["rel_l2_vs_host_csr"] = oerr
            show("7.kernel", **fields)
            del wd, x2

    # D=3 stacked shards of a DistMatrix: a kernel that read past its
    # shard's columns would pick up the neighbour's nonzero x
    for dt in (np.float32, np.float64):
        dname = np.dtype(dt).name
        A = build_dist_matrix(small, n_devices=3, dtype=dt, local_format="well",
                              device=dev)
        x = rng.standard_normal(small.nrows).astype(dt)
        x2 = A.to_dist(x)
        _, err, mabs = well_compare(
            f"spmv_well D=3 {dname}", A.local_well_values, A.local_well_pos,
            A.local_well_w0, x2, A.well_meta[2], TOL_KERNEL[dname])
        max_abs = max(max_abs, mabs)
        merr = rel_l2(A.from_dist(A.matvec(x2)), small.matvec(x.astype(np.float64)))
        if merr > TOL_ORACLE[dname]:
            fail(f"D=3 well matvec {dname}: rel err {merr:.3e}")
        show("7.kernel", kernel="spmv_well", dtype=dname,
             matrix=f"bench {N_WELL_SMALL}, D=3 stacked", well_meta=list(A.well_meta),
             rel_l2_vs_plain=err, max_abs_vs_plain=mabs,
             matvec_rel_l2_vs_host=merr)

    # spmv_well_sym with a far remainder: an unreordered circuit network's
    # random long-range resistors fall outside every 512-segment window
    c = circuit_network(CIRCUIT_NX)
    for dt in (np.float32, np.float64):
        dname = np.dtype(dt).name
        sw = csr_to_well_sym(c, tile_groups=16, dtype=dt, device=dev)
        far = sum(f[0].numel() for f in (sw.farl, sw.faru) if f is not None)
        if far == 0:
            fail("spmv_well_sym case has an empty far remainder")
        x = torch.as_tensor(rng.standard_normal(sw.nrows_pad).astype(dt), device=dev)
        y_k = spmv_well_sym(sw, x)
        torch.cuda.synchronize()
        y_p = sym_plain(sw, x)
        y, err, mabs = check_close(f"spmv_well_sym {dname}", y_k, y_p,
                                   TOL_KERNEL[dname])
        max_abs = max(max_abs, mabs)
        fields = dict(kernel="spmv_well", dtype=dname,
                      matrix=f"spmv_well_sym circuit_network({CIRCUIT_NX}), "
                             f"far nnz {far}",
                      rel_l2_vs_plain=err, max_abs_vs_plain=mabs)
        if dt == np.float32:
            xh = x.cpu().numpy()[: c.ncols].astype(np.float64)
            oerr = rel_l2(y[: c.nrows], c.matvec(xh))
            if oerr > TOL_ORACLE[dname]:
                fail(f"spmv_well_sym fp32 vs host CSR oracle {oerr:.3e}")
            fields["rel_l2_vs_host_csr"] = oerr
        show("7.kernel", **fields)
    return max_abs, a4, w4


def sym_plain(sw, xp):
    """spmv_well_sym through the plain WELL version, on the same device."""
    def plain(w):
        return spmv_well_stacked_plain(
            w.values.unsqueeze(0), w.pos.unsqueeze(0), w.w0.unsqueeze(0),
            xp.view(-1, 128), w.tile_groups).view(-1)

    y = plain(sw.lower) + plain(sw.upper) + sw.diag * xp
    for far in (sw.farl, sw.faru):
        if far is not None:
            far_add(y.view(1, -1), *(t.view(1, -1) for t in far), xp.view(1, -1))
    return y


def well_stats(A, a):
    """Geometry of a DistMatrix's WELL stacks, for the phase lines."""
    k, wseg, tg, paired = A.well_meta
    stored = int((A.local_well_values != 0).sum())
    slots = A.local_well_values.numel()
    if A.symmetric:
        stored += int((A.local_wellT_values != 0).sum())
        slots += A.local_wellT_values.numel()
    return dict(rows=a.nrows, nnz=a.nnz, k_slots=k,
                k_slots_T=A.wellT_meta[0] if A.symmetric else None,
                wseg=wseg, tile_groups=tg, paired=paired,
                occupancy=stored / slots,
                far_nnz=A.well_far_nnz + A.well_farT_nnz)


def phase_fem_main_path(dev):
    """Phase 8: the general-sparsity main path through the port's entry
    points. Returns (WELL launch count of the solves, its/s, the RCM'd FEM
    matrix, the symmetric fp32 operator, the largest abs kernel-vs-plain
    difference on its stacks)."""
    t0 = time.perf_counter()
    a = fem_p1_2d(N_FEM)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    a, _ = rcm_reorder(a, keep_best=True)
    t_rcm = time.perf_counter() - t0
    show("8.fem", rows=a.nrows, nnz=a.nnz, generate_s=t_gen, rcm_s=t_rcm)
    runs = []
    for dt, sym, fmt in ((np.float32, True, "auto"), (np.float64, True, "well"),
                         (np.float32, False, "well")):
        t0 = time.perf_counter()
        A = build_dist_matrix(a, n_devices=1, symmetric=sym, dtype=dt,
                              local_format=fmt, device=dev)
        if A.local_format != "well":
            fail(f"local_format={fmt!r} built {A.local_format!r}, not 'well'")
        b_host = gaussian_bump(a.nrows, dtype=dt)
        b = A.to_dist(b_host)
        torch.cuda.synchronize()
        runs.append((dt, sym, fmt, A, b, b_host, time.perf_counter() - t0))

    # the kernel vs its plain version at the main path's own shapes: every
    # stack the solves below launch (L and L^T, or the vanilla stack)
    rng = np.random.default_rng(8)
    max_abs = 0.0
    for dt, sym, fmt, A, _, _, _ in runs:
        dname = np.dtype(dt).name
        x2 = A.to_dist(rng.standard_normal(a.nrows).astype(dt))
        stacks = [("L" if sym else "A", A.local_well_values, A.local_well_pos,
                   A.local_well_w0, A.well_meta)]
        if sym:
            stacks.append(("L^T", A.local_wellT_values, A.local_wellT_pos,
                           A.local_wellT_w0, A.wellT_meta))
        for part, values, pos, w0, meta in stacks:
            _, err, mabs = well_compare(
                f"spmv_well FEM {part} {dname} ({fmt})", values, pos, w0, x2,
                meta[2], TOL_KERNEL[dname])
            max_abs = max(max_abs, mabs)
            show("8.kernel", kernel="spmv_well", dtype=dname,
                 matrix=f"fem_p1_2d {N_FEM} RCM, {part} stack ({fmt})",
                 k_slots=meta[0], tile_groups=meta[2], pos_dtype=str(pos.dtype),
                 rel_l2_vs_plain=err, max_abs_vs_plain=mabs)
        del x2

    reset_counters()
    results = []
    for dt, sym, fmt, A, b, b_host, t_asm in runs:
        before = spmv_well_cuda.launches["well"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cg(A.as_linear_operator(), b, kmax=20000, rtol=1e-6,
                 preconditioner=A.jacobi_preconditioner())
        torch.cuda.synchronize()
        results.append((dt, sym, fmt, A, res, b_host, t_asm,
                        time.perf_counter() - t0,
                        spmv_well_cuda.launches["well"] - before))
    counts = dict(spmv_well_cuda.launches)

    its_per_s = {}
    for dt, sym, fmt, A, res, b_host, t_asm, t_solve, grown in results:
        dname = np.dtype(dt).name
        tag = f"{'symmetric' if sym else 'vanilla'} {dname} ({fmt})"
        if not res.converged:
            fail(f"FEM CG {tag} did not converge in {res.iterations}")
        per_apply = 2 if sym else 1
        if grown < per_apply * (res.iterations + 1):
            fail(f"FEM CG {tag}: {grown} WELL launches for "
                 f"{res.iterations + 1} applies")
        x = A.from_dist(res.x).astype(np.float64)
        if not np.all(np.isfinite(x)):
            fail(f"FEM CG {tag}: non-finite solution")
        bh = b_host.astype(np.float64)
        host_rel = float(np.linalg.norm(bh - a.matvec(x)) / np.linalg.norm(bh))
        rep_rel = float(res.rnorm) / float(res.rnorm0)
        # A x at the solution through the kernel operator vs the host CSR,
        # relative to || |A| |x| ||: the true residual b - A x cancels to
        # ~1e-6 of ||b|| while || |A| |x| || is ~1e9 ||b|| on this
        # operator, so residuals carry rounding that this measure does not
        b = A.to_dist(b_host)
        ax = A.matvec(res.x)
        dev_rel = float(torch.linalg.vector_norm(b - ax)
                        / torch.linalg.vector_norm(b))
        absa = CSRHost(a.rowptr, a.colind, np.abs(a.values.astype(np.float64)),
                       a.ncols)
        ax_scale = float(np.linalg.norm(absa.matvec(np.abs(x))))
        op_err = float(np.linalg.norm(A.from_dist(ax).astype(np.float64)
                                      - a.matvec(x)) / ax_scale)
        fields = dict(run=tag, **well_stats(A, a), assemble_s=t_asm,
                      rcm_s=t_rcm, preconditioner="jacobi",
                      iterations=res.iterations, converged=res.converged,
                      reported_rel_residual=rep_rel, host_rel_residual=host_rel,
                      kernel_rel_residual=dev_rel,
                      abs_ax_over_b=ax_scale / float(np.linalg.norm(bh)),
                      ax_at_solution_err_vs_host=op_err,
                      solve_s=t_solve, it_per_s=res.iterations / t_solve,
                      well_launches=grown)
        if op_err > TOL_ORACLE[dname]:
            fail(f"FEM CG {tag}: A x at the solution differs from the host "
                 f"CSR by {op_err:.3e} of || |A| |x| ||")
        if dt == np.float64:
            fields.update(phase_fem_plain_witness(a, A, b, res))
        its_per_s[tag] = res.iterations / t_solve
        show("8.main_path", **fields)
    if counts["well"] == 0:
        fail("the FEM main path launched no WELL kernel")
    show("8.main_path", launches=counts)
    phase_fem_plain_cg(runs[:2])
    return counts["well"], its_per_s, a, runs[0][3], max_abs


def phase_fem_plain_cg(runs):
    """Phase 8c: the symmetric fp32 and fp64 solves again as plain CG, with
    no preconditioner (kmax=20000, rtol=1e-6): the record of why the main
    path is Jacobi-PCG. Printed, not gated; after the counters are read."""
    for dt, sym, fmt, A, b, _, _ in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cg(A.as_linear_operator(), b, kmax=20000, rtol=1e-6)
        torch.cuda.synchronize()
        t_solve = time.perf_counter() - t0
        show("8.plain_cg", run=f"symmetric {np.dtype(dt).name} ({fmt}), "
             "no preconditioner", kmax=20000, rtol=1e-6,
             converged=bool(res.converged), iterations=res.iterations,
             reported_rel_residual=float(res.rnorm) / float(res.rnorm0),
             solve_s=t_solve)


def phase_fem_plain_witness(a, A, b, res_kernel):
    """Phase 8b: the symmetric fp64 solve again, with the plain torch WELL
    version as the operator on the card (D=1, no ghosts, empty far: the
    matvec is L x + L^T x + D x alone). The same iteration count (within
    1%), a solution within WITNESS_SOLUTION_TOL of the kernel path's, and
    the same reported residual show that the gap between the reported and
    the true residual is the fp64 arithmetic's on this operator, not the
    kernel's."""
    if A.n_devices != 1 or A.well_far_nnz or A.well_farT_nnz:
        fail("the FEM plain witness needs D=1 and an empty far remainder")
    d2 = A.diagonal.view(-1, 128)

    def plain_op(p):
        y = spmv_well_stacked_plain(A.local_well_values, A.local_well_pos,
                                    A.local_well_w0, p, A.well_meta[2])
        y = y + spmv_well_stacked_plain(A.local_wellT_values, A.local_wellT_pos,
                                        A.local_wellT_w0, p, A.wellT_meta[2])
        return y + d2 * p

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cg(plain_op, b, kmax=20000, rtol=1e-6,
             preconditioner=A.jacobi_preconditioner())
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    x = A.from_dist(res.x).astype(np.float64)
    x_k = A.from_dist(res_kernel.x).astype(np.float64)
    bh = A.from_dist(b).astype(np.float64)
    out = dict(plain_witness_iterations=res.iterations,
               plain_witness_reported_rel_residual=float(res.rnorm) / float(res.rnorm0),
               plain_witness_host_rel_residual=float(
                   np.linalg.norm(bh - a.matvec(x)) / np.linalg.norm(bh)),
               plain_witness_rel_diff_vs_kernel_solution=float(
                   np.linalg.norm(x - x_k) / np.linalg.norm(x_k)),
               plain_witness_solve_s=t_solve)
    if not res.converged or abs(res.iterations - res_kernel.iterations) > (
            0.01 * res_kernel.iterations):
        fail(f"FEM plain witness: {res.iterations} iterations "
             f"(converged {res.converged}), the kernel path "
             f"{res_kernel.iterations}")
    diff = out["plain_witness_rel_diff_vs_kernel_solution"]
    if not diff <= WITNESS_SOLUTION_TOL:
        fail(f"FEM plain witness: solution {diff:.3e} from the kernel "
             f"path's (limit {WITNESS_SOLUTION_TOL:.0e})")
    return out


def phase_well_halo(dev):
    """Phase 9: the WELL local blocks with the halo exchange on D=4 stacked
    shards vs the host oracle."""
    a, _ = rcm_reorder(fem_p1_2d(HALO_FEM, seed=3), keep_best=True)
    rng = np.random.default_rng(9)
    for sym in (False, True):
        for dt in (np.float32, np.float64):
            dname = np.dtype(dt).name
            tag = f"well {'symmetric' if sym else 'vanilla'} {dname}"
            A = build_dist_matrix(a, n_devices=HALO_D, symmetric=sym, dtype=dt,
                                  local_format="well", device=dev)
            x = rng.standard_normal(a.nrows).astype(dt)
            y = A.from_dist(A.matvec(A.to_dist(x)))
            merr = rel_l2(y, a.matvec(x.astype(np.float64)))
            if merr > TOL_ORACLE[dname]:
                fail(f"halo matvec {tag}: rel err {merr:.3e}")
            b_host = gaussian_bump(a.nrows, dtype=dt)
            res = cg(A.as_linear_operator(), A.to_dist(b_host), kmax=30,
                     rtol=1e-30, preconditioner=A.jacobi_preconditioner())
            xs = A.from_dist(res.x).astype(np.float64)
            bh = b_host.astype(np.float64)
            host_rel = float(np.linalg.norm(bh - a.matvec(xs)) / np.linalg.norm(bh))
            rep_rel = float(res.rnorm) / float(res.rnorm0)
            # relative to the residual where it exceeds ||b|| (this
            # operator's residual grows in the first iterations)
            if (res.iterations != 30 or not np.isfinite(host_rel)
                    or abs(host_rel - rep_rel) > TOL_SOLVE[dname] * max(rep_rel, 1.0)):
                fail(f"halo CG {tag}: host residual {host_rel:.3e} vs "
                     f"reported {rep_rel:.3e} after {res.iterations}")
            show("9.halo", run=tag, rows=a.nrows, shards=HALO_D,
                 rounds=list(A.plan.rounds), **{k: v for k, v in well_stats(A, a).items()
                                               if k not in ("rows", "nnz")},
                 matvec_rel_l2_vs_host=merr, cg_iterations=res.iterations,
                 cg_host_rel_residual=host_rel, cg_reported_rel_residual=rep_rel)


def csr_tensor(a: CSRHost, dev, scale: float = 1.0):
    """The library yardstick's operand: torch CSR (int32 indices) on the
    card."""
    with warnings.catch_warnings():  # torch's "beta" notice for sparse CSR
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.as_tensor(a.rowptr.astype(np.int32), device=dev),
            torch.as_tensor(a.colind, device=dev),
            torch.as_tensor(a.values.astype(np.float32) * np.float32(scale),
                            device=dev),
            size=a.shape)


def time_in_turns(kernel, plain, x0, iters_k=100, iters_p=25):
    """(kernel ms, plain ms, runs) in turns plain, kernel, kernel, plain."""
    t_p1 = bench_chained(plain, x0, iters=iters_p)
    t_k1 = bench_chained(kernel, x0, iters=iters_k)
    t_k2 = bench_chained(kernel, x0, iters=iters_k)
    t_p2 = bench_chained(plain, x0, iters=iters_p)
    return (1e3 * (t_k1 + t_k2) / 2, 1e3 * (t_p1 + t_p2) / 2,
            [1e3 * t_k1, 1e3 * t_k2], [1e3 * t_p1, 1e3 * t_p2])


def library_ms(a: CSRHost, dev, scale: float) -> float:
    """ms of one torch CSR @ x (cuSPARSE) on the same matrix, chained."""
    m = csr_tensor(a, dev, scale)
    x0 = torch.as_tensor(gaussian_bump(a.ncols, dtype=np.float32), device=dev)
    ms = 1e3 * bench_chained(lambda v: m @ v, x0, iters=50)
    del m
    return ms


def bound_ms(nbytes: float) -> float:
    return nbytes / (HBM_TBS * 1e12) * 1e3


def phase_timing_all(a_lap, dia_times, a4, w4, a_fem, A_fem, dev):
    """Phase 10: library and bound for the DIA kernels (their kernel and
    plain times are phase 6's), and spmv_well kernel/plain/library/bound
    on the 4M bench matrix and on the 800k FEM's lower-triangle stack."""
    copy_gbs = measure_copy_bandwidth_gbs(dev)
    out = {}
    # the DIA kernels: phase 6 scaled the Laplacian by 1/9; both compute
    # the full A x, so one library time serves both
    lib = library_ms(a_lap, dev, 1.0 / 9.0)
    for kname in ("dia_spmv", "dia_sym_spmv"):
        ms_k, ms_p, nbytes = dia_times[kname]  # (K+2)*npad*itemsize
        out[kname] = dict(ms=ms_k, plain_ms=ms_p, library_ms=lib,
                          bound_ms=bound_ms(nbytes), bytes=nbytes)
        show("10.timing", kernel=kname, dtype="float32", rows=a_lap.nrows,
             **out[kname], library="torch CSR @ x (cuSPARSE), full matrix",
             copy_gbs=copy_gbs)

    def well_timing(tag, values, pos, w0, tg, a_lib, lib_scale, nnz, nrows,
                    ncols):
        x = np.zeros(values.shape[2] * 128, np.float32)
        x[:ncols] = gaussian_bump(ncols, dtype=np.float32)
        x2 = torch.as_tensor(x, device=dev).view(-1, 128)
        args = (values, pos, w0)

        def kernel(v):
            return spmv_well_cuda.spmv_well_stacked(*args, v, tg)

        def plain(v):
            return spmv_well_stacked_plain(*args, v, tg)

        ms_k, ms_p, runs_k, runs_p = time_in_turns(kernel, plain, x2)
        nbytes = (nnz * (values.element_size() + pos.element_size())
                  + w0.numel() * 4 + (ncols + nrows) * 4)
        stored = (values.numel() * (values.element_size() + pos.element_size())
                  + w0.numel() * 4 + 2 * values.shape[2] * 128 * 4)
        row = dict(ms=ms_k, plain_ms=ms_p,
                   library_ms=library_ms(a_lib, dev, lib_scale),
                   bound_ms=bound_ms(nbytes), bytes=nbytes)
        show("10.timing", kernel="spmv_well", matrix=tag, dtype="float32",
             k_slots=values.shape[1], tile_groups=tg, pos_dtype=str(pos.dtype),
             **row, ms_runs=runs_k, plain_ms_runs=runs_p,
             stored_bytes=stored, stored_copy_fraction=stored / (ms_k / 1e3) / 1e9 / copy_gbs,
             library="torch CSR @ x (cuSPARSE), same matrix", copy_gbs=copy_gbs)
        return row

    bench = well_timing(f"bench {N_WELL}", w4.values.unsqueeze(0),
                        w4.pos.unsqueeze(0), w4.w0.unsqueeze(0), 64, a4, 1.0,
                        a4.nnz, a4.nrows, a4.ncols)
    # the symmetric main path's L stack (D=1, empty far remainder, so the
    # stack is the RCM'd FEM's strict lower triangle), scaled by one factor
    # so ||L||_inf = 0.9 and chained applies stay bounded
    lower, _ = a_fem.split_lower_diag()
    if A_fem.n_devices != 1 or A_fem.well_far_nnz:
        fail("the FEM lower stack is not the whole lower triangle")
    row_sums = np.bincount(np.repeat(np.arange(lower.nrows), lower.row_nnz()),
                           weights=np.abs(lower.values), minlength=lower.nrows)
    scale = float(0.9 / row_sums.max())
    fem = well_timing(f"fem_p1_2d {N_FEM} RCM lower stack",
                      A_fem.local_well_values * scale, A_fem.local_well_pos,
                      A_fem.local_well_w0, A_fem.well_meta[2], lower, scale,
                      lower.nnz, lower.nrows, lower.ncols)
    out["spmv_well"] = dict(fem, other_shapes={f"bench {N_WELL}": bench})
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

    t0 = time.perf_counter()
    max_abs = phase_kernels(a, dev)
    show("3.seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    counts, its_per_s = phase_main_path(a, dev)
    show("4.seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_halo(dev)
    show("5.seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    times = phase_timing(a, dev)
    show("6.cg", it_per_s=its_per_s)
    show("6.seconds", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    max_abs["spmv_well"], a4, w4 = phase_well_kernel(dev)
    show("7.seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    counts["well"], fem_its, a_fem, A_fem, fem_abs = phase_fem_main_path(dev)
    max_abs["spmv_well"] = max(max_abs["spmv_well"], fem_abs)
    show("8.seconds", seconds=time.perf_counter() - t0, it_per_s=fem_its)
    t0 = time.perf_counter()
    phase_well_halo(dev)
    show("9.seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    timing = phase_timing_all(a, times, a4, w4, a_fem, A_fem, dev)
    show("10.seconds", seconds=time.perf_counter() - t0)

    kernels = []
    for kname, key, source, replaces in (
            ("dia_spmv", "dia", "spmv_torch/csrc/spmv_dia.cu",
             "spmv_tpu/ops/spmv_dia_pallas.py:191"),
            ("dia_sym_spmv", "dia_sym", "spmv_torch/csrc/spmv_dia.cu",
             "spmv_tpu/ops/spmv_dia_pallas.py:265"),
            ("spmv_well", "well", "spmv_torch/csrc/spmv_well.cu",
             "spmv_tpu/ops/spmv_well_pallas.py:43")):
        row = timing[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[key],
            "max_abs_err": max_abs[kname], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": "bytes", "library_ms": row["library_ms"],
            **({"other_shapes": row["other_shapes"]} if "other_shapes" in row
               else {}),
        })
    print(smi[0], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
