#!/usr/bin/env python3
"""Smoke run of spmv_torch on one NVIDIA GPU: the quickest proof that the
port builds, is right, and runs its main path through its CUDA kernels.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and continued):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels (csrc/*.cu) with nvcc, print the build seconds;
  3. each kernel vs its plain torch version on the card, fp32, fp64 and
     bf16, vanilla and symmetric: the 3200^2 Laplacian, and a random banded
     matrix with odd offsets on D=3 stacked shards (relative L2 <= 1e-6
     fp32, <= 1e-13 fp64, <= 8e-3 bf16, and bf16 on the Laplacian bit for
     bit); a second apply gives the same bits; fp32 also vs the host f64
     CSR oracle (<= 2e-5); each apply prints its route (dia_spmv:
     dia_spmv_rows and its rows a thread, or the loop kernel) and each
     dia_sym_spmv apply its window plan (tile rows, intervals, x windows,
     shared bytes, any interval read from global memory);
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
  6. ms per apply of each kernel and its plain version at 3200^2, fp32
     and fp64 (CUDA events, chained applies; the kernel's device time from
     torch.profiler beside it), each as a fraction of a device copy
     measured in the same run, and CG iterations/s;
 22. (after 6) the fused CG loop's three kernels (csrc/cg_update.cu) at
     3200^2, float64 and float32: a 100-iteration fused solve, 3 launches
     an iteration, a second solve the same bits, the torch loop's solve
     the same iterations and within 1e-12 / 1e-5 (relative) in x and |r|;
     one iteration's kernels vs their plain versions; device us an
     iteration of the kernels and of the torch loop's vector work (the
     apply left out) beside the 10-pass bound (phase_cg_update);
 23. (after 22) the multigrid's kernels (csrc/symgs_dia.cu) on HPCG's
     27-point operator at each level of hpcg_256.mgpcg (256^3 to 32^3)
     and at 640 x 64 x 32 (lines of 640 points), float64 and float32:
     every sweep kind of a V-cycle level and the restricted residual bit
     for bit against their plain versions, the launches (2 a sweep
     direction) and bands a plane from a reset; device ms of each beside its plain version's and its least-bytes
     bound (phase_symgs);
 24. (after 23) dia_sym_spmv's stream kernel (csrc/dia_stream.cu) and tile
     kernel on HPCG's 27-point offsets at 256^3, fp64 and fp32 (the route
     must pick the stream kernel), and on the 3200^2 Laplacian, fp64 (the
     route must keep the tile kernel): the same bits, within TOL_KERNEL of
     the plain version, one launch each under its key; device ms of each
     in turns beside the plain version's and the bound (phase_dia_stream);
 25. (after 24) DOLFINx's P1 Poisson operator of poisson2d_4480.matvec
     (bench_h100/matrices/poisson2d_p1.py: 4480 x 2240 cells, 10.04M
     dofs, its level order) through the general-sparsity path as the
     benchmark's System builds it, build_dist_matrix(well, symmetric
     float64): the host seconds by phase, both stacks' geometry and
     layout_bytes; each stack's kernel vs its plain version; one matvec 2
     launches under "well" and none under the DIA or DS keys; the matvec
     vs the host CSR (<= 1e-14 of || |A| |x| ||), twice the same bits;
     device ms of the L and L^T launches and of the whole apply (the rest
     is the torch glue) beside each launch's row-list bound, the apply's
     least bytes and layout_bytes, with cuSPARSE's float64 CSR @ x
     (phase_poisson2d);
  7. the WELL kernel, which reads each stack's warp-sliced row lists, vs
     their plain torch version, fp32 and fp64 (and that plain version vs
     the WELL formula's, bit for bit, here and wherever a single-RHS WELL
     kernel is checked): the 4M-row banded-random bench matrix (bench.py:114,
     tile_groups 64), a pair=True packing and a tile_groups 8 packing of
     200k rows of the same generator, D=3 stacked shards of a DistMatrix,
     and spmv_well_sym on a matrix whose window split leaves a far
     remainder (relative L2 <= 1e-6 fp32, <= 1e-13 fp64; fp32 also <= 2e-5
     vs the host f64 CSR oracle);
  8. the general-sparsity main path at full size: fem_p1_2d(800_000) ->
     rcm_reorder(keep_best=True) -> build_dist_matrix, symmetric fp32 via
     local_format="auto" (must select "well"), symmetric fp64 via "well"
     and vanilla fp32 via "well", each -> Jacobi-PCG (kmax=20000,
     rtol=1e-6); before the solves, the kernel vs its plain version on
     every stack they launch (L K=48 and L^T K=32 of both symmetric
     operators, the vanilla stack; tolerances as in phase 7), each also bit
     for bit against the block kernel's column at nrhs 1 (both kernels read
     the row lists), with the row
     lists' geometry and the packer's seconds printed; the WELL
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
     (applied twice: the same bits, the determinism gate of phases 9, 14,
     16 and 17) and a 30-iteration Jacobi-PCG;
 11. the double-single kernels vs their plain versions, both planes bit for
     bit: dia_ds_spmv on the 3200^2 Laplacian and a random banded D=3 stack,
     well_ds_spmv on the 4M bench matrix (tile_groups 64), a pair=True and
     a tile_groups 8 packing of 200k rows and a D=3 stack; on
     values x (1 + 1e-9 N(0,1)) each also vs the host f64 CSR (<= 1e-13),
     and the fp32 kernel on the same input must miss that by 100x or more
     (the lo planes are read);
 12. the float64 main path (demo_cg's default: float64, --format auto)
     through the transparent float64 matvec: (a) the 3200^2 Laplacian, auto
     must pick dia_ds, CG to 1e-6 (every apply a dia_ds launch, the host
     residual within 1e-8 of the reported, iterations within 1% and the
     solution within 1e-8 of a native-f64 vanilla dia solve); (b) the
     RCM'd 800k FEM, symmetric, auto must pick well_ds, its L and L^T
     stacks' kernel bit for bit against plain and against the block
     kernel's column at nrhs 1, Jacobi-PCG (2
     well_ds launches per apply, A x at the solution within 1e-12 of
     || |A| |x| ||, iterations within 2% and the solution within 1e-8 of
     phase 8's native-f64 solve);
 13. mixed-precision refinement: cg_refined_dist(dia) at 1024^2 to rtol
     1e-12 (8 outer passes at most, inner rtol 1e-6, inner kmax 20000): the
     true float64 residual <= 1e-8 and 100x below a plain fp32 CG's; then,
     printed, cg_refined at 1024^2;
 14. the DS halo path on D=4 stacked shards: one matvec_ds vs the host
     oracle (<= 1e-13; applied twice, the same bits) for the 512^2
     Laplacian (dia_ds) and the RCM'd 50k FEM (well_ds, vanilla and
     symmetric); a Jacobi cg_refined_dist(well) on that FEM, printed;
 15. the five block (SpMM) kernels vs their plain versions on the card
     (fp32/fp64 within TOL_KERNEL, double-single both planes bit for bit),
     every column bit-equal to the single-RHS kernel on that column:
     dia_spmm and dia_sym_spmm at 3200^2 fp32, fp64 and bf16 (<= 8e-3) and
     dia_ds_spmm at 3200^2, nrhs 1, 3, 8 and 11 (11 = a chunk of 8 columns
     and one of 3), and on a random banded D=3 stack (the DIA kernels at
     nrhs 1, 3, 8 and 11), each apply twice with the same bits and each
     dia_spmm apply with its window plan; well_spmm and well_ds_spmm, which
     read the stacks' row lists as the single-RHS WELL kernels do, on the
     4M bench matrix, a paired and an int32-pos packing of 200k rows and a
     D=3 stack, nrhs 1, 8 and 11;
 16. the block path at full size, nrhs 8; before each solve, its block
     kernels vs their plain versions on its own operators' stacks (as in
     phase 15: the fp32 and DS stacks block_cg_refined_dist builds, the
     float64 symmetric packing of block_cg_dia), then, counters zeroed just
     before each solve: block_cg_refined_dist(dia) at 512^2 (inner rtol 1e-4, inner
     kmax 1500; every column's true float64 residual <= 1e-11) and at
     1024^2 (inner kmax 4000, max_outer 10; <= 1e-8), and
     block_cg_refined_dist(well) on circuit_network(800) (640k nodes,
     RCM'd, a far remainder; <= 1e-9), each inner iteration exactly one
     dia_spmm / well_spmm launch plus one per pass, each residual one
     dia_ds_spmm / well_ds_spmm launch, no single-RHS launch; on the
     circuit's fp32 operator (58196 far entries) three matvec and three
     matmat applies give the same bits, its WELL slots, row-list entries
     and device bytes are printed, and the circuit solve runs twice: the
     same outer and inner counts and the same bits; then block_cg_dia on
     symmetric float64 storage at 1024^2 (rtol 1e-10, every column <=
     1e-9, one dia_sym_spmm launch per block apply);
 17. the block halo on D=4 stacked shards, nrhs 3: matmat per column vs the
     host oracle, each apply twice with the same bits (512^2 Laplacian:
     dia vanilla and symmetric, ell
     symmetric; RCM'd 50k FEM: well vanilla and symmetric; fp32 and fp64)
     and matmat_ds (dia_ds, well_ds; <= 1e-13), and a 20-iteration block_cg
     on the fp64 dia operator (host residuals within 1e-9 of the reported);
 18. AMG-preconditioned CG (the reference bench's headline solver,
     bench.py:197-231): (a) on phase 4's 3200^2 CSR, the fp32 vanilla dia
     operator, amg_setup(interval2d, 4x4 blocks, W-cycle, dia levels), PCG
     to 1e-6 three times: at most 16 iterations, each solve's dia_spmv
     launches exactly (k+1)(1 + the cycle's applies) and no other kernel,
     every level's kernel vs its plain version; the levels, setup seconds
     and their split, the median solve beside phase 4's plain fp32 CG, the
     true f64 residual and the fp32 floor estimate printed; (b) 1024^2
     symmetric storage (dia_sym_spmv on level 0) beside vanilla, counts
     within 1, exact launches; (c) cg_refined_dist(amg=...) at 1024^2 to
     rtol 1e-9, true residual < 1e-8; (d) D=4: interval2d at 512^2 within
     1 of D=1, the default smoothed aggregation on the RCM'd 50k FEM
     (rectangular ELL transfers, hub-split coarse operators) converged
     beside Jacobi-PCG, a cycle apply twice with the same bits on both;
     (e) block_cg_refined_dist(inner_solver="chebyshev") at 512^2 x 8,
     every column < 1e-9, exact dia_spmm / dia_ds_spmm / Lanczos launches;
     (f, with phase 10) device ms of dia_spmv on AMG levels 1 and 2 with
     cuSPARSE and the bound, the bf16 DIA kernels at 3200^2 (bit for bit
     against their plain versions; the yardstick a bf16 torch CSR @ x, or
     torch's refusal), and dia_spmv, dia_spmm (nrhs 8) and dia_sym_spmv (the
     band's lower half) at K=65 and K=297 in fp32, fp64 and bf16, each
     first vs its plain version and applied twice with the same bits;
 19. the general Krylov path and the transpose operator: (a) matvec_transpose
     and transposed().matvec on non-symmetric operators (the upwind
     convection-diffusion of the reference's SPAI tests, built here) vs
     the host float64 A^T x (<= 1e-5 fp32, 1e-12 fp64 of || |A^T| |x| ||
     inf): NX^2 DIA D=1 fp32/fp64 (the two forms the same bits), 512^2
     DIA and ELL D=4, the RCM'd 50k FEM (row-scaled) WELL D=4, a row-scaled
     power-law Laplacian with hub rows ELL D=4; each apply twice (same
     bits) with every scatter-add refused, exact launches, the transpose's
     kernels vs plain; (b) AMG-preconditioned GMRES(30), FGMRES(30),
     BiCGStab and MINRES (symmetric DIA) at NX^2 with 18a's hierarchy,
     fp32, rtol 1e-6, b = A x*, beside AMG-PCG: converged, exact launches
     (78 dia_spmv a preconditioner apply), a second solve the same bits,
     the float64 host residual within 0.5 rtol of the reported one (MINRES
     in the preconditioner's norm); (c) FSAI-PCG on phase 8's 800k FEM (G
     and G^T vanilla WELL, their stacks vs plain): fewer iterations than
     phase 8's Jacobi-PCG, 4 WELL launches an iteration; (d) SPAI-GMRES
     and SPAI-BiCGStab (restarted after a breakdown) at 1600^2 beside
     Jacobi, M's DIA stack vs plain, the SPAI runs converged; (e) LSQR, 200
     iterations at NX^2 (rnorm history within 1e-4 of the plain versions'
     run), cg_pipelined on the symmetric NX^2 Laplacian beside cg; (f) the
     demos as subprocesses, all at once, started before (a) and joined
     after it, before (b)'s timed solves: demo_cg --amg --solver gmres at
     NX^2, --petsc/--rhs --solver bicgstab on PETSc files of the port's
     writers, --mtx --fsai on a Matrix Market FEM of the port's writer,
     demo_restrict --n 4194304 --devices 4, each exit 0 and its printed
     residual read back against the same solve in this process;
 20. the communication-avoiding solvers: (a) the matrix-powers basis at
     NX^2 float64, vanilla DIA on 4 stacked shards, s = 4: the depth-4
     plan (its host seconds, its ghost growth), the window's dia_spmv vs
     its plain version, then chebyshev_powers_basis vs the 4-matvec basis
     (<= 1e-12 relative), exactly 1 halo gather and 4 dia_spmv launches,
     the same bits twice; (b) cg_sstep(s=4) at NX^2 float64, rtol 1e-6, on
     phase 4's symmetric operator (D = 1) and through the MPK (D = 4):
     converged, the host residual within 1e-8 ||b|| of the reported, one
     host sync a block, exact launches (and one halo gather a block with
     the MPK), the same bits on a second solve, beside phase 4's CG; (c)
     gmres_sstep(s=4, restart=32) on A o M with 18a's AMG W-cycle (float32,
     b = A x*, gated as 19b, beside 19b's GMRES), then a 48-step Arnoldi
     Ritz harvest on the 1024^2 convection-diffusion (float64, D = 4) and
     gmres_sstep with the Newton basis through the MPK beside the s-apply
     Newton basis (10 cycles: the same steps, residuals within 1e-6); (d)
     LOBPCG and deflated CG at 1024^2 float32 on symmetric DIA as
     demo_cg --deflated 4 sets them up (dia_sym_spmm vs plain at nrhs 4
     first; exact launches; the Ritz values inside the spectrum; both
     converged; the iterations beside CG's); (e) three demos as
     subprocesses beside (c), (d) and (f): demo_cg --sstep 4 --mpk --devices 4,
     --sstep 4 --solver gmres --newton 16 --mpk on 19f's PETSc files, and
     --deflated 4, each read back against the same solve in this process;
     (f) cg_pipelined in float64 on phase 4's symmetric operator beside CG;
 21. the spectral toolbox and demo_spmv (after 20): (a) demo_spmv as five
     subprocesses one after another (--dia, --dia --symmetric --fp32 and
     --format auto at NX^2; --format well --fp32 and --format well_ds at
     1024^2, where the WELL assembly stays inside the phase's time), each
     exit 0 and its norm(y) against the same chain run here through the
     plain versions (1e-12 fp64 and DS, 1e-5 fp32), this process's
     warm-up and 100 chained applies exactly 101 launches of the kernel;
     meanwhile this process builds its operators and writes 21g's
     checkpoints; (b) expm_multiply (t = -1, m = 48) on phase 4's
     symmetric float64 operator against the exact Kronecker propagator
     (<= 1e-10), the plain version within 1e-13, 48 dia_sym_spmv launches;
     (c) demo_eig --logdet 32 --probes 16 at NX^2: 513 dia_spmv launches,
     the same probes through the plain version within 1e-12, the distance
     to the exact log det printed; (d) demo_eig --svd 48 -k 4 at 1024²:
     98 dia_spmv launches, every sigma under the closed form, every
     certificate equal to the host residual; (e) demo_eig -k 4 --cheb 16
     --maxiter 100 at 1024² and 48² (float64 dia_spmm at nrhs 4, first
     against its plain version): exact launches, Ritz values above the
     closed form, converged at 48², and dia_spmm's timing row there; (f)
     demo_eig --convdiff 1024 --arnoldi 60 (ELL): Ritz values inside the
     field-of-values bound; (g) checkpoints (NX^2 DIA, a 50k FEM WELL) load
     with the same bits, a Jacobi-PCG resumed from saved state converges,
     from_scipy -> build_dist_matrix -> matvec against scipy;
 10. (run last) ms per apply of every ported kernel, kernel and plain in
     turns, with the library yardstick (one torch CSR @ x call, cuSPARSE,
     float64 for the DS kernels; the port never calls it) and the bytes
     bound at 3.35 TB/s (the H100 SXM's published HBM rate): the DIA
     kernels and dia_ds_spmv at 3200^2 (fp32; fp64 beside it for dia_spmv,
     dia_sym_spmv and dia_spmm), spmv_well and well_ds_spmv on the
     4M bench matrix and on the 800k FEM's lower-triangle stack (with the
     row lists' occupancy and stored bytes beside the WELL stack's); the block
     kernels at nrhs 8 (DIA and DS DIA at 3200^2, WELL and DS WELL on the
     4M matrix; the yardstick the faster of one torch CSR @ X on a
     row-major and on a column-major (n, 8) block) beside 8 x the
     single-RHS kernel's ms from this run, and each block kernel at nrhs 1
     beside its single-RHS kernel, in turns; dia_sym_spmm also where the
     main path runs it (float64 at 1024^2, nrhs 8, phase 16d) and the two
     WELL block kernels on the local stacks of phase 16c's circuit
     operators at nrhs 8, by device time from torch.profiler (kernel,
     plain and cuSPARSE), the chained time beside it. Every DIA apply that
     prints a check prints its route (``spmv_dia_cuda.route``) and, where
     that is the tile kernel, its window plan.
The last two lines are the kernels JSON and {"ok": true, "device": ...}.

    python3 chip_smoke.py --parent DIR

runs one phase instead: the four DIA kernels (dia_spmv, dia_sym_spmv,
dia_spmm, dia_sym_spmm) against those of the tree before them, a checkout
in DIR (for example `git archive` of that commit unpacked under build/),
in turns on the main path's shapes (``phase_parent``).
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import importlib.util
import json
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

from spmv_torch import _build
from spmv_torch.corpus import circuit_network, fem_p1_2d, powerlaw_laplacian
from spmv_torch.formats.csr import CSRHost
from spmv_torch.formats.dia import csr_to_dia, interleaved_to_flat
from spmv_torch.ds import ds_from_f64, ds_to_f64
from spmv_torch.formats.well import csr_to_well, csr_to_well_sym, pack_rows, split_window
from spmv_torch.gen import create_laplace_2d, gaussian_bump
from spmv_torch.io.matrix_market import read_matrix_market, write_matrix_market
from spmv_torch.io.petsc import (
    read_petsc_binary_matrix_host,
    read_petsc_binary_vector_host,
    write_petsc_binary_matrix,
    write_petsc_binary_vector,
)
from spmv_torch.ops import (
    cg_update_cuda,
    spmm_dia_cuda,
    spmm_well_cuda,
    spmv_dia_cuda,
    spmv_dia_ds_cuda,
    spmv_well_cuda,
    spmv_well_ds_cuda,
)
from spmv_torch.ops.spmm_dia import columns, spmm_dia_stacked_plain
from spmv_torch.ops.spmm_well import (
    spmm_well_ds_stacked_plain,
    spmm_well_stacked_plain,
)
from spmv_torch.ops.spmv_dia import spmv_dia_stacked_plain
from spmv_torch.ops.spmv_dia_ds import (
    csr_to_dia_ds,
    spmm_dia_ds_stacked_plain,
    spmv_dia_ds_stacked_plain,
)
from spmv_torch.ops.spmv_well import (
    spmv_well_rows_plain,
    spmv_well_stacked_plain,
    spmv_well_sym,
)
from spmv_torch.ops.spmv_well_ds import (
    csr_to_well_ds,
    spmv_well_ds_rows_plain,
    spmv_well_ds_stacked_plain,
)
import spmv_torch.parallel.dist_matrix as dist_matrix_mod
import spmv_torch.parallel.powers as powers_mod
import spmv_torch.solvers.cg_sstep as cg_sstep_mod
import spmv_torch.solvers.gmres_sstep as gmres_sstep_mod
from spmv_torch.parallel.dist_matrix import HOST_FIELDS, WELL_WSEG_CAP, build_dist_matrix
from spmv_torch.parallel.powers import (
    build_powers_plan,
    chebyshev_powers_basis,
    newton_powers_basis,
    powers_ghost_stats,
)
from spmv_torch.reorder import rcm_reorder
from spmv_torch.solvers.amg import amg_setup
from spmv_torch.solvers.bicgstab import bicgstab
from spmv_torch.solvers.block_cg import block_cg, block_cg_dia, block_cg_refined_dist
from spmv_torch.solvers.arnoldi import arnoldi_ritz
from spmv_torch.solvers import cg as cg_module
from spmv_torch.solvers.cg import cg, cg_pipelined
from spmv_torch.solvers.cg_sstep import cg_sstep, chebyshev_basis
from spmv_torch.solvers.deflation import cg_deflated
from spmv_torch.solvers.fsai import fsai_preconditioner
from spmv_torch.solvers.gmres import gmres
from spmv_torch.solvers.gmres_sstep import gmres_sstep
from spmv_torch.solvers.lsqr import lsqr
from spmv_torch.solvers.minres import minres
from spmv_torch.solvers.newton_basis import (
    modified_leja,
    newton_basis_ops,
    newton_shifts_from_operator,
)
from spmv_torch.solvers.refine import cg_refined, cg_refined_dist
from spmv_torch.solvers.spai import spai_preconditioner
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
DS_ORACLE_TOL = 1e-13  # a DS apply vs the host float64 CSR (relative L2)
DS_CONTROL_MISS = 100  # the fp32 kernel on the same input misses by this x
FEM_DS_ITER_TOL = 0.02  # DS vs native f64 FEM Jacobi-PCG iterations
REFINE_NX = 1024     # the reference's refinement record size (BENCH_NOTES.md)
REFINE_TOL = 1e-8    # refined true relative residual at REFINE_NX^2
NRHS_KERNEL = (1, 3, 8, 11)  # phase 15; 11 = a chunk of 8 columns and one of 3
NRHS_WELL = (1, 8, 11)
NRHS = 8             # the block path's width (BENCH_NOTES.md:451-455)
BLOCK_NX = 512       # 16a: the reference's refined block sample (262k rows)
CIRCUIT_BLOCK_NX = 800  # 16c: circuit_network(800), 640k nodes (corpus size)
# phase 16's per-column true residual gates: (a) the reference's sample
# reached 0.8-1.8e-13 on the TPU; (b) REFINE_TOL, the single-RHS gate at
# this size; (c) kappa ~ 1e5 with a far remainder
BLOCK_TOL = {"a": 1e-11, "b": REFINE_TOL, "c": 1e-9}
# phase 18: the reference bench's AMG configuration (bench.py:197-231)
AMG_KW = dict(aggregate="interval2d", interval_size=4, cycle=2, local_format="dia")
AMG_ITERS_GATE = 16  # tests/test_amg.py:439-440
AMG_SYM_NX = 1024    # 18b, 18c (REFINE_NX, the refinement gate's size)
AMG_D4_NX = 512      # 18d
CHEB_NX = 512        # 18e
CHEB_TOL = 1e-9      # the reference's gate for the Chebyshev inner solver
BF16_TOL = 8e-3      # bf16 kernel vs plain: one bf16 rounding (2^-8) moved
#                      by the contraction of the fp32 sums, relative L2
# phase 19: the general Krylov path and the transpose operator
TRANSPOSE_TOL = {"float32": 1e-5, "float64": 1e-12}  # |y - A^T x|_inf / || |A^T||x| ||_inf
HUB_N = 50_000       # 19a: powerlaw_laplacian nodes (its hub rows split out)
KRYLOV_RTOL = 1e-6   # 19b-19d
KRYLOV_RESIDUAL_GATE = 0.5  # x rtol: the float64 host residual vs the reported
#                      one (one float32 residual evaluation rounds at ~1e-7 of
#                      ||b||, so a gate of 1e-8 ||b|| cannot hold in float32)
AMG_KRYLOV_KMAX = 200  # 19b (18a's kmax)
GMRES_RESTART = 30
SPAI_NX = 1600       # 19d: spai_setup's numpy at 3200^2 takes over 60 s (PERF.md)
SPAI_KMAX = 20000
LSQR_ITERS = 200     # 19e
LSQR_TOL = 1e-4      # kernel vs plain rnorm histories, relative
DEMO_NX = 1024       # 19f: the PETSc demo's convection-diffusion grid
DEMO_RTOL, DEMO_KMAX = 1e-8, 6000
DEMO_RESTRICT_N = 4_194_304
DEMO_AMG_TOL = 0.25  # the AMG demo's r.norm vs this process's (ELL vs DIA
#                      levels; both at the float32 floor of the bump's solve)
DEMO_TIMEOUT = 420   # seconds, all four demos together
# profiler sessions of a plain version's or a library call's device time in
# phase 10 (a kernel's takes the median of three): one, with 18f's K > 64
# plain versions timed over one step, keeps the run inside its 1200 s
# (on the H100 80GB HBM3 at 700 W, phase 10 took 257 s with three sessions
# and 82 s with one)
YARDSTICK_SESSIONS = 1
# phase 20: the communication-avoiding solvers
SSTEP_S = 4
SSTEP_KMAX, SSTEP_RTOL = 20000, 1e-6
SSTEP_RESIDUAL_GATE = 1e-8  # x ||b||: float64 host residual vs the reported
MPK_DEVICES = 4
MPK_TOL = 1e-12      # 20a: MPK basis vs the s-matvec basis, relative L2
MPK_INTERVAL = 8.8   # 20a: the basis interval [0, 1.1 * 8] of the Laplacian
NEWTON_NX = 1024     # 20c: the convection-diffusion grid of the Newton basis
NEWTON_M = 48        # 20c: Arnoldi steps of the Ritz harvest
NEWTON_CYCLES = 10   # 20c: restart cycles of 32 steps (unpreconditioned)
NEWTON_TOL = 1e-6    # 20c: MPK vs s-apply Newton basis, final rnorm relative
DEFLATED_D = 4       # 20d: the deflation basis (demo_cg --deflated 4)
RITZ_TOL = 1e-6      # 20d: float32 Rayleigh quotients of a norm-8 operator
SSTEP_DEMO_NX = 1024  # 20d, 20e
DEMO_NEWTON_M = 16   # 20e: demo_cg --newton 16
DEMO_SSTEP_TOL = {"sstep_mpk": (0, 1e-6), "newton_mpk": (0, 1e-6),  # 20e: the demo's
                  "deflated": (2, 0.05)}  # iterations and r.norm vs this process's
#                      (float32 LOBPCG at tol 1e-3 carries any rounding into W)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAIL: {msg}")


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def show(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def reset_counters() -> None:
    _build.launches.clear()


def launched(*keys) -> dict:
    """The kernel launches under ``keys`` since the last ``reset_counters``."""
    return {k: _build.launches[k] for k in keys}


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


def plan_fields(data, offsets, symmetric: bool, nrhs: int, block: bool = None) -> dict:
    """The route of a DIA apply on ``data`` (``spmv_dia_cuda.route``; a
    block apply where ``block``, by default where nrhs > 1) and, where it
    runs the tile kernel, its window plan, as printed beside its checks."""
    offsets = tuple(offsets)
    block = nrhs > 1 if block is None else block
    r = spmv_dia_cuda.route(offsets, symmetric, block, data.dtype)
    out = {"route": dataclasses.asdict(r)}
    if r.kernel == "tile":
        out["window_plan"] = spmv_dia_cuda.window_plan(offsets, symmetric, nrhs,
                                                       data.dtype).summary()
    return out


def compare(name, data, x2, offsets, symmetric, tol):
    """One kernel launch vs the plain version on the same inputs (bf16
    compared in float32), and a second launch with the same bits."""
    y_k = spmv_dia_cuda.spmv_dia_stacked(data, x2, offsets, symmetric)
    torch.cuda.synchronize()
    if not torch.equal(spmv_dia_cuda.spmv_dia_stacked(data, x2, offsets, symmetric), y_k):
        fail(f"{name}: a second apply gave other bits")
    y_p = spmv_dia_stacked_plain(data, x2, offsets, symmetric)
    if data.dtype == torch.bfloat16:
        return (*check_close(name, y_k.float(), y_p.float(), tol), torch.equal(y_k, y_p))
    return (*check_close(name, y_k, y_p, tol), None)


def phase_kernels(a, dev):
    """Phase 3. Returns {kernel name: largest abs kernel-vs-plain
    difference over all of its comparisons}."""
    rng = np.random.default_rng(0)
    max_abs = {"dia_spmv": 0.0, "dia_sym_spmv": 0.0}
    tols = {**TOL_KERNEL, "bfloat16": BF16_TOL}
    for dt in (torch.float32, torch.float64, torch.bfloat16):
        dname = str(dt).split(".")[1]
        for sym in (False, True):
            kname = "dia_sym_spmv" if sym else "dia_spmv"
            d = csr_to_dia(a, row_align=ROW_ALIGN, dtype=dt, symmetric=sym,
                           device=dev)
            x = torch.zeros(d.nrows_pad, dtype=torch.float64)
            x[: a.nrows] = torch.as_tensor(rng.standard_normal(a.nrows))
            x2 = x.to(dt).to(dev).view(-1, 128)
            y, err, mabs, bits = compare(f"{kname} {dname} lap{NX}", d.data.unsqueeze(0),
                                         x2, d.offsets, sym, tols[dname])
            fields = dict(kernel=kname, dtype=dname, matrix=f"laplace2d {NX}^2",
                          rel_l2_vs_plain=err, max_abs_vs_plain=mabs,
                          second_apply_same_bits=True,
                          **plan_fields(d.data, d.offsets, sym, 1))
            if dt == torch.bfloat16:
                # the Laplacian's values and bf16 x make every product exact
                # in fp32: kernel and plain round the same sums once
                if not bits:
                    fail(f"{kname} bf16 lap{NX}: not bit for bit the plain version")
                fields["bit_equal_to_plain"] = True
            max_abs[kname] = max(max_abs[kname], mabs)
            if dt == torch.float32:
                xh = x.numpy()[: a.nrows].astype(np.float32).astype(np.float64)
                oerr = rel_l2(y.ravel()[: a.nrows], a.matvec(xh))
                if oerr > TOL_ORACLE[dname]:
                    fail(f"{kname} fp32 vs host CSR oracle {oerr:.3e}")
                fields["rel_l2_vs_host_csr"] = oerr
            show("3.kernel", **fields)
            del d, x2

    # random banded, odd offsets, D=3 stacked shards: a kernel that read
    # past its shard's rows would pick up the neighbour's nonzero x
    nd, nr = 3, 1000
    full = (-301, -37, -5, -1, 0, 1, 5, 37, 301)
    for dt in (torch.float32, torch.float64, torch.bfloat16):
        dname = str(dt).split(".")[1]
        for sym in (False, True):
            offs = tuple(o for o in full if o <= 0) if sym else full
            kname = "dia_sym_spmv" if sym else "dia_spmv"
            data = torch.as_tensor(rng.standard_normal((nd, nr, len(offs) * 128)),
                                   device=dev).to(dt)
            x2 = torch.as_tensor(rng.standard_normal((nd * nr, 128)), device=dev).to(dt)
            _, err, mabs, _ = compare(f"{kname} {dname} banded D={nd}", data, x2,
                                      offs, sym, tols[dname])
            max_abs[kname] = max(max_abs[kname], mabs)
            show("3.kernel", kernel=kname, dtype=dname,
                 matrix=f"random banded offsets {list(offs)}, D={nd}",
                 rel_l2_vs_plain=err, max_abs_vs_plain=mabs,
                 second_apply_same_bits=True, **plan_fields(data, offs, sym, 1))
    return max_abs


def phase_main_path(a, dev):
    """Phase 4: the main path through the port's entry points. Returns the
    launch counts, iterations/s, {run: (iterations, solve seconds)} and the
    symmetric float64 operator (phase 20's)."""
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
        before = _build.launches[key]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cg(A.as_linear_operator(), b, kmax=20000, rtol=1e-6)
        torch.cuda.synchronize()
        t_solve = time.perf_counter() - t0
        grown = _build.launches[key] - before
        results.append((dt, sym, A, res, b_host, t_asm, t_solve, grown))
    counts = launched("dia", "dia_sym")

    its_per_s, solves = {}, {}
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
        solves[tag] = (res.iterations, t_solve)
        show("4.main_path", **fields)
    for key in ("dia", "dia_sym"):
        if counts[key] == 0:
            fail(f"main path launched no {key} kernel")
    show("4.main_path", launches=counts)
    phase_plain_witness(a, runs[1], results[1][3])
    return counts, its_per_s, solves, runs[0][2]


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
    """Phase 6: ms per apply at 3200^2, fp32 and fp64, kernel and plain in
    turns (plain, kernel, kernel, plain; CUDA events over chained applies),
    against a same-run device copy; beside each, the kernel's device time
    from torch.profiler (a chained loop of a kernel not much longer than
    its wrapper's host time times the host). Returns {kernel: (ms, plain
    ms, bytes)} for fp32 and {"<kernel> float64": ...} for fp64."""
    copy_gbs = measure_copy_bandwidth_gbs(dev)
    out = {}
    for dt in (np.float32, np.float64):
        dname = np.dtype(dt).name
        for sym in (False, True):
            kname = "dia_sym_spmv" if sym else "dia_spmv"
            d = csr_to_dia(a, row_align=ROW_ALIGN, dtype=dt, symmetric=sym, device=dev)
            # ||A/9||_inf < 1: chained applies stay bounded (bench.py:363-367)
            d.data.mul_(1.0 / 9.0)
            x = np.zeros(d.nrows_pad, dt)
            x[: a.nrows] = gaussian_bump(a.nrows, dtype=dt)
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
            nbytes = (d.ndiags + 2) * d.nrows_pad * x.itemsize  # stored data + x + y
            frac_k = nbytes / (ms_k / 1e3) / 1e9 / copy_gbs
            frac_p = nbytes / (ms_p / 1e3) / 1e9 / copy_gbs
            out[kname if dt == np.float32 else f"{kname} {dname}"] = (ms_k, ms_p, nbytes)
            show("6.timing", kernel=kname, dtype=dname, rows=a.nrows,
                 ndiags=d.ndiags, bytes_per_apply=nbytes, ms=ms_k, plain_ms=ms_p,
                 device_ms=device_ms(kernel, x2),
                 ms_runs=[1e3 * t_k1, 1e3 * t_k2],
                 plain_ms_runs=[1e3 * t_p1, 1e3 * t_p2], copy_gbs=copy_gbs,
                 copy_fraction=frac_k, plain_copy_fraction=frac_p,
                 **plan_fields(d.data, d.offsets, sym, 1))
            del d, data3, x2
    return out


CG_UPDATE_TOL = {"float32": 1e-5, "float64": 1e-12}  # fused vs torch loop, relative
CG_UPDATE_ITERS = 100  # the benchmark's solves (kmax 100)


def phase_cg_update(a, dev) -> dict:
    """Phase 22: the fused CG loop's three kernels (csrc/cg_update.cu) on
    the NX^2 symmetric DIA operator, float64 and float32. (a) A
    100-iteration solve through ``cg`` (the fused loop): 3 kernel launches
    an iteration, a second solve the same bits, the torch loop's solve
    (``_cg_plain``) the same iterations and within CG_UPDATE_TOL (relative)
    in x and |r|. (b) From that solve's state, one iteration's kernels
    against their plain versions: alpha, beta and rho within CG_UPDATE_TOL,
    the vectors within 4 eps of the plain arithmetic on the kernels'
    scalars, the flag equal. (c) Device us an iteration, the apply left
    out (``device_ms``, the marker count of profiled CG iterations): the
    three kernels, and the torch loop's vector work (its adds, multiplies,
    cuBLAS dots and 0-d scalar kernels), beside the 10-pass bound. Returns
    {dtype: row}."""
    def rel_t(got, want):
        return float((got.double() - want.double()).norm() / want.double().norm())

    out = {}
    for dt in (np.float64, np.float32):
        dname = np.dtype(dt).name
        tol = CG_UPDATE_TOL[dname]
        A = build_dist_matrix(a, n_devices=1, symmetric=True, dtype=dt,
                              local_format="dia", device=dev)
        b = A.to_dist(np.random.default_rng(22).uniform(-1.0, 1.0, a.nrows).astype(dt))
        reset_counters()
        res = cg(A.matvec, b, kmax=CG_UPDATE_ITERS, rtol=0.0)
        launches = launched("cg_pap", "cg_update_r", "cg_update_xp")
        again = cg(A.matvec, b, kmax=CG_UPDATE_ITERS, rtol=0.0)
        plain = cg_module._cg_plain(A.matvec, b, None, CG_UPDATE_ITERS, 0.0, None, None)
        torch.cuda.synchronize()
        k = res.iterations
        if launches != {"cg_pap": k, "cg_update_r": k, "cg_update_xp": k}:
            fail(f"22 {dname}: launches {launches} for {k} iterations")
        if not (torch.equal(res.x, again.x) and torch.equal(res.rnorm, again.rnorm)):
            fail(f"22 {dname}: a second fused solve gave other bits")
        dx = rel_t(res.x, plain.x)
        dr = abs(float(res.rnorm) - float(plain.rnorm)) / float(plain.rnorm)
        if plain.iterations != k or dx > tol or dr > tol:
            fail(f"22 {dname}: fused {k} iterations vs torch loop {plain.iterations}, "
                 f"x {dx:.3e}, |r| {dr:.3e} (tolerance {tol:g})")

        # (b) one iteration's kernels vs their plain versions
        ap = A.matvec(res.p)
        rho = cg_module._dot(res.r, res.r)
        kern = [t.clone() for t in (res.x, res.p, res.r)]
        flat = [t.clone() for t in (res.x, res.p, res.r)]
        ws_k, ws_p = (cg_update_cuda.workspace(rho, res.rnorm0) for _ in range(2))
        cg_update_cuda.cg_pap(kern[1], ap, ws_k)
        cg_update_cuda.cg_update_r(kern[2], ap, ws_k, 1e-3)
        cg_update_cuda.cg_update_xp(*kern, ws_k)
        cg_update_cuda.cg_pap_plain(flat[1], ap, ws_p)
        cg_update_cuda.cg_update_r_plain(flat[2], ap, ws_p, 1e-3)
        sk, sp = ws_k.scalars.double(), ws_p.scalars.double()
        scalar_err = max(abs(float(sk[i] - sp[i])) / abs(float(sp[i]))
                         for i in (cg_update_cuda.ALPHA, cg_update_cuda.BETA,
                                   cg_update_cuda.RHO))
        alpha = ws_k.scalars[cg_update_cuda.ALPHA]
        beta = ws_k.scalars[cg_update_cuda.BETA]
        vec_err = max(rel_t(kern[2], res.r - alpha * ap),
                      rel_t(kern[0], res.x + alpha * res.p),
                      rel_t(kern[1], kern[2] + beta * res.p))
        if (scalar_err > tol or vec_err > 4 * np.finfo(dt).eps
                or float(sk[cg_update_cuda.FLAG]) != float(sp[cg_update_cuda.FLAG])):
            fail(f"22 {dname}: kernels vs plain: scalars {scalar_err:.3e}, "
                 f"vectors {vec_err:.3e}")

        # (c) device us an iteration, CG continued from the solve's state
        x, p, r = kern
        ws = cg_update_cuda.workspace(cg_module._dot(r, r), res.rnorm0)

        def fused_step(v):
            q = A.matvec(p)
            cg_update_cuda.cg_pap(p, q, ws)
            cg_update_cuda.cg_update_r(r, q, ws, 0.0)
            cg_update_cuda.cg_update_xp(x, p, r, ws)
            return v

        st = {"x": flat[0].clone(), "r": flat[2].clone(), "p": flat[1].clone()}
        st["rho"] = cg_module._dot(st["r"], st["r"])

        def plain_step(v):  # solvers/cg.py's torch loop, unpreconditioned
            q = A.matvec(st["p"])
            alpha = st["rho"] / cg_module._dot(st["p"], q)
            st["x"] = st["x"] + alpha * st["p"]
            st["r"] = st["r"] - alpha * q
            rho_new = cg_module._dot(st["r"], st["r"])
            beta = rho_new / st["rho"]
            st["p"] = st["r"] + beta * st["p"]
            st["rho"] = rho_new
            st["more"] = cg_module._rel(rho_new, res.rnorm0, np.finfo(dt).tiny) >= 0.0
            return v

        apply_name = "dia_sym_spmv"
        fused_us = 1e3 * device_ms(fused_step, b, skip=apply_name)
        plain_us = 1e3 * device_ms(plain_step, b, sessions=YARDSTICK_SESSIONS,
                                   skip=apply_name)
        nbytes = b.numel() * b.element_size()
        row = dict(dtype=dname, rows=a.nrows, iterations=k, launches=launches,
                   rel_x_vs_torch_loop=dx, rel_rnorm_vs_torch_loop=dr,
                   kernels_vs_plain_scalars=scalar_err, kernels_vs_plain_vectors=vec_err,
                   fused_us=fused_us, plain_us=plain_us,
                   bound_us=10 * nbytes / (HBM_TBS * 1e12) * 1e6,
                   plain_bound_us=19 * nbytes / (HBM_TBS * 1e12) * 1e6)
        show("22.cg_update", **row)
        out[dname] = row
        del A, b, res, again, plain, ap, kern, flat, st, ws, ws_k, ws_p
    return out


SYMGS_GRIDS = [(256, 256, 256), (128, 128, 128), (64, 64, 64), (32, 32, 32)]
SYMGS_LONG = (640, 64, 32)  # lines longer than a block's point pairs
SYMGS_ITERS = 20  # chained calls a profiler session


def phase_symgs(dev, grids=SYMGS_GRIDS, long_grid=SYMGS_LONG) -> list:
    """Phase 23: the multigrid's two kernels (csrc/symgs_dia.cu) on HPCG's
    27-point operator at each level of hpcg_256.mgpcg (256^3 down to 32^3)
    and on a grid whose lines take 3 segments, float64 and float32 (the
    same DIA block, cast). (a) Each sweep kind of a V-cycle level in turn,
    forward from zero, backward keeping w, a prolongation's change at the
    coarse points, forward from w, backward from w, then the restricted
    residual: every x, w and rc bit for bit against the plain versions
    (``ops/symgs_dia.py``) given the same inputs, and the launches,
    counted from a reset just before: 2 a sweep direction, one a z parity
    (``sweep_launches``), 1 a restriction, all on the level's grid, and
    the bands a plane of each sweep launch (``sweep_bands``). (b) Device ms of each kind and of its plain version
    (``device_ms``) beside its least-bytes bound: 8 (L + 2 n) from zero,
    8 (L + 3 n) otherwise, 8 (coarse rows' nonzeros + n + 2 nc) for the
    restriction (L stored values, n rows, nc coarse points; 4 bytes each
    in float32). Returns the rows."""
    from spmv_torch.gen import hpcg_27pt
    from spmv_torch.ops import symgs_dia, symgs_dia_cuda

    rows = []
    for grid in (*grids, long_grid):
        a = hpcg_27pt(*grid)
        n = a.nrows
        stored = (a.nnz + n) // 2  # the lower triangle and the diagonal
        f = symgs_dia.coarse_rows(grid, "cpu").numpy()
        nc = f.size
        coarse_nnz = int(np.diff(a.rowptr)[f].sum())
        A = build_dist_matrix(a, n_devices=1, symmetric=True, dtype=np.float64,
                              local_format="dia", device=dev)
        del a
        offs = A.dia_offsets
        for dt in (torch.float64, torch.float32):
            dname = str(dt).split(".")[1]
            data = A.local_dia_data[0].to(dt).contiguous()
            item = data.element_size()
            gen = torch.Generator(device=dev).manual_seed(23)
            b = torch.rand(n, generator=gen, device=dev, dtype=dt) * 2 - 1
            state = {"kernel": [torch.zeros_like(b), torch.zeros_like(b)],
                     "plain": [torch.zeros_like(b), torch.zeros_like(b)]}
            kinds = (("forward from zero", True, False, True),
                     ("backward keeping w", False, False, True),
                     ("forward from w", True, True, False),
                     ("backward from w", False, True, False))

            def sweep(fn, x, w, forward, from_w, keep):
                fn(data, offs, grid, b, x, forward, w if from_w else None,
                   w if keep and not forward else None)

            reset_counters()
            symgs_dia_cuda.bands.clear()
            for kind, forward, from_w, keep in kinds:
                if kind == "forward from w":  # the prolongation's change
                    for x, _ in state.values():
                        x.view(grid[2], grid[1], grid[0])[::2, ::2, ::2] += 0.5
                sweep(symgs_dia_cuda.symgs_sweep, *state["kernel"], forward, from_w, keep)
                sweep(symgs_dia.symgs_sweep_plain, *state["plain"], forward, from_w, keep)
                torch.cuda.synchronize()
                for got, want, what in zip(state["kernel"], state["plain"], "xw"):
                    if not torch.equal(got, want):
                        bad = int((got != want).sum())
                        fail(f"23 {grid} {dname} {kind}: {what} differs from the "
                             f"plain version at {bad} of {n} rows")
            rc = [torch.zeros(nc, dtype=dt, device=dev) for _ in range(2)]
            x = state["kernel"][0]
            symgs_dia_cuda.restrict_residual(data, offs, grid, b, x, rc[0])
            symgs_dia.restrict_residual_plain(data, offs, grid, b, x, rc[1])
            torch.cuda.synchronize()
            if not torch.equal(rc[0], rc[1]):
                fail(f"23 {grid} {dname}: the restricted residual differs from "
                     "the plain version")
            launches = dict(_build.launches)
            want = {("symgs_planes", grid): 4 * symgs_dia_cuda.sweep_launches(grid),
                    ("restrict", grid): 1}
            if launches != want:
                fail(f"23 {grid} {dname}: launches {launches}, want {want}")
            cut = {forward: symgs_dia_cuda.sweep_bands(grid, forward)
                   for forward in (True, False)}
            want = collections.Counter((grid, b) for v in cut.values() for b in v
                                       for _ in range(2))
            if symgs_dia_cuda.bands != want:
                fail(f"23 {grid} {dname}: bands {dict(symgs_dia_cuda.bands)}, "
                     f"want {dict(want)}")

            # (b) device ms of each kind, the kernel's and the plain version's
            x, w = state["kernel"]
            for kind, forward, from_w, keep in kinds:
                def kernel_step(v, forward=forward, from_w=from_w, keep=keep):
                    sweep(symgs_dia_cuda.symgs_sweep, x, w, forward, from_w, keep)
                    return v

                def plain_step(v, forward=forward, from_w=from_w, keep=keep):
                    sweep(symgs_dia.symgs_sweep_plain, x, w, forward, from_w, keep)
                    return v

                nbytes = item * (stored + (2 if kind == "forward from zero" else 3) * n)
                rows.append(dict(
                    grid=list(grid), dtype=dname, kernel="symgs_dia_lines_planes",
                    kind=kind, launches=symgs_dia_cuda.sweep_launches(grid),
                    bands=cut[forward],
                    ms=device_ms(kernel_step, b, iters=SYMGS_ITERS),
                    plain_ms=device_ms(plain_step, b, iters=3,
                                       sessions=YARDSTICK_SESSIONS),
                    bound_ms=bound_ms(nbytes), bytes=nbytes))

            def restrict_step(v):
                symgs_dia_cuda.restrict_residual(data, offs, grid, b, x, rc[0])
                return v

            def restrict_plain_step(v):
                symgs_dia.restrict_residual_plain(data, offs, grid, b, x, rc[1])
                return v

            nbytes = item * (coarse_nnz + n + 2 * nc)
            rows.append(dict(
                grid=list(grid), dtype=dname, kernel="mg_restrict", kind="restrict",
                launches=1, ms=device_ms(restrict_step, b, iters=SYMGS_ITERS),
                plain_ms=device_ms(restrict_plain_step, b, iters=3,
                                   sessions=YARDSTICK_SESSIONS),
                bound_ms=bound_ms(nbytes), bytes=nbytes))
            for row in rows[-5:]:
                row["x_bound"] = row["ms"] / row["bound_ms"]
                show("23.symgs", **row)
            del data, b, state, rc, x, w
        del A
        symgs_dia._sweep_plan.cache_clear()
        symgs_dia_cuda.device_steps.cache_clear()
        torch.cuda.empty_cache()
    return rows


STREAM_CASES = (  # phase 24: (name, stored offsets, rows, dtypes)
    ("hpcg 256^3", tuple(sorted(o for o in {sx + 256 * (sy + 256 * sz) for sz in (-1, 0, 1)
                                             for sy in (-1, 0, 1) for sx in (-1, 0, 1)}
                                if o <= 0)), 256 ** 3, (torch.float64, torch.float32)),
    ("laplace 3200^2", (-3200, -1, 0), 3200 ** 2, (torch.float64,)),
)
STREAM_ITERS = 50


def phase_dia_stream(dev, cases=STREAM_CASES) -> list:
    """Phase 24: dia_sym_spmv's two designs, the stream kernel
    (csrc/dia_stream.cu) and the tile kernel (csrc/dia_window.cuh), on
    HPCG's 27-point offsets at 256^3 (fp64, fp32), where ``route`` must
    pick the stream kernel, and on the 3200^2 Laplacian (fp64), where it
    must keep the tile kernel; random data and x (seeded), one shard. Both
    launched through ``spmv_dia_cuda.launch``, one launch each under its
    key from a reset, the same bits, within TOL_KERNEL of the plain
    version; then device ms of each (``device_ms``) in turns, stream, tile,
    tile, stream, beside the plain version's and the least-bytes bound
    (K + 2) npad itemsize. The Laplacian's stream time is recorded without
    routing it. Returns the rows."""
    Route = spmv_dia_cuda.Route
    rows = []
    for name, offs, n, dtypes in cases:
        nr = -(-n // 128)
        for dt in dtypes:
            dname = str(dt).split(".")[1]
            gen = torch.Generator(device=dev).manual_seed(24)
            data = (torch.randn((1, nr, len(offs) * 128), generator=gen, device=dev,
                                dtype=torch.float64) / len(offs)).to(dt)
            x2 = torch.randn((nr, 128), generator=gen, device=dev,
                             dtype=torch.float64).to(dt)
            want = "stream" if name.startswith("hpcg") else "tile"
            r = spmv_dia_cuda.route(offs, True, False, dt)
            if r.kernel != want:
                fail(f"24 {name} {dname}: route {r}, want {want}")
            reset_counters()
            y_s = spmv_dia_cuda.launch(Route("stream"), data, x2, offs, True, False)
            y_t = spmv_dia_cuda.launch(Route("tile"), data, x2, offs, True, False)
            torch.cuda.synchronize()
            got = launched("dia_sym", spmv_dia_cuda.STREAM_KEY)
            if got != {"dia_sym": 1, spmv_dia_cuda.STREAM_KEY: 1}:
                fail(f"24 {name} {dname}: launches {got}")
            if not torch.equal(y_s, y_t):
                bad = int((y_s != y_t).sum())
                fail(f"24 {name} {dname}: the stream kernel differs from the tile "
                     f"kernel at {bad} of {n} rows")
            y_p = spmv_dia_stacked_plain(data, x2, offs, True)
            err = rel_l2(y_s.cpu().numpy(), y_p.cpu().numpy())
            if err > TOL_KERNEL[dname]:
                fail(f"24 {name} {dname}: stream vs plain rel L2 {err:.3e}")
            del y_s, y_t, y_p

            def step(v, kernel):
                spmv_dia_cuda.launch(Route(kernel), data, v, offs, True, False)
                return v

            ms = {"stream": [], "tile": []}
            for kernel in ("stream", "tile", "tile", "stream"):
                ms[kernel].append(device_ms(lambda v, k=kernel: step(v, k), x2,
                                            iters=STREAM_ITERS))
            plain_ms = device_ms(lambda v: (spmv_dia_stacked_plain(data, v, offs, True), v)[1],
                                 x2, iters=3, sessions=YARDSTICK_SESSIONS)
            nbytes = (len(offs) + 2) * nr * 128 * data.element_size()
            row = dict(case=name, dtype=dname, route=r.kernel,
                       stream_plan=spmv_dia_cuda.stream_plan(offs, dt).summary(),
                       window_plan=spmv_dia_cuda.window_plan(offs, True, 1, dt).summary(),
                       stream_ms=ms["stream"], tile_ms=ms["tile"], plain_ms=plain_ms,
                       bound_ms=bound_ms(nbytes), bytes=nbytes, rel_l2=err)
            row["stream_roofline"] = 100 * row["bound_ms"] / float(np.median(ms["stream"]))
            row["tile_roofline"] = 100 * row["bound_ms"] / float(np.median(ms["tile"]))
            show("24.dia_stream", **row)
            rows.append(row)
            del data, x2
            torch.cuda.empty_cache()
    return rows


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
    return dataclasses.replace(w, values=w.values.to(dt),
                               rows_values=w.rows_values.to(dt))


def rows_args(w):
    """A WellMatrix's (or WellDsMatrix's) row-list operands as a D=1 stack:
    (values [hi, lo], pos, slice_ptr, w0)."""
    planes = ((w.rows_values_hi, w.rows_values_lo) if hasattr(w, "rows_values_hi")
              else (w.rows_values,))
    return tuple(t.unsqueeze(0) for t in (*planes, w.rows_pos, w.slice_ptr, w.w0))


def well_args(w):
    """Its WELL operands as a D=1 stack: (values [hi, lo], pos, w0)."""
    planes = ((w.values_hi, w.values_lo) if hasattr(w, "values_hi") else (w.values,))
    return tuple(t.unsqueeze(0) for t in (*planes, w.pos, w.w0))


def dist_rows(A, tag=""):
    """A DistMatrix's row-list operands of its L (tag "") or L^T ("T")
    stack: (values [hi, lo], pos, slice_ptr, w0)."""
    lo = getattr(A, f"local_rows{tag}_values_lo")
    return (getattr(A, f"local_rows{tag}_values"), *([] if lo is None else [lo]),
            getattr(A, f"local_rows{tag}_pos"), getattr(A, f"local_rows{tag}_ptr"),
            getattr(A, f"local_well{tag}_w0"))


def dist_well(A, tag=""):
    """Its WELL operands of the same stack, (values [hi, lo], pos, w0), on
    the operator's device: the oracles read them there, the operator keeps
    values and pos on the host."""
    lo = getattr(A, f"local_well{tag}_values_lo")
    return tuple(t.to(A.device) for t in (
        getattr(A, f"local_well{tag}_values"), *([] if lo is None else [lo]),
        getattr(A, f"local_well{tag}_pos"), getattr(A, f"local_well{tag}_w0")))


def well_compare(name, rows, well, x2, tg, tol):
    """One WELL kernel launch on a stack's row lists vs their plain version
    on the same inputs; the row-list plain version must equal the WELL
    formula's (``well``: the same stack's WELL operands) bit for bit."""
    y_k = spmv_well_cuda.spmv_well_stacked(*rows, x2, tg)
    torch.cuda.synchronize()
    y_p = spmv_well_rows_plain(*rows, x2, tg)
    if not torch.equal(y_p, spmv_well_stacked_plain(*well, x2, tg)):
        fail(f"{name}: the row-list plain version differs from the WELL formula")
    return check_close(name, y_k, y_p, tol)


def well_ds_compare(name, rows, well, xs, tg) -> np.ndarray:
    """``ds_compare`` of well_ds_spmv on a stack's row lists; their plain
    version must equal the WELL formula's bit for bit."""
    def plain(*args):
        y = spmv_well_ds_rows_plain(*args)
        want = spmv_well_ds_stacked_plain(*well, *xs, tg)
        if not all(torch.equal(a, b) for a, b in zip(y, want)):
            fail(f"{name}: the row-list plain version differs from the WELL formula")
        return y

    return ds_compare(name, spmv_well_ds_cuda.spmv_well_ds_stacked, plain,
                      (*rows, *xs, tg))


def block_column_check(name, rows, xs, tg) -> None:
    """The block kernel at nrhs 1 vs the single-RHS kernel, both on the
    stack's row lists: bit for bit (both planes for DS)."""
    if len(xs) == 1:
        one = (spmm_well_cuda.spmm_well_stacked(*rows, *xs, tg),)
        got = (spmv_well_cuda.spmv_well_stacked(*rows, *xs, tg),)
    else:
        one = spmm_well_cuda.spmm_well_ds_stacked(*rows, *xs, tg)
        got = spmv_well_ds_cuda.spmv_well_ds_stacked(*rows, *xs, tg)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, one)):
        fail(f"{name}: the single-RHS kernel differs from the block kernel's "
             "column at nrhs 1")


def same_bits(tag: str, apply, runs: int = 2):
    """The determinism gate: ``apply()`` ``runs`` times on the same inputs
    must give the same bits (no term of an apply sums with atomics).
    Returns the first run's result."""
    first = apply()
    first = first if isinstance(first, tuple) else (first,)
    for _ in range(runs - 1):
        again = apply()
        again = again if isinstance(again, tuple) else (again,)
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            fail(f"{tag}: a repeated apply on the same inputs gave other bits")
    return first if len(first) > 1 else first[0]


def rows_stats(ptr, nnz: int) -> dict:
    """Geometry of a stack's row lists (slice_ptr (D, S+1)) beside its
    nonzeros."""
    entries = int(ptr[:, -1].sum())
    return dict(rows_entries=entries, rows_occupancy=nnz / max(entries, 1),
                rows_widest_slice=int((ptr[:, 1:] - ptr[:, :-1]).max()) // 32)


POISSON_CELLS = (4480, 2240)  # poisson2d_4480.matvec's mesh


def phase_poisson2d(dev, cells=POISSON_CELLS) -> dict:
    """Phase 25: DOLFINx's P1 Poisson operator (the benchmark's
    ``poisson2d_p1`` generator, its level order) on ``cells`` through
    build_dist_matrix(well, symmetric float64), as the benchmark's System
    builds it; the gates and timings of the module doc's item 25. Returns
    the timing row."""
    from bench_h100 import roofline
    from bench_h100.matrices import poisson2d_p1

    cx, cy = cells
    name = f"poisson2d_p1 {cx}x{cy}"
    t0 = time.perf_counter()
    a = poisson2d_p1.generate({"cx": cx, "cy": cy})
    host = CSRHost(a.rowptr, a.colind, a.values, a.ncols)
    t_gen = time.perf_counter() - t0
    before = dict(dist_matrix_mod.build_seconds)
    t0 = time.perf_counter()
    A = build_dist_matrix(host, symmetric=True, dtype=np.float64,
                          local_format="well", device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    if A.local_format != "well" or A.dtype != torch.float64:
        fail(f"25 {name}: built {A.local_format} {A.dtype}")
    layout = dist_matrix_mod.layout_bytes["well"]
    # the strict lower triangle's nonzeros: the row lists keep no stored zero
    rows = np.repeat(np.arange(a.nrows, dtype=np.int64), np.diff(a.rowptr))
    nonzero = int(np.count_nonzero((a.colind < rows) & (a.values != 0)))
    del rows
    show("25.build", matrix=name, rows=a.nrows, nnz=a.nnz, lower_nnz=a.lower_nnz(),
         generate_s=t_gen, build_s=t_build,
         **{f"{k}_s": dist_matrix_mod.build_seconds[k] - before[k] for k in before},
         well_meta=list(A.well_meta), wellT_meta=list(A.wellT_meta),
         far_nnz=A.well_far_nnz, farT_nnz=A.well_farT_nnz,
         pos_dtype=str(A.local_rows_pos.dtype), layout_bytes=layout,
         apply_bytes=roofline.apply_bytes(a, True, "float64"),
         memory_allocated=torch.cuda.memory_allocated(dev),
         L=rows_stats(A.local_rows_ptr, nonzero), LT=rows_stats(A.local_rowsT_ptr, nonzero))
    x = 2.0 * np.random.default_rng(25).random(a.nrows) - 1.0
    x2 = A.to_dist(x)
    stacks = {"L": ("", A.well_meta[2]), "LT": ("T", A.wellT_meta[2])}
    for stack, (tag, tg) in stacks.items():
        _, err, mabs = well_compare(f"25 spmv_well {name} {stack}", dist_rows(A, tag),
                                    dist_well(A, tag), x2, tg, TOL_KERNEL["float64"])
        show("25.kernel", kernel="spmv_well", dtype="float64", matrix=name,
             stack=stack, rel_l2_vs_plain=err, max_abs_vs_plain=mabs)
    reset_counters()
    A.matvec(x2)
    torch.cuda.synchronize()
    counts = launched("well", "well_ds", "dia", "dia_sym", "dia_sym_stream")
    if counts != {"well": 2, "well_ds": 0, "dia": 0, "dia_sym": 0, "dia_sym_stream": 0}:
        fail(f"25 {name}: one matvec launched {counts}")
    y = A.from_dist(same_bits(f"25 {name} matvec", lambda: A.matvec(x2)))
    absolute = CSRHost(a.rowptr, a.colind, np.abs(a.values), a.ncols)
    err = float(np.linalg.norm(y - host.matvec(x))
                / np.linalg.norm(absolute.matvec(np.abs(x))))
    if not err <= 1e-14:
        fail(f"25 {name}: matvec vs host CSR {err:.3e}")
    show("25.matvec", matrix=name, launches=counts, apply_error_vs_host=err)

    row = {"matrix": name, "dtype": "float64"}
    for stack, (tag, tg) in stacks.items():
        ops = dist_rows(A, tag)
        ms = device_ms(lambda v, ops=ops, tg=tg: spmv_well_cuda.spmv_well_stacked(
            *ops, x2, tg), x2)
        entries = int(ops[2][:, -1].sum())
        nbytes = (entries * (ops[0].element_size() + ops[1].element_size())
                  + sum(t.numel() * t.element_size() for t in ops[2:])
                  + 2 * x2.numel() * x2.element_size())
        row[stack] = dict(ms=ms, bound_ms=bound_ms(nbytes), entries=entries)
    row["plain_L_ms"] = yardstick_ms(lambda v: spmv_well_rows_plain(
        *dist_rows(A), x2, A.well_meta[2]), x2)
    row["apply_ms"] = device_ms(lambda v: A.matvec(x2), x2)
    row["glue_ms"] = row["apply_ms"] - row["L"]["ms"] - row["LT"]["ms"]
    row["apply_bound_ms"] = bound_ms(roofline.apply_bytes(a, True, "float64"))
    row["layout_bound_ms"] = bound_ms(layout)
    row["library_ms"] = library_device_ms(host, dev, 1.0, np.float64)
    show("25.timing", **row)
    del A, x2
    torch.cuda.empty_cache()
    return row


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
         **rows_stats(w4.slice_ptr.unsqueeze(0), a4.nnz),
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
                f"spmv_well {tag} {dname}", rows_args(wd), well_args(wd), x2,
                wd.tile_groups, TOL_KERNEL[dname])
            max_abs = max(max_abs, mabs)
            fields = dict(kernel="spmv_well", dtype=dname, matrix=tag,
                          k_slots=wd.k_slots, paired=wd.paired,
                          pos_dtype=str(wd.rows_pos.dtype), rel_l2_vs_plain=err,
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
            f"spmv_well D=3 {dname}", dist_rows(A), dist_well(A), x2,
            A.well_meta[2], TOL_KERNEL[dname])
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
    for far in (sw.farl_ell, sw.faru_ell):
        if far is not None:
            cols, vals = far
            y = y + (vals * xp[cols]).sum(-1)
    return y


def well_stats(A, a):
    """Geometry of a DistMatrix's WELL stacks, for the phase lines: WELL
    slots and row-list entries beside the stored nonzeros, the bytes the
    card holds and those of the WELL arrays kept on the host."""
    k, wseg, tg, paired = A.well_meta
    stored = int((A.local_well_values != 0).sum())
    slots = A.local_well_values.numel()
    if A.symmetric:
        stored += int((A.local_wellT_values != 0).sum())
        slots += A.local_wellT_values.numel()
    host_bytes = sum(t.numel() * t.element_size() for t in
                     (getattr(A, name) for name in HOST_FIELDS) if t is not None)
    out = dict(rows=a.nrows, nnz=a.nnz, k_slots=k,
               k_slots_T=A.wellT_meta[0] if A.symmetric else None,
               wseg=wseg, tile_groups=tg, paired=paired, well_slots=slots,
               occupancy=stored / slots,
               far_nnz=A.well_far_nnz + A.well_farT_nnz,
               rows_pos_dtype=str(A.local_rows_pos.dtype),
               device_bytes=A.format_size_bytes(), well_host_bytes=host_bytes)
    entries = int(A.local_rows_ptr[:, -1].sum())
    if A.symmetric:
        entries += int(A.local_rowsT_ptr[:, -1].sum())
    out.update(rows_entries=entries, rows_occupancy=stored / entries)
    return out


def phase_fem_main_path(dev):
    """Phase 8: the general-sparsity main path through the port's entry
    points. Returns (WELL launch count of the solves, its/s, the RCM'd FEM
    matrix, the symmetric fp32 operator, the largest abs kernel-vs-plain
    difference on its stacks, (iterations, solution) of the fp64 solve, the
    symmetric fp32 Jacobi-PCG's iterations)."""
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
    # stack the solves below launch (L and L^T, or the vanilla stack); each
    # also bit for bit against the block kernel's column at nrhs 1, and the
    # row-list packer timed again on the stack's WELL arrays
    rng = np.random.default_rng(8)
    max_abs = 0.0
    for dt, sym, fmt, A, _, _, _ in runs:
        dname = np.dtype(dt).name
        x2 = A.to_dist(rng.standard_normal(a.nrows).astype(dt))
        for part, tag in (("L", ""), ("L^T", "T")) if sym else (("A", ""),):
            meta = getattr(A, f"well{tag}_meta")
            rows, well = dist_rows(A, tag), dist_well(A, tag)
            name = f"spmv_well FEM {part} {dname} ({fmt})"
            _, err, mabs = well_compare(name, rows, well, x2, meta[2],
                                        TOL_KERNEL[dname])
            block_column_check(name, rows, (x2,), meta[2])
            max_abs = max(max_abs, mabs)
            host = [getattr(A, f"local_well{tag}_{f}").numpy() for f in ("values", "pos")]
            t0 = time.perf_counter()
            packed = pack_rows(*host, meta[1])
            pack_s = time.perf_counter() - t0
            if not np.array_equal(packed.slice_ptr, rows[2].cpu().numpy()):
                fail(f"{name}: the operator's row lists are not pack_rows' own")
            nnz = int((well[0] != 0).sum())
            show("8.kernel", kernel="spmv_well", dtype=dname,
                 matrix=f"fem_p1_2d {N_FEM} RCM, {part} stack ({fmt})",
                 k_slots=meta[0], tile_groups=meta[2], well_pos_dtype=str(well[1].dtype),
                 well_slots=well[0].numel(), well_occupancy=nnz / well[0].numel(),
                 **rows_stats(rows[2], nnz), rows_pos_dtype=str(rows[1].dtype),
                 rows_pack_s=pack_s, rel_l2_vs_plain=err, max_abs_vs_plain=mabs,
                 bit_equal_to_block_kernel_nrhs1=True)
            del host, packed
        del x2

    reset_counters()
    results = []
    for dt, sym, fmt, A, b, b_host, t_asm in runs:
        before = _build.launches["well"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cg(A.as_linear_operator(), b, kmax=20000, rtol=1e-6,
                 preconditioner=A.jacobi_preconditioner())
        torch.cuda.synchronize()
        results.append((dt, sym, fmt, A, res, b_host, t_asm,
                        time.perf_counter() - t0,
                        _build.launches["well"] - before))
    counts = launched("well")

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
            fp64 = (res.iterations, x)
        its_per_s[tag] = res.iterations / t_solve
        show("8.main_path", **fields)
    if counts["well"] == 0:
        fail("the FEM main path launched no WELL kernel")
    show("8.main_path", launches=counts)
    phase_fem_plain_cg(runs[:2])
    return counts["well"], its_per_s, a, runs[0][3], max_abs, fp64, results[0][4].iterations


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
    lower, upper = dist_well(A), dist_well(A, "T")

    def plain_op(p):
        y = spmv_well_stacked_plain(*lower, p, A.well_meta[2])
        y = y + spmv_well_stacked_plain(*upper, p, A.wellT_meta[2])
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
            x2 = A.to_dist(x)
            y = A.from_dist(same_bits(f"9: halo matvec {tag}", lambda: A.matvec(x2)))
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
                 matvec_rel_l2_vs_host=merr, matvec_same_bits_twice=True,
                 cg_iterations=res.iterations,
                 cg_host_rel_residual=host_rel, cg_reported_rel_residual=rep_rel)


def csr_tensor(a: CSRHost, dev, scale: float = 1.0, dtype=np.float32):
    """The library yardstick's operand: torch CSR (int32 indices) on the
    card."""
    with warnings.catch_warnings():  # torch's "beta" notice for sparse CSR
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.as_tensor(a.rowptr.astype(np.int32), device=dev),
            torch.as_tensor(a.colind, device=dev),
            torch.as_tensor(a.values.astype(dtype) * dtype(scale), device=dev),
            size=a.shape)


def time_in_turns(kernel, plain, x0, iters_k=100, iters_p=25):
    """(kernel ms, plain ms, runs) in turns plain, kernel, kernel, plain."""
    t_p1 = bench_chained(plain, x0, iters=iters_p)
    t_k1 = bench_chained(kernel, x0, iters=iters_k)
    t_k2 = bench_chained(kernel, x0, iters=iters_k)
    t_p2 = bench_chained(plain, x0, iters=iters_p)
    return (1e3 * (t_k1 + t_k2) / 2, 1e3 * (t_p1 + t_p2) / 2,
            [1e3 * t_k1, 1e3 * t_k2], [1e3 * t_p1, 1e3 * t_p2])


MARKER = "spin_kernel"  # torch.cuda._sleep's kernel: one a step, to count steps


def device_ms(step, x0, iters: int = 50, sessions: int = 3, skip: str = None) -> float:
    """Device ms per call of a chained x -> step(x) loop: the time of every
    CUDA kernel it launches, from torch.profiler's CUPTI records. A chained
    loop timed with events is bound by the host once a call's kernels take
    less than its Python and launch time (36-83 us a WELL wrapper call on
    the H100 machines). The profiler drops records (on the card, sessions
    late in a long process kept 38 to 49 of 50 launches, about one in four
    read half the time, and one kept no marker), so each step also launches
    a marker kernel: a kernel's time a step is its mean time a recorded
    launch times its recorded launches a recorded marker, rounded; and the
    result is the median of ``sessions`` sessions that recorded markers (of
    at most twice as many tries): three for a kernel, YARDSTICK_SESSIONS
    for a plain version or a library call. Kernels whose name holds
    ``skip`` are left out."""
    x = step(x0)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    wanted, sessions = sessions, []
    for _ in range(2 * wanted):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                x = step(x)
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.count > 0]
        steps = sum(e.count for e in events if MARKER in e.key)
        if steps:
            sessions.append(sum(e.self_device_time_total / e.count * round(e.count / steps)
                                for e in events if MARKER not in e.key
                                and (skip is None or skip not in e.key)) / 1e3)
        if len(sessions) == wanted:
            break
    if not sessions:
        fail(f"device_ms: the profiler recorded no step in {2 * wanted} sessions")
    ms = sorted(sessions)[len(sessions) // 2]
    if not ms > 0:
        fail("device_ms: the profiler recorded no device time")
    return ms


def yardstick_ms(step, x0, iters: int = 50) -> float:
    """``device_ms`` of a plain version or a library call: one session."""
    return device_ms(step, x0, iters, sessions=YARDSTICK_SESSIONS)


def cold_l2_ms(step, x0, dev) -> float:
    """Device ms of one apply that finds the L2 cold: ``device_ms`` of a
    chain of (write a 128 MB buffer, apply) minus that of the writes alone.
    A stack that fits the 50 MB L2 stays there between chained applies; on
    the main path the other stack and the vectors pass through L2 between
    two applies of one stack."""
    buf = torch.empty(32 << 20, dtype=torch.float32, device=dev)

    def flushed(v):
        buf.zero_()
        return step(v)

    def flush_only(v):
        buf.zero_()
        return v

    ms = device_ms(flushed, x0) - device_ms(flush_only, x0)
    del buf
    return ms


def library_ms(a: CSRHost, dev, scale: float, dtype=np.float32) -> float:
    """ms of one torch CSR @ x (cuSPARSE) on the same matrix, chained."""
    m = csr_tensor(a, dev, scale, dtype)
    x0 = torch.as_tensor(gaussian_bump(a.ncols, dtype=dtype), device=dev)
    ms = 1e3 * bench_chained(lambda v: m @ v, x0, iters=50)
    del m
    return ms


def library_device_ms(a: CSRHost, dev, scale: float, dtype=np.float32) -> float:
    """``device_ms`` of the same torch CSR @ x."""
    m = csr_tensor(a, dev, scale, dtype)
    x0 = torch.as_tensor(gaussian_bump(a.ncols, dtype=dtype), device=dev)
    ms = yardstick_ms(lambda v: m @ v, x0)
    del m
    return ms


def library_block_ms(a: CSRHost, dev, scale: float, dtype, nrhs: int,
                     timer=None) -> dict:
    """ms of one torch CSR @ X (cuSPARSE SpMM) on a random (n, nrhs) block
    of the square matrix ``a``, chained (``timer(step, x0)``, by default
    CUDA events over 50 calls): with X and the product row-major
    (``m @ X``), and with both column-major (``torch.mm(m, X, out=)`` into
    two column-major buffers in turn). ``column_major_kept`` says the
    buffers kept their column-major strides."""
    timer = timer or (lambda step, x0: 1e3 * bench_chained(step, x0, iters=50))
    m = csr_tensor(a, dev, scale, dtype)
    x0 = torch.as_tensor(np.random.default_rng(10).standard_normal((a.ncols, nrhs))
                         .astype(dtype), device=dev)
    row_major = timer(lambda v: m @ v, x0)
    bufs = [torch.empty((nrhs, a.nrows), dtype=x0.dtype, device=dev).t()
            for _ in range(2)]
    turn = [0]

    def col_step(v):
        turn[0] ^= 1
        return torch.mm(m, v, out=bufs[turn[0]])

    column_major = timer(col_step, x0.t().contiguous().t())
    kept = all(b.stride() == (1, a.nrows) for b in bufs)
    del m, bufs
    return dict(row_major=row_major, column_major=column_major, column_major_kept=kept)


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
    lib64 = library_ms(a_lap, dev, 1.0 / 9.0, np.float64)
    for kname in ("dia_spmv", "dia_sym_spmv"):
        ms_k, ms_p, nbytes = dia_times[kname]  # (K+2)*npad*itemsize
        out[kname] = dict(ms=ms_k, plain_ms=ms_p, library_ms=lib,
                          bound_ms=bound_ms(nbytes), bytes=nbytes)
        show("10.timing", kernel=kname, dtype="float32", rows=a_lap.nrows,
             **out[kname], library="torch CSR @ x (cuSPARSE), full matrix",
             copy_gbs=copy_gbs)
        ms_k, ms_p, nbytes = dia_times[f"{kname} float64"]
        row = dict(ms=ms_k, plain_ms=ms_p, library_ms=lib64, bound_ms=bound_ms(nbytes),
                   bytes=nbytes, dtype="float64")
        out[kname]["other_shapes"] = {f"float64 laplace2d {NX}^2": row}
        show("10.timing", kernel=kname, rows=a_lap.nrows, **row,
             library="torch CSR @ x (cuSPARSE), full matrix, float64", copy_gbs=copy_gbs)

    def well_timing(tag, rows, well, tg, a_lib, lib_scale, nnz, nrows, ncols):
        values, pos, ptr, w0 = rows
        x = np.zeros(w0.shape[1] * tg * 128, np.float32)
        x[:ncols] = gaussian_bump(ncols, dtype=np.float32)
        x2 = torch.as_tensor(x, device=dev).view(-1, 128)

        def kernel(v):
            return spmv_well_cuda.spmv_well_stacked(*rows, v, tg)

        def plain(v):
            return spmv_well_rows_plain(*rows, v, tg)

        # device times (the chained loop of a kernel this short is bound by
        # the host), the chained event times beside them
        chained_k, chained_p, runs_k, runs_p = time_in_turns(kernel, plain, x2)
        ms_k, ms_p = device_ms(kernel, x2), yardstick_ms(plain, x2, 10)
        nbytes = (nnz * (values.element_size() + pos.element_size())
                  + w0.numel() * 4 + ptr.numel() * 8 + (ncols + nrows) * 4)
        vec_bytes = 2 * x.size * 4
        stored = (int(ptr[:, -1].sum()) * (values.element_size() + pos.element_size())
                  + ptr.numel() * 8 + w0.numel() * 4 + vec_bytes)
        well_stored = (well[0].numel() * (values.element_size() + well[1].element_size())
                       + w0.numel() * 4 + vec_bytes)
        row = dict(ms=ms_k, plain_ms=ms_p,
                   library_ms=library_device_ms(a_lib, dev, lib_scale),
                   bound_ms=bound_ms(nbytes), bytes=nbytes, timing="device",
                   chained_ms=chained_k, plain_chained_ms=chained_p,
                   library_chained_ms=library_ms(a_lib, dev, lib_scale))
        show("10.timing", kernel="spmv_well", matrix=tag, dtype="float32",
             well_k_slots=well[0].shape[1], tile_groups=tg, pos_dtype=str(pos.dtype),
             **row, ms_runs=runs_k, plain_ms_runs=runs_p,
             cold_l2_ms=cold_l2_ms(kernel, x2, dev), **rows_stats(ptr, nnz),
             stored_bytes=stored, well_stored_bytes=well_stored,
             well_occupancy=nnz / well[0].numel(),
             stored_copy_fraction=stored / (ms_k / 1e3) / 1e9 / copy_gbs,
             library="torch CSR @ x (cuSPARSE), same matrix", copy_gbs=copy_gbs)
        return row

    bench = well_timing(f"bench {N_WELL}", rows_args(w4), well_args(w4), 64, a4, 1.0,
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
    rows = dist_rows(A_fem)
    fem = well_timing(f"fem_p1_2d {N_FEM} RCM lower stack",
                      (rows[0] * scale, *rows[1:]), dist_well(A_fem), A_fem.well_meta[2],
                      lower, scale, lower.nnz, lower.nrows, lower.ncols)
    out["spmv_well"] = dict(fem, other_shapes={f"bench {N_WELL}": bench})
    return out


def perturbed(a: CSRHost, seed: int) -> CSRHost:
    """A float64 copy of ``a`` with every value multiplied by
    1 + 1e-9 N(0,1): below float32 resolution, so the lo planes carry
    information a float32 path cannot see."""
    rng = np.random.default_rng(seed)
    v = a.values.astype(np.float64) * (1 + 1e-9 * rng.standard_normal(a.nnz))
    return CSRHost(a.rowptr, a.colind, v, a.ncols)


def ds_pair(x: np.ndarray, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """The (hi, lo) float32 lane-layout pair of a float64 host vector."""
    return tuple(torch.as_tensor(p, device=dev).view(-1, 128)
                 for p in ds_from_f64(x))


def ds_compare(name, kernel, plain, args) -> np.ndarray:
    """One DS kernel launch vs its plain version on the same inputs: both
    planes must be equal bit for bit. Returns hi + lo on the host."""
    y_k = kernel(*args)
    torch.cuda.synchronize()
    y_p = plain(*args)
    for plane, k, p in zip(("hi", "lo"), y_k, y_p):
        if not bool(torch.isfinite(k).all()):
            fail(f"{name}: non-finite kernel output ({plane})")
        if not torch.equal(k, p):
            diff = float((k.double() - p.double()).abs().max())
            fail(f"{name}: {plane} plane differs from the plain version "
                 f"(max abs {diff:.3e})")
    return ds_to_f64(y_k[0].cpu().numpy(), y_k[1].cpu().numpy()).ravel()


def phase_ds_kernels(a_lap, a4, w4, dev):
    """Phase 11: both DS kernels vs their plain versions (bit for bit), vs
    the host float64 CSR oracle (DS_ORACLE_TOL) on values perturbed below
    float32 resolution, and the fp32 kernel on the same input as a control
    that must miss the oracle by DS_CONTROL_MISS x DS_ORACLE_TOL at least.
    Returns the 4M bench matrix's DS packing (phase 10 times it)."""
    rng = np.random.default_rng(11)
    dia_args = (spmv_dia_ds_cuda.spmv_dia_ds_stacked, spmv_dia_ds_stacked_plain)

    def gate(name, err, err32=None):
        if not err <= DS_ORACLE_TOL:
            fail(f"{name}: {err:.3e} from the host float64 CSR > {DS_ORACLE_TOL:.0e}")
        if err32 is not None and not err32 >= DS_CONTROL_MISS * DS_ORACLE_TOL:
            fail(f"{name}: the fp32 control is {err32:.3e} from the host CSR, "
                 "so the case cannot show that the lo planes are read")

    # the 3200^2 Laplacian
    ap = perturbed(a_lap, 110)
    n = ap.nrows
    d = csr_to_dia_ds(ap, row_align=ROW_ALIGN, device=dev)
    x = np.zeros(d.nrows_pad)
    x[:n] = rng.standard_normal(n)
    y = ds_compare(f"dia_ds_spmv lap{NX}", *dia_args,
                   (d.data_hi.unsqueeze(0), d.data_lo.unsqueeze(0),
                    *ds_pair(x, dev), d.offsets))
    want = ap.matvec(x[:n])
    d32 = csr_to_dia(ap, row_align=ROW_ALIGN, dtype=np.float32, device=dev)
    y32 = spmv_dia_cuda.spmv_dia_2d(
        d32, torch.as_tensor(x.astype(np.float32), device=dev).view(-1, 128))
    err, err32 = rel_l2(y[:n], want), rel_l2(y32.cpu().numpy().ravel()[:n], want)
    gate(f"dia_ds_spmv lap{NX}", err, err32)
    show("11.kernel", kernel="dia_ds_spmv", matrix=f"laplace2d {NX}^2, values "
         "x (1 + 1e-9 N(0,1))", bit_equal_to_plain=True,
         rel_l2_vs_host_csr=err, fp32_kernel_rel_l2_vs_host_csr=err32)
    del d, d32

    # random banded, odd offsets, D=3 stacked shards
    offs = (-301, -37, -5, -1, 0, 1, 5, 37, 301)
    nd, nr = 3, 1000
    planes = []
    for shape in ((nd, nr, len(offs) * 128), (nd * nr, 128)):
        hi = rng.standard_normal(shape)
        planes += [hi, hi * 1e-8 * rng.standard_normal(shape)]
    t = [torch.as_tensor(p, dtype=torch.float32, device=dev) for p in planes]
    ds_compare(f"dia_ds_spmv banded D={nd}", *dia_args, (*t, offs))
    show("11.kernel", kernel="dia_ds_spmv", bit_equal_to_plain=True,
         matrix=f"random banded hi/lo planes, offsets {list(offs)}, D={nd}")

    # the 4M bench matrix (tile_groups 64, int16 pos), a pair=True and an
    # int32-pos (tile_groups 8) packing of 200k rows, and a D=3 stack
    t0 = time.perf_counter()
    a4p = perturbed(a4, 111)
    w4ds = csr_to_well_ds(a4p, tile_groups=64, device=dev)
    show("11.well_ds_pack", matrix=f"bench banded-random {N_WELL}",
         k_slots=w4ds.k_slots, pos_dtype=str(w4ds.pos.dtype),
         pack_s=time.perf_counter() - t0)
    small = perturbed(build_well_matrix(N_WELL_SMALL, np.random.default_rng(1)), 112)
    # the fp32 control reuses phase 7's packing of the unperturbed matrix:
    # in float32 the two differ only where a 1e-9 perturbation crosses a
    # rounding boundary
    cases = [(f"bench {N_WELL} tg64", a4p, w4ds, w4)]
    for tg, pair in ((64, True), (8, False)):
        cases.append((f"bench {N_WELL_SMALL} tg{tg}{' paired' if pair else ''}",
                       small, csr_to_well_ds(small, tile_groups=tg, pair=pair,
                                             device=dev), None))
    for tag, a, w, w32 in cases:
        if "paired" in tag and not w.paired:
            fail(f"{tag}: pair=True packed no paired slot")
        x = np.zeros(w.ncols_pad)
        x[: a.ncols] = rng.standard_normal(a.ncols)
        y = well_ds_compare(f"well_ds_spmv {tag}", rows_args(w), well_args(w),
                            ds_pair(x, dev), w.tile_groups)
        want = a.matvec(x[: a.ncols])
        err = rel_l2(y[: a.nrows], want)
        err32 = None
        if w32 is not None:
            x32 = torch.as_tensor(x.astype(np.float32), device=dev).view(-1, 128)
            y32 = spmv_well_cuda.spmv_well_stacked(*rows_args(w32), x32,
                                                   w32.tile_groups)
            err32 = rel_l2(y32.cpu().numpy().ravel()[: a.nrows], want)
        gate(f"well_ds_spmv {tag}", err, err32)
        show("11.kernel", kernel="well_ds_spmv", matrix=tag + ", values x (1 + "
             "1e-9 N(0,1))", k_slots=w.k_slots, paired=w.paired,
             pos_dtype=str(w.rows_pos.dtype), bit_equal_to_plain=True,
             rel_l2_vs_host_csr=err, fp32_kernel_rel_l2_vs_host_csr=err32)
    A = build_dist_matrix(small, n_devices=3, local_format="well_ds", device=dev)
    x = rng.standard_normal(small.nrows)
    xs = (A.to_dist(ds_from_f64(x)[0]), A.to_dist(ds_from_f64(x)[1]))
    well_ds_compare("well_ds_spmv D=3", dist_rows(A), dist_well(A), xs,
                    A.well_meta[2])
    err = rel_l2(ds_to_f64(*(A.from_dist(t) for t in A.matvec_ds(*xs))),
                 small.matvec(x))
    gate("well_ds D=3 matvec_ds", err)
    show("11.kernel", kernel="well_ds_spmv", matrix=f"bench {N_WELL_SMALL}, D=3 "
         "stacked", well_meta=list(A.well_meta), bit_equal_to_plain=True,
         matvec_ds_rel_l2_vs_host=err)
    return w4ds


def phase_ds_main_path(a_lap, a_fem, fem_fp64, dev):
    """Phase 12: the float64 main path, demo_cg's default (float64,
    --format auto), through the transparent float64 matvec. (a) The 3200^2
    Laplacian: auto must pick dia_ds; CG beside the native-f64 vanilla dia
    solve. (b) The RCM'd 800k FEM, symmetric: auto must pick well_ds;
    Jacobi-PCG beside phase 8's native-f64 solve. Returns (launch counts,
    launches per CG iteration, the symmetric well_ds FEM operator)."""
    n = a_lap.nrows
    t0 = time.perf_counter()
    A = build_dist_matrix(a_lap, n_devices=1, local_format="auto", device=dev)
    if A.local_format != "dia_ds":
        fail(f"auto on the float64 Laplacian built {A.local_format!r}, not dia_ds")
    N = build_dist_matrix(a_lap, n_devices=1, dtype=np.float64,
                          local_format="dia", device=dev)
    b_host = gaussian_bump(n)
    b = A.to_dist(b_host)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0

    reset_counters()
    t0 = time.perf_counter()
    res = cg(A.as_linear_operator(), b, kmax=20000, rtol=1e-6)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    counts = {"dia_ds": _build.launches["dia_ds"]}
    t0 = time.perf_counter()
    res_n = cg(N.as_linear_operator(), N.to_dist(b_host), kmax=20000, rtol=1e-6)
    torch.cuda.synchronize()
    t_native = time.perf_counter() - t0
    if not (res.converged and res_n.converged):
        fail(f"12a: CG did not converge (DS {res.iterations}, native "
             f"{res_n.iterations})")
    if counts["dia_ds"] < res.iterations + 1:
        fail(f"12a: {counts['dia_ds']} dia_ds launches for {res.iterations + 1} applies")
    x, x_n = A.from_dist(res.x), N.from_dist(res_n.x)
    if not np.all(np.isfinite(x)):
        fail("12a: non-finite solution")
    host_rel = float(np.linalg.norm(b_host - a_lap.matvec(x)) / np.linalg.norm(b_host))
    rep_rel = float(res.rnorm) / float(res.rnorm0)
    diff = rel_l2(x, x_n)
    show("12.main_path", run=f"laplace2d {NX}^2 float64 auto -> dia_ds, CG",
         rows=n, iterations=res.iterations, native_f64_dia_iterations=res_n.iterations,
         reported_rel_residual=rep_rel, host_rel_residual=host_rel,
         rel_l2_vs_native_f64_solution=diff, assemble_s=t_asm, solve_s=t_solve,
         it_per_s=res.iterations / t_solve, native_solve_s=t_native,
         native_it_per_s=res_n.iterations / t_native,
         dia_ds_launches=counts["dia_ds"],
         launches_per_iteration=counts["dia_ds"] / (res.iterations + 1))
    if abs(host_rel - rep_rel) > 1e-8:
        fail(f"12a: host residual {host_rel:.3e} vs reported {rep_rel:.3e}")
    if abs(res.iterations - res_n.iterations) > 0.01 * res_n.iterations:
        fail(f"12a: {res.iterations} iterations, native f64 {res_n.iterations}")
    if not diff <= 1e-8:
        fail(f"12a: solution {diff:.3e} from the native f64 solution")
    per_iter = {"dia_ds": counts["dia_ds"] / (res.iterations + 1)}
    del A, N, b, res, res_n

    # (b) the FEM: demo_cg's float64 default on the RCM'd operator
    t0 = time.perf_counter()
    A = build_dist_matrix(a_fem, n_devices=1, symmetric=True, dtype=np.float64,
                          local_format="auto", device=dev)
    if A.local_format != "well_ds":
        fail(f"auto on the float64 FEM built {A.local_format!r}, not well_ds")
    b_host = gaussian_bump(a_fem.nrows)
    b = A.to_dist(b_host)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    # the kernel vs its plain version on the stacks the solve launches
    x = np.random.default_rng(12).standard_normal(a_fem.nrows)
    xs = (A.to_dist(ds_from_f64(x)[0]), A.to_dist(ds_from_f64(x)[1]))
    for part, tag in (("L", ""), ("L^T", "T")):
        meta = getattr(A, f"well{tag}_meta")
        rows, well = dist_rows(A, tag), dist_well(A, tag)
        name = f"well_ds_spmv FEM {part}"
        well_ds_compare(name, rows, well, xs, meta[2])
        block_column_check(name, rows, xs, meta[2])
        show("12.kernel", kernel="well_ds_spmv", bit_equal_to_plain=True,
             bit_equal_to_block_kernel_nrhs1=True,
             matrix=f"fem_p1_2d {N_FEM} RCM, {part} stack (auto, float64)",
             k_slots=meta[0], tile_groups=meta[2], pos_dtype=str(rows[2].dtype),
             **rows_stats(rows[3], int(((well[0] != 0) | (well[1] != 0)).sum())))
    del xs

    reset_counters()
    t0 = time.perf_counter()
    res = cg(A.as_linear_operator(), b, kmax=20000, rtol=1e-6,
             preconditioner=A.jacobi_preconditioner())
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    counts["well_ds"] = _build.launches["well_ds"]
    if not res.converged:
        fail(f"12b: Jacobi-PCG did not converge in {res.iterations}")
    if counts["well_ds"] < 2 * (res.iterations + 1):
        fail(f"12b: {counts['well_ds']} well_ds launches for "
             f"{res.iterations + 1} applies")
    x = A.from_dist(res.x)
    if not np.all(np.isfinite(x)):
        fail("12b: non-finite solution")
    ax = A.from_dist(A.matvec(res.x))
    absa = CSRHost(a_fem.rowptr, a_fem.colind,
                   np.abs(a_fem.values.astype(np.float64)), a_fem.ncols)
    ax_scale = float(np.linalg.norm(absa.matvec(np.abs(x))))
    op_err = float(np.linalg.norm(ax - a_fem.matvec(x)) / ax_scale)
    its_64, x_64 = fem_fp64
    diff = rel_l2(x, x_64)
    rep_rel = float(res.rnorm) / float(res.rnorm0)
    host_rel = float(np.linalg.norm(b_host - a_fem.matvec(x)) / np.linalg.norm(b_host))
    show("12.main_path", run=f"fem_p1_2d {N_FEM} RCM symmetric float64 auto -> "
         "well_ds, Jacobi-PCG", **well_stats(A, a_fem), iterations=res.iterations,
         native_f64_well_iterations=its_64, reported_rel_residual=rep_rel,
         host_rel_residual=host_rel, ax_at_solution_err_vs_host=op_err,
         rel_l2_vs_native_f64_solution=diff, assemble_s=t_asm, solve_s=t_solve,
         it_per_s=res.iterations / t_solve, well_ds_launches=counts["well_ds"],
         launches_per_iteration=counts["well_ds"] / (res.iterations + 1))
    if not op_err <= TOL_ORACLE["float64"]:
        fail(f"12b: A x at the solution {op_err:.3e} of || |A| |x| || from the host CSR")
    if abs(res.iterations - its_64) > FEM_DS_ITER_TOL * its_64:
        fail(f"12b: {res.iterations} iterations, phase 8's native f64 {its_64}")
    if not diff <= WITNESS_SOLUTION_TOL:
        fail(f"12b: solution {diff:.3e} from phase 8's native f64 solution")
    per_iter["well_ds"] = counts["well_ds"] / (res.iterations + 1)
    show("12.main_path", launches=counts, launches_per_iteration=per_iter)
    return counts, per_iter, A


def true_rel(a: CSRHost, x: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(b - a.matvec(x)) / np.linalg.norm(b))


def phase_refine(dev):
    """Phase 13: mixed-precision refinement, fp32 inner CG (rtol 1e-6,
    kmax 20000 each) with DS residuals, to rtol 1e-12 in at most 8 outer
    passes. Gated at REFINE_NX^2: the true float64 residual of
    cg_refined_dist <= REFINE_TOL and 100x below a plain fp32 CG's on the
    same system. cg_refined there is printed, not gated."""
    kw = dict(rtol=1e-12, max_outer=8, inner_rtol=1e-6, inner_kmax=20000,
              device=dev)
    a = create_laplace_2d(REFINE_NX, REFINE_NX)
    b = gaussian_bump(a.nrows)

    def run(tag, fn, mat, rhs, **extra):
        t0 = time.perf_counter()
        res = fn(mat, rhs, **kw, **extra)
        seconds = time.perf_counter() - t0
        rel = true_rel(mat, res.x, rhs)
        show("13.refine", run=tag, rows=mat.nrows, outer=res.outer_iterations,
             inner=res.inner_iterations, converged=res.converged,
             history=res.history, true_rel_residual=rel, seconds=seconds)
        return rel

    rel = run(f"cg_refined_dist dia, laplace2d {REFINE_NX}^2", cg_refined_dist, a, b)
    A32 = build_dist_matrix(a, n_devices=1, dtype=np.float32, local_format="dia",
                            device=dev)
    t0 = time.perf_counter()
    r32 = cg(A32.as_linear_operator(), A32.to_dist(b.astype(np.float32)),
             kmax=20000, rtol=1e-6)
    rel32 = true_rel(a, A32.from_dist(r32.x).astype(np.float64), b)
    show("13.refine", run=f"plain fp32 CG, laplace2d {REFINE_NX}^2 (the control)",
         iterations=r32.iterations, converged=r32.converged,
         true_rel_residual=rel32, seconds=time.perf_counter() - t0)
    if not rel <= REFINE_TOL:
        fail(f"13: refined true residual {rel:.3e} > {REFINE_TOL:.0e}")
    if not 100 * rel <= rel32:
        fail(f"13: refined true residual {rel:.3e} not 100x below fp32 CG's {rel32:.3e}")
    del A32
    run(f"cg_refined (one device), laplace2d {REFINE_NX}^2", cg_refined, a, b)


def phase_ds_halo(dev):
    """Phase 14: the DS halo path on D=4 stacked shards, one matvec_ds vs
    the host float64 oracle (DS_ORACLE_TOL): the 512^2 Laplacian as dia_ds,
    the RCM'd 50k FEM as well_ds, vanilla and symmetric (the transposed
    remote chain and the error-free reverse exchange). Then, printed, a
    Jacobi cg_refined_dist(well) on that FEM at D=4."""
    rng = np.random.default_rng(14)
    lap = perturbed(create_laplace_2d(HALO_NX, HALO_NX), 140)
    fem, _ = rcm_reorder(fem_p1_2d(HALO_FEM, seed=3, dtype=np.float64),
                         keep_best=True)
    for a, fmt, sym in ((lap, "dia_ds", False), (fem, "well_ds", False),
                        (fem, "well_ds", True)):
        A = build_dist_matrix(a, n_devices=HALO_D, symmetric=sym, local_format=fmt,
                              device=dev)
        x = rng.standard_normal(a.nrows) * 1e3
        xs = [A.to_dist(p) for p in ds_from_f64(x)]
        tag = f"{fmt} {'symmetric' if sym else 'vanilla'}"
        yh, yl = same_bits(f"14: {tag} matvec_ds", lambda: A.matvec_ds(*xs))
        err = rel_l2(ds_to_f64(A.from_dist(yh), A.from_dist(yl)), a.matvec(x))
        show("14.halo", run=tag, rows=a.nrows, shards=HALO_D,
             rounds=list(A.plan.rounds), nghost_pad=A.plan.nghost_pad,
             reverse_exchange=A.remoteT_colind is not None,
             matvec_ds_rel_l2_vs_host=err, matvec_ds_same_bits_twice=True)
        if not err <= DS_ORACLE_TOL:
            fail(f"14: {tag} matvec_ds {err:.3e} from the host CSR")
    b = gaussian_bump(fem.nrows)
    t0 = time.perf_counter()
    res = cg_refined_dist(fem, b, n_devices=HALO_D, rtol=1e-12, max_outer=8,
                          inner_kmax=20000, jacobi=True, local_format="well",
                          device=dev)
    show("14.refine", run=f"cg_refined_dist well jacobi, fem_p1_2d {HALO_FEM} "
         f"RCM, D={HALO_D} (not gated)", outer=res.outer_iterations,
         inner=res.inner_iterations, converged=res.converged,
         history=res.history, true_rel_residual=true_rel(fem, res.x, b),
         seconds=time.perf_counter() - t0)


def phase_ds_timing(a_lap, a4, w4ds, A_fem_ds, a_fem, dev):
    """Phase 10, DS kernels: kernel and plain ms in turns, the bytes bound
    (both value planes, pos and w0, x and y in both planes, once each) and
    the library yardstick (one float64 torch CSR @ x, cuSPARSE): dia_ds at
    NX^2, well_ds on the FEM's DS lower stack and on the 4M bench matrix."""
    out = {}

    def row(kernel, plain, x0, nbytes, a_lib, lib_scale):
        ms_k, ms_p, runs_k, runs_p = time_in_turns(kernel, plain, x0)
        return dict(ms=ms_k, plain_ms=ms_p,
                    library_ms=library_ms(a_lib, dev, lib_scale, np.float64),
                    bound_ms=bound_ms(nbytes), bytes=nbytes, ms_runs=runs_k,
                    plain_ms_runs=runs_p)

    # the Laplacian scaled by 1/9 so chained applies stay bounded
    a9 = CSRHost(a_lap.rowptr, a_lap.colind, a_lap.values / 9.0, a_lap.ncols)
    d = csr_to_dia_ds(a9, row_align=ROW_ALIGN, device=dev)
    x = np.zeros(d.nrows_pad)
    x[: a9.nrows] = gaussian_bump(a9.nrows)
    planes = (d.data_hi.unsqueeze(0), d.data_lo.unsqueeze(0))
    out["dia_ds_spmv"] = row(
        lambda v: spmv_dia_ds_cuda.spmv_dia_ds_stacked(*planes, *v, d.offsets),
        lambda v: spmv_dia_ds_stacked_plain(*planes, *v, d.offsets),
        ds_pair(x, dev), (2 * d.ndiags + 4) * d.nrows_pad * 4, a9, 1.0)
    show("10.timing", kernel="dia_ds_spmv", rows=a9.nrows, ndiags=d.ndiags,
         **out["dia_ds_spmv"], library="float64 torch CSR @ x (cuSPARSE), full matrix")
    del d, planes

    def well_row(tag, rows, well, tg, a_lib, lib_scale):
        vh, vl, pos, ptr, w0 = rows
        x = np.zeros(w0.shape[1] * tg * 128)
        x[: a_lib.ncols] = gaussian_bump(a_lib.ncols)
        nbytes = (a_lib.nnz * (8 + pos.element_size()) + w0.numel() * 4
                  + ptr.numel() * 8 + (a_lib.ncols + a_lib.nrows) * 8)
        def kernel(v):
            return spmv_well_ds_cuda.spmv_well_ds_stacked(*rows, *v, tg)

        def plain(v):
            return spmv_well_ds_rows_plain(*rows, *v, tg)

        # device times, as for spmv_well; the chained event times beside
        x0 = ds_pair(x, dev)
        r = row(kernel, plain, x0, nbytes, a_lib, lib_scale)
        r = dict(r, ms=device_ms(kernel, x0), plain_ms=yardstick_ms(plain, x0, 5),
                 library_ms=library_device_ms(a_lib, dev, lib_scale, np.float64),
                 timing="device", chained_ms=r["ms"], plain_chained_ms=r["plain_ms"],
                 library_chained_ms=r["library_ms"])
        vec_bytes = 4 * x.size * 4
        stored = int(ptr[:, -1].sum()) * (8 + pos.element_size()) + ptr.numel() * 8
        well_stored = well[0].numel() * (8 + well[2].element_size())
        show("10.timing", kernel="well_ds_spmv", matrix=tag, well_k_slots=well[0].shape[1],
             tile_groups=tg, pos_dtype=str(pos.dtype), **r,
             cold_l2_ms=cold_l2_ms(kernel, x0, dev),
             **rows_stats(ptr, a_lib.nnz),
             stored_bytes=stored + w0.numel() * 4 + vec_bytes,
             well_stored_bytes=well_stored + w0.numel() * 4 + vec_bytes,
             well_occupancy=a_lib.nnz / well[0].numel(),
             library="float64 torch CSR @ x (cuSPARSE), same matrix")
        return r

    bench = well_row(f"bench {N_WELL}", rows_args(w4ds), well_args(w4ds), 64, a4, 1.0)
    lower, _ = a_fem.split_lower_diag()
    row_sums = np.bincount(np.repeat(np.arange(lower.nrows), lower.row_nnz()),
                           weights=np.abs(lower.values), minlength=lower.nrows)
    scale = float(0.9 / row_sums.max())
    rows = dist_rows(A_fem_ds)
    fem = well_row(f"fem_p1_2d {N_FEM} RCM DS lower stack",
                   (rows[0] * scale, rows[1] * scale, *rows[2:]), dist_well(A_fem_ds),
                   A_fem_ds.well_meta[2], lower, scale)
    out["well_ds_spmv"] = dict(fem, other_shapes={f"bench {N_WELL}": bench})
    return out


BLOCK_KERNELS = ("dia_spmm", "dia_sym_spmm", "well_spmm", "dia_ds_spmm",
                 "well_ds_spmm")


def block_launches() -> dict:
    """The block kernels' launch counters, by kernel name."""
    return launched("dia_spmm", "dia_sym_spmm", "well_spmm", "well_ds_spmm", "dia_ds_spmm")


def single_launches() -> int:
    """Launches of the single-RHS kernels, all together."""
    return sum(launched("dia", "dia_sym", "well", "dia_ds", "well_ds").values())


def lanes_block(gen: torch.Generator, rows: int, nrhs: int, dtype, dev) -> torch.Tensor:
    """A random (rows, nrhs*128) block in the SpMM lane layout, drawn on
    the card from a seeded generator."""
    return torch.randn((rows, nrhs * 128), generator=gen, dtype=dtype, device=dev)


def spmm_check(name, kernel, plain, single, xs, tol) -> tuple[float, float]:
    """One block kernel launch vs its plain version on the same inputs:
    relative L2 <= ``tol`` (computed on the card), or with ``tol`` None
    (double-single) both planes bit for bit; a second launch with the same
    bits. Then every column vs the single-RHS kernel on that column, bit
    for bit. Returns (relative L2, max abs difference) vs the plain
    version."""
    yk = kernel(*xs)
    torch.cuda.synchronize()
    yp = plain(*xs)
    yk = yk if isinstance(yk, tuple) else (yk,)
    yp = yp if isinstance(yp, tuple) else (yp,)
    again = kernel(*xs)
    if not all(torch.equal(k, a) for k, a in zip(yk, again if isinstance(again, tuple)
                                                  else (again,))):
        fail(f"{name}: a second apply gave other bits")
    del again
    for k in yk:
        if not bool(torch.isfinite(k).all()):
            fail(f"{name}: non-finite kernel output")
    diff = yk[0].double() - yp[0].double()
    err = float(torch.linalg.vector_norm(diff)
                / torch.clamp(torch.linalg.vector_norm(yp[0].double()), min=1e-300))
    mabs = float(diff.abs().max())
    del diff
    if tol is None:
        for plane, k, p in zip(("hi", "lo"), yk, yp):
            if not torch.equal(k, p):
                fail(f"{name}: {plane} plane differs from the plain version")
    elif not err <= tol:
        fail(f"{name}: kernel vs plain rel L2 {err:.3e} > {tol:.0e}")
    kcols = [columns(k) for k in yk]
    xcols = [columns(x) for x in xs]
    for c in range(len(xcols[0])):
        one = single(*(xc[c] for xc in xcols))
        one = one if isinstance(one, tuple) else (one,)
        for plane, kc, o in zip(("hi", "lo"), kcols, one):
            if not torch.equal(kc[c], o):
                fail(f"{name}: column {c} ({plane}) differs from the single-RHS "
                     "kernel on that column")
    return err, mabs


def block_check(max_abs, phase, kname, matrix, dname, nrhs, kernel, plain, single,
                xs, tol, **extra):
    """``spmm_check`` of one block kernel case, printed under ``phase`` and
    folded into ``max_abs[kname]``."""
    err, mabs = spmm_check(f"{phase} {kname} {matrix} {dname} nrhs={nrhs}", kernel,
                           plain, single, xs, tol)
    max_abs[kname] = max(max_abs[kname], mabs)
    show(f"{phase}.kernel", kernel=kname, matrix=matrix, dtype=dname, nrhs=nrhs,
         rel_l2_vs_plain=err, max_abs_vs_plain=mabs, second_apply_same_bits=True,
         columns_bit_equal_to_single_rhs=True, **extra)


def ds_block(gen, rows: int, nrhs: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """A random float64 lane-layout block split on the card into its
    double-single (hi, lo) float32 planes."""
    x = lanes_block(gen, rows, nrhs, torch.float64, dev)
    hi = x.float()
    return hi, (x - hi.double()).float()


def phase_block_kernels(a, w4, w4ds, dev):
    """Phase 15: the five block kernels vs their plain versions on the card
    (fp32/fp64 within TOL_KERNEL, DS both planes bit for bit), each column
    bit-equal to the single-RHS kernel on it; nrhs 11 runs a chunk of 8
    columns and one of 3. DIA at NX^2 (the packing's symmetric and fp64
    forms derived on the card: the Laplacian's values are exact in both)
    and on a random banded D=3 stack; WELL on the 4M bench matrix, a
    paired and an int32-pos packing of 200k rows and a D=3 stack. Returns
    ({kernel: largest abs difference vs plain}, the fp32 vanilla DIA
    packing)."""
    rng = np.random.default_rng(15)
    gen = torch.Generator(device=dev).manual_seed(15)
    max_abs = dict.fromkeys(BLOCK_KERNELS, 0.0)

    def run(*args, **extra):
        block_check(max_abs, "15", *args, **extra)

    def dia_run(data, offs, sym, matrix, nrhs, dt):
        kname = "dia_sym_spmm" if sym else "dia_spmm"
        dname = str(dt).split(".")[1]
        x = lanes_block(gen, data.shape[0] * data.shape[1], nrhs,
                        torch.float32 if dt == torch.bfloat16 else dt, dev).to(dt)
        run(kname, matrix, dname, nrhs,
            lambda v: spmm_dia_cuda.spmm_dia_stacked(data, v, offs, sym),
            lambda v: spmm_dia_stacked_plain(data, v, offs, sym),
            lambda v: spmv_dia_cuda.spmv_dia_stacked(data, v, offs, sym),
            (x,), {**TOL_KERNEL, "bfloat16": BF16_TOL}[dname],
            **plan_fields(data, offs, sym, nrhs, block=True))

    d32 = csr_to_dia(a, row_align=ROW_ALIGN, dtype=np.float32, device=dev)
    nr, k0 = d32.data.shape[0], d32.offsets.index(0)
    lower = d32.data.view(nr, d32.ndiags, 128)[:, : k0 + 1].reshape(nr, -1)
    for dt in (torch.float32, torch.float64, torch.bfloat16):
        for sym in (False, True):
            data = (lower if sym else d32.data).to(dt).unsqueeze(0).contiguous()
            offs = d32.offsets[: k0 + 1] if sym else d32.offsets
            for nrhs in NRHS_KERNEL:
                dia_run(data, offs, sym, f"laplace2d {NX}^2", nrhs, dt)
            del data
    full = (-301, -37, -5, -1, 0, 1, 5, 37, 301)
    for dt in (torch.float32, torch.float64, torch.bfloat16):
        for sym in (False, True):
            offs = tuple(o for o in full if o <= 0) if sym else full
            data = torch.as_tensor(rng.standard_normal((3, 1000, len(offs) * 128)),
                                   device=dev).to(dt)
            for nrhs in (1, 3, 8, 11):
                dia_run(data, offs, sym, f"random banded offsets {list(offs)}, D=3",
                        nrhs, dt)

    # the DS DIA block kernel on the same shapes: the fp32 data as hi plane
    # and a small lo plane (bit equality needs no exact split)
    for data, offs, matrix in (
            (d32.data.unsqueeze(0), d32.offsets, f"laplace2d {NX}^2"),
            (torch.as_tensor(rng.standard_normal((3, 1000, len(full) * 128)),
                             dtype=torch.float32, device=dev), full,
             f"random banded offsets {list(full)}, D=3")):
        planes = (data, data * 1e-8)
        for nrhs in (NRHS_KERNEL if data.shape[0] == 1 else (3, 11)):
            xh = lanes_block(gen, data.shape[0] * data.shape[1], nrhs, torch.float32, dev)
            run("dia_ds_spmm", matrix, "double-single", nrhs,
                lambda h, lo: spmv_dia_ds_cuda.spmm_dia_ds_stacked(*planes, h, lo, offs),
                lambda h, lo: spmm_dia_ds_stacked_plain(*planes, h, lo, offs),
                lambda h, lo: spmv_dia_ds_cuda.spmv_dia_ds_stacked(*planes, h, lo, offs),
                (xh, xh * 1e-8), None)
        del planes

    # WELL and DS WELL: the 4M bench packings of phases 7 and 11, a paired
    # and an int32-pos packing of 200k rows, and D=3 stacks
    small = build_well_matrix(N_WELL_SMALL, np.random.default_rng(1))
    small64 = perturbed(small, 150)
    cases = [(f"bench {N_WELL} tg64", w4, w4ds)]
    for tg, pair in ((64, True), (8, False)):
        w = csr_to_well(small, tile_groups=tg, dtype=np.float32, pair=pair, device=dev)
        wds = csr_to_well_ds(small64, tile_groups=tg, pair=pair, device=dev)
        if pair and not (w.paired and wds.paired):
            fail(f"pair=True packed no paired slot at tg {tg}")
        cases.append((f"bench {N_WELL_SMALL} tg{tg}{' paired' if pair else ''}", w, wds))
    stacks = []
    for dt in (np.float32, np.float64):
        A = build_dist_matrix(small, n_devices=3, dtype=dt, local_format="well",
                              device=dev)
        stacks.append((dist_rows(A), A.well_meta[2], A.n_devices * A.col_pad // 128))
    Ads = build_dist_matrix(small64, n_devices=3, local_format="well_ds", device=dev)
    ds_stack = (dist_rows(Ads), Ads.well_meta[2], Ads.n_devices * Ads.col_pad // 128)

    # both kernels read the stack's row lists
    def well_run(matrix, rows_, tg, rows, nrhs):
        v = rows_[0]
        dname = str(v.dtype).split(".")[1]
        run("well_spmm", matrix, dname, nrhs,
            lambda x: spmm_well_cuda.spmm_well_stacked(*rows_, x, tg),
            lambda x: spmm_well_stacked_plain(*rows_, x, tg),
            lambda x: spmv_well_cuda.spmv_well_stacked(*rows_, x, tg),
            (lanes_block(gen, rows, nrhs, v.dtype, dev),), TOL_KERNEL[dname],
            rows_entries=v.shape[1], pos_dtype=str(rows_[-3].dtype))

    def well_ds_run(matrix, rows_, tg, rows, nrhs):
        xh = lanes_block(gen, rows, nrhs, torch.float32, dev)
        run("well_ds_spmm", matrix, "double-single", nrhs,
            lambda h, lo: spmm_well_cuda.spmm_well_ds_stacked(*rows_, h, lo, tg),
            lambda h, lo: spmm_well_ds_stacked_plain(*rows_, h, lo, tg),
            lambda h, lo: spmv_well_ds_cuda.spmv_well_ds_stacked(*rows_, h, lo, tg),
            (xh, xh * 1e-8), None, rows_entries=rows_[0].shape[1],
            pos_dtype=str(rows_[-3].dtype))

    for nrhs in NRHS_WELL:
        for matrix, w, wds in cases:
            for dt in (torch.float32, torch.float64):
                wd = as_dtype(w, dt)
                well_run(matrix, rows_args(wd), wd.tile_groups, wd.ncols_pad // 128,
                         nrhs)
                del wd
            well_ds_run(matrix, rows_args(wds), wds.tile_groups, wds.ncols_pad // 128,
                        nrhs)
        for stack in stacks:
            well_run(f"bench {N_WELL_SMALL}, D=3 stacked", *stack, nrhs)
        well_ds_run(f"bench {N_WELL_SMALL}, D=3 stacked", *ds_stack, nrhs)
    return max_abs, d32


def true_rels(a: CSRHost, X: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Per-column true float64 relative residuals on the host CSR."""
    R = np.stack([a.matvec(X[:, r]) for r in range(B.shape[1])], axis=1) - B
    return np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)


def path_stack_checks(a, fmt, matrix, gen, dev, max_abs):
    """Phase 16, before a refined solve: the block kernels vs their plain
    versions at nrhs NRHS on the local stacks of the fp32 operator and its
    double-single twin, built by the same ``build_dist_matrix`` calls that
    ``block_cg_refined_dist`` makes (fp32 within TOL_KERNEL, DS both planes
    bit for bit, every column bit-equal to the single-RHS kernel). On a
    WELL operator, its stack's geometry and the determinism gate: three
    matvec and three matmat applies of the fp32 operator (far remainder
    included) give the same bits. These launches come before the counters
    are zeroed. Returns the two operators."""
    a32 = build_dist_matrix(a, n_devices=1, dtype=np.float32, local_format=fmt,
                            device=dev)
    ads = build_dist_matrix(a, n_devices=1, local_format=fmt + "_ds", device=dev)
    rows = a32.n_devices * a32.row_lane_rows
    x = (lanes_block(gen, rows, NRHS, torch.float32, dev),)
    xds = ds_block(gen, rows, NRHS, dev)
    tag = f"{matrix}, block_cg_refined_dist's operators"
    if fmt == "dia":
        data, offs, sym = a32.local_dia_data, a32.dia_offsets, a32.symmetric
        block_check(max_abs, "16", "dia_spmm", tag, "float32", NRHS,
                    lambda v: spmm_dia_cuda.spmm_dia_stacked(data, v, offs, sym),
                    lambda v: spmm_dia_stacked_plain(data, v, offs, sym),
                    lambda v: spmv_dia_cuda.spmv_dia_stacked(data, v, offs, sym),
                    x, TOL_KERNEL["float32"], ndiags=len(offs),
                    **plan_fields(data, offs, sym, NRHS))
        planes, offs = (ads.local_dia_data, ads.local_dia_data_lo), ads.dia_offsets
        block_check(max_abs, "16", "dia_ds_spmm", tag, "double-single", NRHS,
                    lambda h, lo: spmv_dia_ds_cuda.spmm_dia_ds_stacked(*planes, h, lo, offs),
                    lambda h, lo: spmm_dia_ds_stacked_plain(*planes, h, lo, offs),
                    lambda h, lo: spmv_dia_ds_cuda.spmv_dia_ds_stacked(*planes, h, lo, offs),
                    xds, None, ndiags=len(offs))
    else:
        rows, tg = dist_rows(a32), a32.well_meta[2]
        block_check(max_abs, "16", "well_spmm", tag, "float32", NRHS,
                    lambda v: spmm_well_cuda.spmm_well_stacked(*rows, v, tg),
                    lambda v: spmm_well_stacked_plain(*rows, v, tg),
                    lambda v: spmv_well_cuda.spmv_well_stacked(*rows, v, tg),
                    x, TOL_KERNEL["float32"], rows_entries=rows[0].shape[1],
                    far_nnz=a32.well_far_nnz)
        drows, tg = dist_rows(ads), ads.well_meta[2]
        block_check(max_abs, "16", "well_ds_spmm", tag, "double-single", NRHS,
                    lambda h, lo: spmm_well_cuda.spmm_well_ds_stacked(*drows, h, lo, tg),
                    lambda h, lo: spmm_well_ds_stacked_plain(*drows, h, lo, tg),
                    lambda h, lo: spmv_well_ds_cuda.spmv_well_ds_stacked(*drows, h, lo, tg),
                    xds, None, rows_entries=drows[0].shape[1], far_nnz=ads.well_far_nnz)
        v1 = x[0][:, :128].contiguous()
        same_bits(f"16 {matrix}: matvec", lambda: a32.matvec(v1), runs=3)
        same_bits(f"16 {matrix}: matmat", lambda: a32.matmat(x[0]), runs=3)
        show("16.well_stats", matrix=matrix, operator="float32 (block_cg_refined_dist's)",
             **well_stats(a32, a), ds_device_bytes=ads.format_size_bytes(),
             ds_well_host_bytes=well_stats(ads, a)["well_host_bytes"],
             matvec_same_bits_3x=True, matmat_same_bits_3x=True)
    return a32, ads


def phase_block_path(dev, max_abs):
    """Phase 16: the block path at full size through the port's entry
    points, nrhs = NRHS. Before each solve its operators' block kernels
    are held against their plain versions on those operators' own stacks
    (``path_stack_checks``; 16d on its float64 symmetric packing), folded
    into ``max_abs``. (a)-(c) block_cg_refined_dist: fp32 block CG inner
    passes (simultaneous recurrences, one dia_spmm / well_spmm launch per
    inner iteration plus one per pass for the initial residual) and DS
    true residuals (one dia_ds_spmm / well_ds_spmm launch each), gated on
    every column's true float64 residual on the host CSR. (d) block_cg_dia
    on symmetric storage in float64 (coupled O'Leary CG, one dia_sym_spmm
    launch per iteration plus the initial residual's). The counters are
    zeroed just before each solve and read just after. Returns the block
    kernels' launch counts, summed."""
    totals = dict.fromkeys(BLOCK_KERNELS, 0)
    gen = torch.Generator(device=dev).manual_seed(16)
    lap_refine = create_laplace_2d(REFINE_NX, REFINE_NX)

    def circuit():
        a, _ = rcm_reorder(circuit_network(CIRCUIT_BLOCK_NX, dtype=np.float64),
                           keep_best=True)
        return a

    runs = (
        ("a", f"laplace2d {BLOCK_NX}^2", lambda: create_laplace_2d(BLOCK_NX, BLOCK_NX),
         "dia", dict(inner_rtol=1e-4, inner_kmax=1500), BLOCK_TOL["a"]),
        ("b", f"laplace2d {REFINE_NX}^2", lambda: lap_refine, "dia",
         dict(inner_rtol=1e-4, inner_kmax=4000, max_outer=10), BLOCK_TOL["b"]),
        ("c", f"circuit_network({CIRCUIT_BLOCK_NX}) RCM", circuit, "well",
         dict(inner_rtol=1e-4, inner_kmax=4000, max_outer=10), BLOCK_TOL["c"]),
    )
    circuit_ops = None
    for tag, matrix, make, fmt, kw, tol in runs:
        t0 = time.perf_counter()
        a = make()
        B = np.random.default_rng(160).standard_normal((a.nrows, NRHS))
        t_make = time.perf_counter() - t0
        ops = path_stack_checks(a, fmt, matrix, gen, dev, max_abs)
        if fmt == "well":
            circuit_ops = (a, *ops)
        del ops
        reset_counters()
        t0 = time.perf_counter()
        X, outer, inner, rnorms = block_cg_refined_dist(a, B, local_format=fmt,
                                                        device=dev, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got, singles = block_launches(), single_launches()
        if not np.all(np.isfinite(X)):
            fail(f"16{tag}: non-finite solution")
        rel = true_rels(a, X, B)
        inner_key, ds_key = f"{fmt}_spmm", f"{fmt}_ds_spmm"
        show("16.block_path", run=f"block_cg_refined_dist {fmt}, {matrix}",
             rows=a.nrows, nnz=a.nnz, nrhs=NRHS, **kw, outer_passes=outer,
             inner_iterations=inner, true_rel_residuals=rel.tolist(),
             max_true_rel_residual=float(rel.max()), gate=tol,
             ds_rel_residuals=(rnorms / np.linalg.norm(B, axis=0)).tolist(),
             launches=got, single_rhs_launches=singles, generate_s=t_make,
             seconds=seconds)
        if not rel.max() <= tol:
            fail(f"16{tag}: a column's true residual is {rel.max():.3e} > {tol:.0e}")
        if got[inner_key] != inner + outer - 1 or got[ds_key] != outer:
            fail(f"16{tag}: {got[inner_key]} {inner_key} launches for {inner} inner "
                 f"iterations in {outer - 1} inner solves, {got[ds_key]} {ds_key} "
                 f"launches for {outer} residuals")
        if singles:
            fail(f"16{tag}: the block path launched {singles} single-RHS kernels")
        for key in totals:
            totals[key] += got[key]
        if fmt == "well":
            # the determinism gate, end to end: the same solve again
            X2, outer2, inner2, _ = block_cg_refined_dist(a, B, local_format=fmt,
                                                          device=dev, **kw)
            show("16.block_path", run=f"block_cg_refined_dist {fmt}, {matrix}, again",
                 outer_passes=outer2, inner_iterations=inner2,
                 same_bits_as_first=bool(np.array_equal(X, X2)))
            if (outer2, inner2) != (outer, inner) or not np.array_equal(X, X2):
                fail(f"16{tag}: a second solve took {outer2} outer passes and "
                     f"{inner2} inner iterations (first {outer}, {inner}) or "
                     "ended on other bits")
        del X, a

    d = csr_to_dia(lap_refine, row_align=ROW_ALIGN, dtype=np.float64, symmetric=True,
                   device=dev)
    B = np.random.default_rng(161).standard_normal((lap_refine.nrows, NRHS))
    data = d.data.unsqueeze(0)
    block_check(max_abs, "16", "dia_sym_spmm",
                f"laplace2d {REFINE_NX}^2, block_cg_dia's symmetric packing", "float64",
                NRHS, lambda v: spmm_dia_cuda.spmm_dia_stacked(data, v, d.offsets, True),
                lambda v: spmm_dia_stacked_plain(data, v, d.offsets, True),
                lambda v: spmv_dia_cuda.spmv_dia_stacked(data, v, d.offsets, True),
                (lanes_block(gen, data.shape[1], NRHS, torch.float64, dev),),
                TOL_KERNEL["float64"], ndiags=len(d.offsets))
    del data
    reset_counters()
    t0 = time.perf_counter()
    X, res = block_cg_dia(d, B, kmax=20000, rtol=1e-10)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got, singles = block_launches(), single_launches()
    X = X.cpu().numpy()
    rel = true_rels(lap_refine, X[: lap_refine.nrows], B)
    show("16.block_path", run=f"block_cg_dia symmetric float64, laplace2d {REFINE_NX}^2",
         rows=lap_refine.nrows, nrhs=NRHS, rtol=1e-10, iterations=res.iterations,
         converged=res.converged, true_rel_residuals=rel.tolist(),
         max_true_rel_residual=float(rel.max()), gate=1e-9, launches=got,
         seconds=seconds, it_per_s=res.iterations / seconds)
    if not (res.converged and rel.max() <= 1e-9):
        fail(f"16d: converged {res.converged}, true residual {rel.max():.3e} > 1e-9")
    if got["dia_sym_spmm"] != res.iterations + 1 or singles:
        fail(f"16d: {got['dia_sym_spmm']} dia_sym_spmm launches for "
             f"{res.iterations + 1} block applies ({singles} single-RHS launches)")
    for key in totals:
        totals[key] += got[key]
    show("16.block_path", launches=totals)
    return totals, circuit_ops


def phase_block_halo(dev):
    """Phase 17: the block halo on D=4 stacked shards, nrhs 3: matmat per
    column vs the host oracle (TOL_ORACLE, as phases 5 and 9) on the 512^2
    Laplacian (dia vanilla and symmetric, ell symmetric) and the RCM'd 50k
    FEM (well vanilla and symmetric), fp32 and fp64; matmat_ds per column
    vs the host float64 oracle (DS_ORACLE_TOL, as phase 14) for dia_ds and
    well_ds; then a 20-iteration block_cg on the D=4 fp64 dia operator,
    each column's host residual within TOL_SOLVE of the reported one."""
    rng = np.random.default_rng(17)
    lap = create_laplace_2d(HALO_NX, HALO_NX)
    fem, _ = rcm_reorder(fem_p1_2d(HALO_FEM, seed=3, dtype=np.float64), keep_best=True)
    for a, fmt, sym in ((lap, "dia", False), (lap, "dia", True), (lap, "ell", True),
                        (fem, "well", False), (fem, "well", True)):
        for dt in (np.float32, np.float64):
            dname = np.dtype(dt).name
            tag = f"{fmt} {'symmetric' if sym else 'vanilla'} {dname}"
            A = build_dist_matrix(a, n_devices=HALO_D, symmetric=sym, dtype=dt,
                                  local_format=fmt, device=dev)
            X = rng.standard_normal((a.nrows, 3)).astype(dt)
            xb = A.to_dist_block(X)
            Y = A.from_dist_block(same_bits(f"17: matmat {tag}", lambda: A.matmat(xb)))
            errs = [rel_l2(Y[:, c], a.matvec(X[:, c].astype(np.float64)))
                    for c in range(3)]
            show("17.halo", run=tag, rows=a.nrows, shards=HALO_D,
                 rounds=list(A.plan.rounds), nrhs=3, matmat_rel_l2_vs_host=errs,
                 matmat_same_bits_twice=True)
            if not max(errs) <= TOL_ORACLE[dname]:
                fail(f"17: matmat {tag} rel err {max(errs):.3e}")
    for a, fmt in ((perturbed(lap, 170), "dia_ds"), (fem, "well_ds")):
        A = build_dist_matrix(a, n_devices=HALO_D, local_format=fmt, device=dev)
        X = rng.standard_normal((a.nrows, 3)) * 1e3
        xs = [A.to_dist_block(p) for p in ds_from_f64(X)]
        yh, yl = same_bits(f"17: matmat_ds {fmt}", lambda: A.matmat_ds(*xs))
        Y = ds_to_f64(A.from_dist_block(yh), A.from_dist_block(yl))
        errs = [rel_l2(Y[:, c], a.matvec(X[:, c])) for c in range(3)]
        show("17.halo", run=f"{fmt} vanilla", rows=a.nrows, shards=HALO_D,
             rounds=list(A.plan.rounds), nrhs=3, matmat_ds_rel_l2_vs_host=errs,
             matmat_ds_same_bits_twice=True)
        if not max(errs) <= DS_ORACLE_TOL:
            fail(f"17: matmat_ds {fmt} rel err {max(errs):.3e}")
    A = build_dist_matrix(lap, n_devices=HALO_D, dtype=np.float64, local_format="dia",
                          device=dev)
    B = rng.standard_normal((lap.nrows, 3))
    res = block_cg(A.matmat, A.to_dist_block(B), 3, kmax=20, rtol=1e-30)
    host = true_rels(lap, A.from_dist_block(res.x), B)
    rep = (res.rnorm / res.rnorm0).cpu().numpy()
    show("17.block_cg", run=f"block_cg dia float64, laplace2d {HALO_NX}^2, D={HALO_D}",
         iterations=res.iterations, host_rel_residuals=host.tolist(),
         reported_rel_residuals=rep.tolist())
    if res.iterations != 20 or not np.all(np.abs(host - rep) <= TOL_SOLVE["float64"]):
        fail(f"17: block_cg host residuals {host} vs reported {rep} after "
             f"{res.iterations}")


def phase_block_timing(a_lap, d32, a4, w4, w4ds, single_ms, circuit_ops, dev):
    """Phase 10, block kernels at nrhs = NRHS: kernel and plain ms in
    turns (CUDA events, chained), the bytes bound, the library yardstick
    (one torch CSR @ X on an (n, NRHS) block, cuSPARSE SpMM, row-major and
    column-major, the faster as ``library_ms``; float64 for the DS
    kernels; the port never calls it) and NRHS x the single-RHS kernel's
    ms at the same shape from this run. Then each block kernel at nrhs 1
    and its single-RHS kernel on the same column, in turns. DIA on the
    NX^2 Laplacian scaled by 1/9, WELL and DS WELL on the 4M bench matrix,
    and, as another shape of the two WELL rows, on the local stacks of
    phase 16c's circuit operators: device time (torch.profiler) for
    kernel, plain version and cuSPARSE, the chained time beside it."""
    gen = torch.Generator(device=dev).manual_seed(100)
    out = {}

    def row(kname, kernel, plain, single_kernel, x0, x1, nbytes, a_lib, scale,
            lib_dtype, single, **extra):
        ms_k, ms_p, runs_k, runs_p = time_in_turns(kernel, plain, x0, iters_p=10)
        lib = library_block_ms(a_lib, dev, scale, lib_dtype, NRHS)
        ms_1, ms_s, runs_1, runs_s = time_in_turns(kernel, single_kernel, x1, iters_p=100)
        out[kname] = dict(ms=ms_k, plain_ms=ms_p,
                          library_ms=min(lib["row_major"], lib["column_major"]),
                          bound_ms=bound_ms(nbytes), bytes=nbytes, nrhs=NRHS,
                          single_rhs_x8_ms=NRHS * single,
                          nrhs1=dict(ms=ms_1, single_rhs_ms=ms_s))
        show("10.timing", kernel=kname, **out[kname], ms_runs=runs_k,
             plain_ms_runs=runs_p, single_rhs_ms=single, **extra,
             library=f"torch CSR @ X, ({a_lib.ncols}, {NRHS}) block (cuSPARSE SpMM)",
             library_block_ms=lib, nrhs1_ms_runs=runs_1, nrhs1_single_rhs_ms_runs=runs_s)

    # the NX^2 Laplacian scaled by 1/9 (phase 6's operator), fp32
    nr, k0 = d32.data.shape[0], d32.offsets.index(0)
    npad = d32.nrows_pad
    data9 = (d32.data * np.float32(1.0 / 9.0)).unsqueeze(0)
    lower9 = data9.view(nr, d32.ndiags, 128)[:, : k0 + 1].reshape(1, nr, -1).contiguous()
    for kname, data, offs, sym in (("dia_spmm", data9, d32.offsets, False),
                                   ("dia_sym_spmm", lower9, d32.offsets[: k0 + 1], True)):
        row(kname, lambda v: spmm_dia_cuda.spmm_dia_stacked(data, v, offs, sym),
            lambda v: spmm_dia_stacked_plain(data, v, offs, sym),
            lambda v: spmv_dia_cuda.spmv_dia_stacked(data, v, offs, sym),
            lanes_block(gen, nr, NRHS, torch.float32, dev),
            lanes_block(gen, nr, 1, torch.float32, dev),
            (len(offs) + 2 * NRHS) * npad * 4, a_lap, 1.0 / 9.0, np.float32,
            single_ms["dia_sym_spmv" if sym else "dia_spmv"], rows=a_lap.nrows,
            ndiags=len(offs))
    # dia_spmm on float64 storage, another shape of its row
    data64 = data9.double()
    x64 = lanes_block(gen, nr, NRHS, torch.float64, dev)
    ms_k, ms_p, runs_k, runs_p = time_in_turns(
        lambda v: spmm_dia_cuda.spmm_dia_stacked(data64, v, d32.offsets, False),
        lambda v: spmm_dia_stacked_plain(data64, v, d32.offsets, False), x64, iters_p=10)
    lib = library_block_ms(a_lap, dev, 1.0 / 9.0, np.float64, NRHS)
    nbytes = (d32.ndiags + 2 * NRHS) * npad * 8
    shape = dict(ms=ms_k, plain_ms=ms_p, library_ms=min(lib["row_major"], lib["column_major"]),
                 bound_ms=bound_ms(nbytes), bytes=nbytes, nrhs=NRHS, dtype="float64",
                 device_ms=device_ms(lambda v: spmm_dia_cuda.spmm_dia_stacked(
                     data64, v, d32.offsets, False), x64))
    out["dia_spmm"]["other_shapes"] = {f"float64 laplace2d {NX}^2 nrhs {NRHS}": shape}
    show("10.timing", kernel="dia_spmm", matrix=f"laplace2d {NX}^2", **shape,
         ms_runs=runs_k, plain_ms_runs=runs_p, library_block_ms=lib,
         **plan_fields(data64, d32.offsets, False, NRHS))
    del data64, x64
    matrix, shape = sym_block_timing(gen, dev)
    out["dia_sym_spmm"]["other_shapes"] = {matrix: shape}
    # its double-single planes: the exact float64 values / 9 split on the card
    v9 = d32.data.double() / 9.0
    planes = (v9.float().unsqueeze(0), (v9 - v9.float().double()).float().unsqueeze(0))
    del v9, data9, lower9
    row("dia_ds_spmm",
        lambda v: spmv_dia_ds_cuda.spmm_dia_ds_stacked(*planes, *v, d32.offsets),
        lambda v: spmm_dia_ds_stacked_plain(*planes, *v, d32.offsets),
        lambda v: spmv_dia_ds_cuda.spmv_dia_ds_stacked(*planes, *v, d32.offsets),
        ds_block(gen, nr, NRHS, dev), ds_block(gen, nr, 1, dev),
        (2 * d32.ndiags + 4 * NRHS) * npad * 4, a_lap, 1.0 / 9.0, np.float64,
        single_ms["dia_ds_spmv"], rows=a_lap.nrows, ndiags=d32.ndiags)
    del planes
    def lists_bytes(rows_, nnz, value_bytes, nrows, ncols, planes):
        """The bound's bytes of a row-list block apply: the stored
        nonzeros' values and pos, w0 and slice_ptr once, X and Y (``planes``
        float32 planes of NRHS columns, or float64 ones) once."""
        pos, ptr, w0 = rows_[-3:]
        return (nnz * (value_bytes + pos.element_size()) + w0.numel() * 4
                + ptr.numel() * 8 + NRHS * (ncols + nrows) * planes)

    # the 4M bench matrix (rows scaled to ||A||_inf = 0.9 in phase 7)
    rows4, drows4 = rows_args(w4), rows_args(w4ds)
    rows = w4.ncols_pad // 128
    row("well_spmm", lambda v: spmm_well_cuda.spmm_well_stacked(*rows4, v, 64),
        lambda v: spmm_well_stacked_plain(*rows4, v, 64),
        lambda v: spmv_well_cuda.spmv_well_stacked(*rows4, v, 64),
        lanes_block(gen, rows, NRHS, torch.float32, dev),
        lanes_block(gen, rows, 1, torch.float32, dev),
        lists_bytes(rows4, a4.nnz, 4, a4.nrows, a4.ncols, 4), a4, 1.0, np.float32,
        single_ms["spmv_well"], matrix=f"bench {N_WELL}", **rows_stats(rows4[-2], a4.nnz))
    row("well_ds_spmm", lambda v: spmm_well_cuda.spmm_well_ds_stacked(*drows4, *v, 64),
        lambda v: spmm_well_ds_stacked_plain(*drows4, *v, 64),
        lambda v: spmv_well_ds_cuda.spmv_well_ds_stacked(*drows4, *v, 64),
        ds_block(gen, rows, NRHS, dev), ds_block(gen, rows, 1, dev),
        lists_bytes(drows4, a4.nnz, 8, a4.nrows, a4.ncols, 8), a4, 1.0, np.float64,
        single_ms["well_ds_spmv"], matrix=f"bench {N_WELL}",
        **rows_stats(drows4[-2], a4.nnz))

    # phase 16c's circuit operators: their local stacks (the near block of
    # the window split; the far remainder is a separate gather), scaled so
    # ||near||_inf = 0.9 and chained applies stay bounded
    a_c, a32, ads = circuit_ops
    tg = a32.well_meta[2]
    near, _ = split_window(a_c, tile_groups=tg, wseg_cap=WELL_WSEG_CAP)
    row_sums = np.bincount(np.repeat(np.arange(near.nrows), near.row_nnz()),
                           weights=np.abs(near.values), minlength=near.nrows)
    scale = float(0.9 / row_sums.max())
    crows, cdrows = dist_rows(a32), dist_rows(ads)
    crows = (crows[0] * scale, *crows[1:])
    cdrows = (cdrows[0] * scale, cdrows[1] * scale, *cdrows[2:])
    nrows_c = a32.n_devices * a32.row_lane_rows
    tag = f"circuit_network({CIRCUIT_BLOCK_NX}) RCM, block_cg_refined_dist's stack"
    for kname, kernel, plain, x0, nbytes, lib_dtype in (
            ("well_spmm", lambda v: spmm_well_cuda.spmm_well_stacked(*crows, v, tg),
             lambda v: spmm_well_stacked_plain(*crows, v, tg),
             lanes_block(gen, nrows_c, NRHS, torch.float32, dev),
             lists_bytes(crows, near.nnz, 4, near.nrows, near.ncols, 4), np.float32),
            ("well_ds_spmm",
             lambda v: spmm_well_cuda.spmm_well_ds_stacked(*cdrows, *v, tg),
             lambda v: spmm_well_ds_stacked_plain(*cdrows, *v, tg),
             ds_block(gen, nrows_c, NRHS, dev),
             lists_bytes(cdrows, near.nnz, 8, near.nrows, near.ncols, 8), np.float64)):
        chained_k, chained_p, runs_k, runs_p = time_in_turns(kernel, plain, x0, iters_p=5)
        lib = library_block_ms(near, dev, scale, lib_dtype, NRHS, timer=yardstick_ms)
        lib_chained = library_block_ms(near, dev, scale, lib_dtype, NRHS)
        shape = dict(ms=device_ms(kernel, x0), plain_ms=yardstick_ms(plain, x0, 5),
                     library_ms=min(lib["row_major"], lib["column_major"]),
                     bound_ms=bound_ms(nbytes), bytes=nbytes, nrhs=NRHS,
                     timing="device", chained_ms=chained_k, plain_chained_ms=chained_p,
                     library_chained_ms=min(lib_chained["row_major"],
                                            lib_chained["column_major"]))
        cptr = (a32 if kname == "well_spmm" else ads).local_rows_ptr
        show("10.timing", kernel=kname, matrix=tag, **shape, ms_runs=runs_k,
             plain_ms_runs=runs_p, rows=near.nrows, near_nnz=near.nnz,
             **rows_stats(cptr, near.nnz),
             well_slots=(a32 if kname == "well_spmm" else ads).local_well_values.numel(),
             library=f"torch CSR @ X, ({near.ncols}, {NRHS}) block (cuSPARSE SpMM), "
                     "device time", library_block_ms=lib,
             library_block_chained_ms=lib_chained)
        out[kname]["other_shapes"] = {tag: shape}
    return out


def sym_block_timing(gen, dev) -> tuple[str, dict]:
    """Phase 10: dia_sym_spmm where the main path runs it, float64 at
    REFINE_NX^2 and nrhs NRHS (phase 16d's block_cg_dia), on the Laplacian
    scaled by 1/9: device time of kernel and plain version, the chained
    time beside, cuSPARSE SpMM on the same block (device time), the bytes
    bound. Returns (matrix, row)."""
    a = create_laplace_2d(REFINE_NX, REFINE_NX)
    d = csr_to_dia(a, row_align=ROW_ALIGN, dtype=np.float64, symmetric=True, device=dev)
    data = (d.data / 9.0).unsqueeze(0)
    xs = lanes_block(gen, data.shape[1], NRHS, torch.float64, dev)

    def kernel(v):
        return spmm_dia_cuda.spmm_dia_stacked(data, v, d.offsets, True)

    def plain(v):
        return spmm_dia_stacked_plain(data, v, d.offsets, True)

    chained_k, chained_p, runs_k, runs_p = time_in_turns(kernel, plain, xs, iters_p=10)
    lib = library_block_ms(a, dev, 1.0 / 9.0, np.float64, NRHS, timer=yardstick_ms)
    nbytes = (len(d.offsets) + 2 * NRHS) * d.nrows_pad * 8
    row = dict(ms=device_ms(kernel, xs), plain_ms=yardstick_ms(plain, xs, 5),
               library_ms=min(lib["row_major"], lib["column_major"]),
               bound_ms=bound_ms(nbytes), bytes=nbytes, nrhs=NRHS, dtype="float64",
               timing="device", chained_ms=chained_k, plain_chained_ms=chained_p)
    matrix = f"float64 laplace2d {REFINE_NX}^2 nrhs {NRHS}, block_cg_dia's packing"
    show("10.timing", kernel="dia_sym_spmm", matrix=matrix, **row, ms_runs=runs_k,
         plain_ms_runs=runs_p, library_block_ms=lib, rows=a.nrows, ndiags=len(d.offsets),
         library=f"torch CSR @ X, ({a.ncols}, {NRHS}) float64 block (cuSPARSE SpMM), "
                 "device time", **plan_fields(data, d.offsets, True, NRHS))
    return matrix, row


def amg_cycle_applies(h) -> list[int]:
    """Level-operator applies of one preconditioner apply, per level, from
    the cycle's structure: a visit smooths with ``degree`` applies before
    and ``degree`` + 1 after (the post-smoother starts from x), and each of
    its ``cycle`` coarse corrections takes one residual apply plus, where
    the level smooths its transfers implicitly (omega_p), one apply in the
    restriction and one in the prolongation; level l is visited cycle**l
    times. The headline W-cycle: 11 applies a visit, visits 1, 2, 4."""
    out = []
    for lvl_i, lvl in enumerate(h.levels):
        per_visit = 2 * lvl.degree + 1 + h.cycle * (1 + (2 if lvl.omega_p else 0))
        out.append(per_visit * h.cycle ** lvl_i)
    return out


def amg_levels(h) -> list:
    """Each level's rows, format, stored diagonals and transfer mode."""
    return [dict(level=i, rows=lvl.A.nrows_global, format=lvl.A.local_format,
                 symmetric=lvl.A.symmetric, diagonals=len(lvl.A.dia_offsets),
                 stride=lvl.stride, omega_p=lvl.omega_p, lmax=lvl.lmax,
                 hub_nnz=lvl.A.hub_nnz,
                 P=None if lvl.P is None else [lvl.P.nrows_global, lvl.P.ncols_global,
                                                lvl.P.hub_nnz],
                 R=None if lvl.R is None else [lvl.R.nrows_global, lvl.R.ncols_global,
                                                lvl.R.hub_nnz])
            for i, lvl in enumerate(h.levels)] + [dict(
                level=len(h.levels), rows=h.coarse_A.nrows_global, coarse=True,
                format=h.coarse_A.local_format, hub_nnz=h.coarse_A.hub_nnz,
                dense_inverse=None if h.coarse_inv is None else list(h.coarse_inv.shape))]


def amg_level_checks(phase, h, tag, gen, dev, max_abs) -> None:
    """Every DIA level operator's kernel vs its plain version on that
    level's own stack (TOL_KERNEL float32), on a random lane-layout vector;
    these launches come before the counters are zeroed."""
    for i, lvl in enumerate(h.levels):
        A = lvl.A
        if A.local_format != "dia":
            continue
        kname = "dia_sym_spmv" if A.symmetric else "dia_spmv"
        x2 = torch.randn((A.n_devices * A.row_lane_rows, 128), generator=gen,
                         dtype=torch.float32, device=dev)
        _, err, mabs, _ = compare(f"{phase} {tag} level {i}", A.local_dia_data, x2,
                               A.dia_offsets, A.symmetric, TOL_KERNEL["float32"])
        max_abs[kname] = max(max_abs[kname], mabs)
        show(f"{phase}.kernel", kernel=kname, matrix=f"{tag}, AMG level {i}",
             rows=A.nrows_global, shards=A.n_devices, ndiags=len(A.dia_offsets),
             rel_l2_vs_plain=err, max_abs_vs_plain=mabs,
             **plan_fields(A.local_dia_data, A.dia_offsets, A.symmetric, 1))


def amg_pcg(A, b, h, kmax=200, rtol=1e-6):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cg(A.as_linear_operator(), b, kmax=kmax, rtol=rtol,
             preconditioner=h.as_preconditioner())
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def amg_launch_gate(phase, tag, h, res, got: dict) -> dict:
    """The exact DIA launches of a PCG solve of res.iterations iterations:
    (k+1) preconditioner applies of ``amg_cycle_applies`` each and (k+1)
    outer applies, counted on the kernel each level's operator runs; no
    other kernel may launch."""
    k1 = res.iterations + 1
    want = {"dia": 0, "dia_sym": 0}
    outer_key = "dia_sym" if h.levels[0].A.symmetric else "dia"
    want[outer_key] += k1
    for lvl, n in zip(h.levels, amg_cycle_applies(h)):
        if lvl.A.local_format != "dia" or lvl.P is not None:
            fail(f"{phase} {tag}: level of format {lvl.A.local_format} has no "
                 "DIA launch count")
        want["dia_sym" if lvl.A.symmetric else "dia"] += k1 * n
    others = single_launches() - got["dia"] - got["dia_sym"] + sum(block_launches().values())
    if {k: got[k] for k in want} != want or others:
        fail(f"{phase} {tag}: launches {got} ({others} of other kernels), want "
             f"{want} for {res.iterations} iterations")
    return want


def phase_amg(a, plain_solves, dev, max_abs):
    """Phase 18: AMG-preconditioned CG, the reference bench's headline
    solver (bench.py:197-231).

    (a) On phase 4's 3200^2 CSR: the fp32 vanilla dia operator,
        amg_setup(interval2d, interval_size 4, W-cycle, dia levels), then
        PCG to rtol 1e-6 (kmax 200) three times; gates: converged in at
        most AMG_ITERS_GATE iterations, each solve's DIA launches exactly
        (k+1)(1 + sum of amg_cycle_applies) with no other kernel, every
        level's kernel vs its plain version; printed: the levels, setup
        seconds and their split, the median solve beside phase 4's plain
        fp32 CG on the same operator, the true float64 residual and the
        fp32 floor estimate (bench.py:224-234).
    (b) 1024^2, the symmetric fp32 operator (level 0 runs dia_sym_spmv),
        beside the vanilla one: iterations within 1, exact launches.
    (c) cg_refined_dist(amg=...) at 1024^2 to rtol 1e-9: true residual
        below REFINE_TOL (__graft_entry__.py:455-470).
    (d) D=4 stacked shards: interval2d at 512^2, counts within 1 of D=1;
        the default smoothed aggregation on the RCM'd fem_p1_2d(HALO_FEM),
        whose transfers are rectangular ELL operators and whose coarse
        operators split hub rows, converged, beside Jacobi-PCG's count;
        one cycle apply twice with the same bits, on both hierarchies.
    (e) block_cg_refined_dist(inner_solver="chebyshev") at CHEB_NX^2 x
        NRHS: every column's true residual below CHEB_TOL, dia_spmm
        launches = inner applies, dia_ds_spmm = outer residuals, 48
        dia_spmv for the Lanczos bounds.
    Returns (DIA launch counts of the (a)-(e) solves, summed, and the
    hierarchies the timing of 18f reads)."""
    gen = torch.Generator(device=dev).manual_seed(18)
    totals = {"dia": 0, "dia_sym": 0, "dia_spmm": 0, "dia_ds_spmm": 0}

    # (a) the headline
    t0 = time.perf_counter()
    A = build_dist_matrix(a, n_devices=1, dtype=np.float32, local_format="dia",
                          device=dev)
    b_host = gaussian_bump(a.nrows, dtype=np.float32)
    b = A.to_dist(b_host)
    t_asm = time.perf_counter() - t0
    split = {}
    t0 = time.perf_counter()
    h = amg_setup(a, A, timings=split, **AMG_KW)
    setup_s = time.perf_counter() - t0
    show("18a.amg_setup", matrix=f"laplace2d {NX}^2", rows=a.nrows, **AMG_KW,
         levels=amg_levels(h), n_levels=h.n_levels,
         grid_complexity=h.grid_complexity(), setup_s=setup_s, setup_split_s=split,
         assemble_s=t_asm, applies_per_cycle=amg_cycle_applies(h))
    amg_level_checks("18a", h, f"laplace2d {NX}^2", gen, dev, max_abs)
    runs, first = [], None
    for _ in range(3):
        reset_counters()
        res, seconds = amg_pcg(A, b, h)
        got = launched("dia", "dia_sym")
        amg_launch_gate("18a", f"laplace2d {NX}^2", h, res, got)
        first = first or got
        runs.append((seconds, res))
    seconds = sorted(t for t, _ in runs)[1]
    res = runs[-1][1]
    x = A.from_dist(res.x).astype(np.float64)
    bh = b_host.astype(np.float64)
    bn = float(np.linalg.norm(bh))
    plain_its, plain_s = plain_solves["vanilla float32"]
    show("18a.amg_pcg", matrix=f"laplace2d {NX}^2", rtol=1e-6, kmax=200,
         iterations=res.iterations, iterations_runs=[r.iterations for _, r in runs],
         converged=res.converged, gate=AMG_ITERS_GATE, solve_s=seconds,
         solve_s_runs=[t for t, _ in runs], ms_per_iteration=1e3 * seconds / res.iterations,
         plain_cg_iterations=plain_its, plain_cg_solve_s=plain_s,
         speedup_vs_plain_cg=plain_s / seconds,
         reported_rel_residual=float(res.rnorm) / float(res.rnorm0),
         true_rel_residual=float(np.linalg.norm(bh - a.matvec(x)) / bn),
         fp32_true_residual_floor_est=float(1.2e-7 * np.abs(x).max()
                                            * np.sqrt(a.nrows) / bn),
         launches=first, dia_launches_per_iteration=sum(amg_cycle_applies(h)) + 1)
    if not (res.converged and res.iterations <= AMG_ITERS_GATE):
        fail(f"18a: AMG-PCG converged {res.converged} in {res.iterations} "
             f"iterations (gate {AMG_ITERS_GATE})")
    for key in ("dia", "dia_sym"):
        totals[key] += first[key]
    head = (A, h)
    del x

    # (b) symmetric storage at 1024^2, beside vanilla
    a1k = create_laplace_2d(AMG_SYM_NX, AMG_SYM_NX)
    its = {}
    for sym in (True, False):
        tag = f"laplace2d {AMG_SYM_NX}^2 {'symmetric' if sym else 'vanilla'} float32"
        A1 = build_dist_matrix(a1k, n_devices=1, symmetric=sym, dtype=np.float32,
                               local_format="dia", device=dev)
        t0 = time.perf_counter()
        h1 = amg_setup(a1k, A1, **AMG_KW)
        t_setup = time.perf_counter() - t0
        amg_level_checks("18b", h1, tag, gen, dev, max_abs)
        reset_counters()
        r1, s1 = amg_pcg(A1, A1.to_dist(gaussian_bump(a1k.nrows, dtype=np.float32)), h1)
        got = launched("dia", "dia_sym")
        amg_launch_gate("18b", tag, h1, r1, got)
        for key in ("dia", "dia_sym"):
            totals[key] += got[key]
        its[sym] = r1.iterations
        show("18b.amg_pcg", run=tag, levels=amg_levels(h1), setup_s=t_setup,
             iterations=r1.iterations, converged=r1.converged, solve_s=s1, launches=got)
        if not r1.converged:
            fail(f"18b: {tag} did not converge")
        del A1, h1
    if abs(its[True] - its[False]) > 1:
        fail(f"18b: symmetric {its[True]} vs vanilla {its[False]} iterations")

    # (c) mixed-precision refinement with AMG-preconditioned inner solves
    b64 = gaussian_bump(a1k.nrows)
    reset_counters()
    t0 = time.perf_counter()
    ref = cg_refined_dist(a1k, b64, amg=dict(AMG_KW), rtol=1e-9, inner_kmax=200,
                          device=dev)
    t_ref = time.perf_counter() - t0
    got = launched("dia", "dia_sym")
    rel = true_rel(a1k, ref.x, b64)
    show("18c.refine_amg", matrix=f"laplace2d {AMG_SYM_NX}^2", rtol=1e-9,
         inner_kmax=200, outer=ref.outer_iterations, inner=ref.inner_iterations,
         converged=ref.converged, history=ref.history, true_rel_residual=rel,
         gate=REFINE_TOL, seconds=t_ref, launches=got,
         dia_ds_launches=_build.launches["dia_ds"])
    if not rel < REFINE_TOL:
        fail(f"18c: refined AMG true residual {rel:.3e} >= {REFINE_TOL:.0e}")
    for key in ("dia", "dia_sym"):
        totals[key] += got[key]

    # (d) D=4 stacked shards
    a512 = create_laplace_2d(AMG_D4_NX, AMG_D4_NX)
    b512 = gaussian_bump(a512.nrows, dtype=np.float32)
    its = {}
    for nd in (1, 4):
        A4 = build_dist_matrix(a512, n_devices=nd, dtype=np.float32, local_format="dia",
                               device=dev)
        h4 = amg_setup(a512, A4, **AMG_KW)
        amg_level_checks("18d", h4, f"laplace2d {AMG_D4_NX}^2 D={nd}", gen, dev, max_abs)
        reset_counters()
        r4, s4 = amg_pcg(A4, A4.to_dist(b512), h4)
        got = launched("dia", "dia_sym")
        amg_launch_gate("18d", f"laplace2d {AMG_D4_NX}^2 D={nd}", h4, r4, got)
        its[nd] = r4.iterations
        x4 = A4.from_dist(r4.x).astype(np.float64)
        show("18d.amg_pcg", matrix=f"laplace2d {AMG_D4_NX}^2", shards=nd,
             levels=amg_levels(h4), iterations=r4.iterations, converged=r4.converged,
             solve_s=s4, true_rel_residual=true_rel(a512, x4, b512.astype(np.float64)),
             launches=got)
        if not r4.converged:
            fail(f"18d: interval2d at D={nd} did not converge")
        if nd == 4:
            v = A4.to_dist(b512)
            same_bits(f"18d interval2d D=4 cycle", lambda: h4.as_preconditioner()(v))
        del A4, h4
    if abs(its[4] - its[1]) > 1:
        fail(f"18d: interval2d iterations D=4 {its[4]} vs D=1 {its[1]}")

    t0 = time.perf_counter()
    fem, _ = rcm_reorder(fem_p1_2d(HALO_FEM), keep_best=True)
    Af = build_dist_matrix(fem, n_devices=4, dtype=np.float32, device=dev)
    bf = Af.to_dist(gaussian_bump(fem.nrows, dtype=np.float32))
    hf = amg_setup(fem, Af)
    t_setup = time.perf_counter() - t0
    rect = [lvl for lvl in hf.levels if lvl.P is not None
            and lvl.P.ncols_global < lvl.P.nrows_global]
    hubs = sum(op.hub_nnz for lvl in hf.levels for op in (lvl.A, lvl.P, lvl.R)
               if op is not None) + hf.coarse_A.hub_nnz
    rf, sf = amg_pcg(Af, bf, hf, kmax=1000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rj = cg(Af.as_linear_operator(), bf, kmax=5000, rtol=1e-6,
            preconditioner=Af.jacobi_preconditioner())
    torch.cuda.synchronize()
    sj = time.perf_counter() - t0
    xf = Af.from_dist(rf.x).astype(np.float64)
    fb = Af.from_dist(bf).astype(np.float64)
    show("18d.amg_pcg", matrix=f"fem_p1_2d({HALO_FEM}) RCM", shards=4,
         aggregate="match (smoothed, the default)", levels=amg_levels(hf),
         setup_s=t_setup, rectangular_transfers=len(rect), hub_nnz=hubs,
         iterations=rf.iterations, converged=rf.converged, solve_s=sf,
         true_rel_residual=true_rel(fem, xf, fb), jacobi_pcg_iterations=rj.iterations,
         jacobi_pcg_converged=rj.converged, jacobi_pcg_s=sj)
    if not rf.converged or not rect or not hubs:
        fail(f"18d: FEM smoothed aggregation converged {rf.converged}, "
             f"{len(rect)} rectangular transfers, {hubs} hub entries")
    same_bits("18d FEM smoothed-aggregation cycle (D=4)",
              lambda: hf.as_preconditioner()(bf))
    del Af, hf, fem

    # (e) the refined block solve with the Chebyshev inner solver
    ac = create_laplace_2d(CHEB_NX, CHEB_NX)
    B = np.random.default_rng(180).standard_normal((ac.nrows, NRHS))
    kw = dict(inner_rtol=1e-4, inner_kmax=2000, inner_solver="chebyshev")
    path_stack_checks(ac, "dia", f"laplace2d {CHEB_NX}^2 (18e)", gen, dev, max_abs)
    reset_counters()
    t0 = time.perf_counter()
    X, outer, inner, rnorms = block_cg_refined_dist(ac, B, device=dev, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = block_launches()
    lanczos = launched("dia", "dia_sym")
    rel = true_rels(ac, X, B)
    show("18e.block_chebyshev", matrix=f"laplace2d {CHEB_NX}^2", nrhs=NRHS, **kw,
         outer_passes=outer, inner_iterations=inner, true_rel_residuals=rel.tolist(),
         max_true_rel_residual=float(rel.max()), gate=CHEB_TOL, launches=got,
         lanczos_dia_launches=lanczos, seconds=seconds)
    if not rel.max() < CHEB_TOL:
        fail(f"18e: a column's true residual is {rel.max():.3e} >= {CHEB_TOL:.0e}")
    if (got["dia_spmm"] != inner or got["dia_ds_spmm"] != outer
            or lanczos != {"dia": 48, "dia_sym": 0}):
        fail(f"18e: {got} block launches, {lanczos} single-RHS, for {inner} inner "
             f"applies, {outer} residuals and a 48-step Lanczos run")
    totals["dia"] += lanczos["dia"]
    totals["dia_spmm"] += got["dia_spmm"]
    totals["dia_ds_spmm"] += got["dia_ds_spmm"]
    show("18.amg", launches=totals)
    return totals, head



# --------------------------------------------------------------------------
# phase 19: the general Krylov path and the transpose operator
# --------------------------------------------------------------------------

def convection_diffusion_2d(g: int, cx: float = 12.0, cy: float = 8.0) -> CSRHost:
    """Upwind convection-diffusion on a g x g grid, the non-symmetric test
    operator of the reference's SPAI tests (``tests/test_spai.py``),
    vectorized: the 5-point pattern, constant diagonal 4 + (cx + cy) h, the
    upwind west and south neighbours -1 - c h, the east and north -1. Its
    transpose differs from it, so a shift in the wrong direction shows."""
    n = g * g
    h = 1.0 / (g + 1)
    i = np.arange(n, dtype=np.int64)
    ix, iy = i % g, i // g
    parts = [(i, i, np.full(n, 4.0 + (cx + cy) * h))]
    for ok, j, v in ((ix > 0, i - 1, -1.0 - cx * h), (ix < g - 1, i + 1, -1.0),
                     (iy > 0, i - g, -1.0 - cy * h), (iy < g - 1, i + g, -1.0)):
        parts.append((i[ok], j[ok], np.full(int(ok.sum()), v)))
    rows, cols, vals = (np.concatenate(p) for p in zip(*parts))
    return CSRHost.from_coo(rows, cols, vals, n, n)


def row_scaled(a: CSRHost, seed: int) -> CSRHost:
    """a with every row scaled by a factor in [0.5, 1.5): the same pattern
    (and hub rows), non-symmetric values."""
    s = np.random.default_rng(seed).uniform(0.5, 1.5, a.nrows)
    return CSRHost(a.rowptr, a.colind,
                   (a.values * np.repeat(s, a.row_nnz())).astype(a.values.dtype), a.ncols)


SCATTER_ADDS = ((torch.Tensor, "index_add_"), (torch.Tensor, "index_add"),
                (torch.Tensor, "scatter_add_"), (torch.Tensor, "scatter_add"),
                (torch, "index_add"), (torch, "scatter_add"))


@contextlib.contextmanager
def no_scatter_add(tag: str):
    """Every torch scatter-add (they sum with atomics on the card) fails the
    run while the block is inside."""
    saved = [(owner, name, getattr(owner, name)) for owner, name in SCATTER_ADDS]

    def refuse(*args, **kwargs):
        fail(f"{tag}: an apply called a scatter-add")

    for owner, name, _ in saved:
        setattr(owner, name, refuse)
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def kernel_of(A) -> str | None:
    """The single-RHS launch counter a vanilla operator's apply moves."""
    return {"dia": "dia", "well": "well"}.get(A.local_format)


def launch_counts() -> dict:
    return launched("dia", "dia_sym", "well")


def add_counts(totals: dict, got: dict) -> None:
    for key, n in got.items():
        totals[key] = totals.get(key, 0) + n


def other_launches(got: dict) -> int:
    """Launches of every kernel outside ``got``'s keys."""
    return (single_launches() - sum(got.values()) + sum(block_launches().values()))


def transpose_checks(tag, A, gen, max_abs) -> None:
    """The kernels the transpose of A launches vs their plain versions at
    the shapes they run: the shifted DIA data through dia_spmv, the WELL
    transpose stack's row lists through well_spmv (TOL_KERNEL)."""
    t = A._transpose_cache
    dname = str(A.dtype).removeprefix("torch.")
    x2 = torch.randn((A.n_devices * A.row_lane_rows, 128), generator=gen,
                     dtype=A.dtype, device=A.device)
    if A.local_format == "dia":
        _, err, mabs, _ = compare(f"19a {tag} transpose", t["dia_data"], x2,
                                  t["dia_offsets"], False, TOL_KERNEL[dname])
        max_abs["dia_spmv"] = max(max_abs["dia_spmv"], mabs)
        show("19a.kernel", kernel="dia_spmv", matrix=f"{tag}, A^T shifted",
             rel_l2_vs_plain=err, max_abs_vs_plain=mabs,
             **plan_fields(t["dia_data"], t["dia_offsets"], False, 1))
    elif A.local_format == "well":
        rows = (t["rows_values"], t["rows_pos"], t["rows_ptr"], t["w0"])
        y_k = spmv_well_cuda.spmv_well_stacked(*rows, x2, t["tile_groups"])
        y_p = spmv_well_rows_plain(*rows, x2, t["tile_groups"])
        _, err, mabs = check_close(f"19a {tag} transpose", y_k, y_p, TOL_KERNEL[dname])
        max_abs["spmv_well"] = max(max_abs["spmv_well"], mabs)
        show("19a.kernel", kernel="spmv_well", matrix=f"{tag}, A^T stack",
             rel_l2_vs_plain=err, max_abs_vs_plain=mabs,
             **rows_stats(t["rows_ptr"], int((t["rows_values"] != 0).sum())))


def transpose_case(tag, a, A, gen, max_abs, totals, bits_gate=False):
    """19a, one operator: matvec_transpose and transposed().matvec (each
    applied twice: the same bits, with every scatter-add refused) vs the
    host float64 A^T x, gated at TRANSPOSE_TOL of || |A^T| |x| ||_inf; the
    launches of those four applies exactly 2 on the kernel of A's format
    and 2 on At's. ``bits_gate``: the two forms must give the same bits."""
    dname = str(A.dtype).removeprefix("torch.")
    t0 = time.perf_counter()
    At = A.transposed()
    t_rebuild = time.perf_counter() - t0
    if A.transposed() is not At or At.transposed() is not A:
        fail(f"19a {tag}: transposed() is not cached")
    np_dtype = np.float64 if A.dtype == torch.float64 else np.float32
    q_host = np.random.default_rng(19).standard_normal(a.nrows).astype(np_dtype)
    q = A.to_dist(q_host, side="row")
    qt = At.to_dist(q_host)  # A^T's own layout (its format may pad otherwise)
    t0 = time.perf_counter()
    A.matvec_transpose(q)  # the first apply builds the transpose's tables
    torch.cuda.synchronize()
    t_tables = time.perf_counter() - t0
    transpose_checks(tag, A, gen, max_abs)
    torch.cuda.synchronize()
    reset_counters()
    with no_scatter_add(f"19a {tag}"):
        y = same_bits(f"19a {tag} matvec_transpose", lambda: A.matvec_transpose(q))
        y_t = same_bits(f"19a {tag} transposed().matvec", lambda: At.matvec(qt))
    torch.cuda.synchronize()
    got = launch_counts()
    want = {"dia": 0, "dia_sym": 0, "well": 0}
    for op in (A, At):
        if kernel_of(op):
            want[kernel_of(op)] += 2
    if got != want or other_launches(got):
        fail(f"19a {tag}: launches {got}, want {want}")
    add_counts(totals, got)
    at = a.transpose()
    want_y = at.matvec(q_host.astype(np.float64))
    scale = float(np.abs(CSRHost(at.rowptr, at.colind, np.abs(at.values), at.ncols)
                         .matvec(np.abs(q_host.astype(np.float64)))).max())
    errs = [float(np.abs(v.astype(np.float64) - want_y).max()) / scale
            for v in (A.from_dist(y, side="col"), At.from_dist(y_t))]
    bits = y.shape == y_t.shape and bool(torch.equal(y, y_t))
    show("19a.transpose", case=tag, rows=a.nrows, cols=a.ncols, shards=A.n_devices,
         format=A.local_format, transposed_format=At.local_format, dtype=dname,
         hub_nnz=A.hub_nnz, far_nnz=A.well_far_nnz, ghost_rounds=list(A.plan.rounds),
         err_matvec_transpose=errs[0], err_transposed=errs[1], gate=TRANSPOSE_TOL[dname],
         same_bits_both_forms=bits, transposed_rebuild_s=t_rebuild,
         transpose_tables_s=t_tables, launches=got)
    if max(errs) > TRANSPOSE_TOL[dname]:
        fail(f"19a {tag}: A^T x {max(errs):.3e} from the host (gate "
             f"{TRANSPOSE_TOL[dname]:.0e} of || |A^T| |x| ||_inf)")
    if bits_gate and not bits:
        fail(f"19a {tag}: matvec_transpose and transposed().matvec gave other bits")
    return At


def phase_transpose(dev, max_abs, totals):
    """Phase 19a: the transpose operator on non-symmetric operators. Returns
    the 3200^2 convection-diffusion CSR and its fp32 DIA operator (19e's
    LSQR reuses both, and the cached transpose)."""
    gen = torch.Generator(device=dev).manual_seed(19)
    t0 = time.perf_counter()
    a = convection_diffusion_2d(NX)
    show("19a.generate", matrix=f"convection-diffusion {NX}^2", rows=a.nrows, nnz=a.nnz,
         seconds=time.perf_counter() - t0)
    A32 = None
    for dt in (np.float32, np.float64):
        A = build_dist_matrix(a, n_devices=1, dtype=dt, local_format="dia", device=dev)
        transpose_case(f"convection-diffusion {NX}^2 {np.dtype(dt).name}", a, A, gen,
                       max_abs, totals, bits_gate=True)
        if dt == np.float32:
            A32 = A
        del A
    a512 = convection_diffusion_2d(HALO_NX)
    for fmt in ("dia", "ell"):
        for dt in (np.float32, np.float64):
            A = build_dist_matrix(a512, n_devices=HALO_D, dtype=dt, local_format=fmt,
                                  device=dev)
            transpose_case(f"convection-diffusion {HALO_NX}^2 {fmt} D={HALO_D} "
                           f"{np.dtype(dt).name}", a512, A, gen, max_abs, totals)
    fem, _ = rcm_reorder(fem_p1_2d(HALO_FEM), keep_best=True)
    fem = row_scaled(fem, 19)
    for dt in (np.float32, np.float64):
        A = build_dist_matrix(fem, n_devices=HALO_D, dtype=dt, local_format="well",
                              device=dev)
        transpose_case(f"fem_p1_2d({HALO_FEM}) RCM row-scaled well D={HALO_D} "
                       f"{np.dtype(dt).name}", fem, A, gen, max_abs, totals)
    hub = row_scaled(powerlaw_laplacian(HUB_N, seed=19), 19)
    A = build_dist_matrix(hub, n_devices=HALO_D, dtype=np.float32, local_format="ell",
                          device=dev)
    if A.hub_nnz == 0:
        fail("19a: the power-law operator split no hub rows")
    transpose_case(f"powerlaw_laplacian({HUB_N}) row-scaled ell D={HALO_D} hub rows",
                   hub, A, gen, max_abs, totals)
    return a, A32


@dataclasses.dataclass
class Restarted:
    """BiCGStab restarted from its last good iterate after each breakdown
    (``bicgstab_restarted``): the last call's result, with ``iterations``
    summed over the calls and ``calls`` the (iterations, breakdown) of
    each."""
    x: torch.Tensor
    iterations: int
    rnorm: torch.Tensor
    rnorm0: torch.Tensor
    converged: bool
    breakdown: bool
    calls: list


def bicgstab_restarted(matvec, b, kmax, rtol, preconditioner=None) -> Restarted:
    """BiCGStab to ``rtol`` of the first residual within ``kmax`` iterations
    in all, restarted from the returned iterate whenever the reference's
    relative breakdown guard (4 eps of |rhat||r|, which fires in float32 on
    the convection-diffusion operator) stops it, as its documentation
    prescribes; each restart's rtol is scaled to the first residual."""
    res = bicgstab(matvec, b, kmax=kmax, rtol=rtol, preconditioner=preconditioner)
    rnorm0, calls = res.rnorm0, [(res.iterations, res.breakdown)]
    total = res.iterations
    while res.breakdown and not res.converged and total < kmax:
        scaled = rtol * float(rnorm0) / max(float(res.rnorm), 1e-300)
        res = bicgstab(matvec, b, x0=res.x, kmax=kmax - total, rtol=scaled,
                       preconditioner=preconditioner)
        calls.append((res.iterations, res.breakdown))
        total += res.iterations
    return Restarted(x=res.x, iterations=total, rnorm=res.rnorm, rnorm0=rnorm0,
                     converged=bool(float(res.rnorm) / float(rnorm0) < rtol),
                     breakdown=res.breakdown, calls=calls)


def solve_launches(name, res, A, per_cycle: int) -> dict:
    """The exact launches of a 19b solve: the outer operator's applies on
    its kernel, each preconditioner apply ``per_cycle`` dia_spmv launches
    (the AMG cycle's level applies, every level vanilla DIA)."""
    k = res.iterations
    if name in ("gmres", "fgmres"):
        outer = 1 + k + res.cycles
        prec = k + (0 if name == "fgmres" else res.cycles)
    elif name == "bicgstab":
        # each call: its first residual, two applies an iteration, and two
        # in the iteration that broke down
        bodies = [ki + int(brk) for ki, brk in res.calls]
        outer, prec = len(bodies) + 2 * sum(bodies), 2 * sum(bodies)
    else:  # minres, cg: the first residual and one apply an iteration
        outer, prec = 1 + k, 1 + k
    want = {"dia": prec * per_cycle, "dia_sym": 0, "well": 0}
    want["dia_sym" if A.symmetric else "dia"] += outer
    return want


def phase_general_krylov(a, head, plain_solves, dev, totals):
    """Phase 19b: GMRES(30), FGMRES(30), BiCGStab and MINRES (on symmetric
    storage) preconditioned by 18a's AMG hierarchy at NX^2, fp32, rtol
    KRYLOV_RTOL, beside AMG-PCG on the same right-hand side b = A x* (x* a
    seeded standard normal, so that |A||x| is of the order of ||b|| and the
    fp32 residual means something). Gates: converged; the launches exact;
    a second solve gives the same bits; the float64 host residual (MINRES:
    in the preconditioner's norm, the quantity it reports) within
    KRYLOV_RESIDUAL_GATE * rtol of the reported one. Returns the symmetric
    fp32 operator (19e), the AMG-GMRES run on the Gaussian bump (19f's
    yardstick for the demo) and each solver's iterations (20c's
    yardstick)."""
    A, h = head
    per_cycle = sum(amg_cycle_applies(h))
    prec = h.as_preconditioner()
    n = a.nrows
    x_star = np.random.default_rng(19).standard_normal(n)
    b_host = a.matvec(x_star).astype(np.float32)
    b64 = b_host.astype(np.float64)
    t0 = time.perf_counter()
    As = build_dist_matrix(a, n_devices=1, symmetric=True, dtype=np.float32,
                           local_format="dia", device=dev)
    t_sym = time.perf_counter() - t0
    b, bs = A.to_dist(b_host), As.to_dist(b_host)
    cycles = -(-AMG_KRYLOV_KMAX // GMRES_RESTART)
    runs = {
        "gmres": (A, lambda: gmres(A.matvec, b, restart=GMRES_RESTART, max_cycles=cycles,
                                   rtol=KRYLOV_RTOL, preconditioner=prec)),
        "fgmres": (A, lambda: gmres(A.matvec, b, restart=GMRES_RESTART, max_cycles=cycles,
                                    rtol=KRYLOV_RTOL, preconditioner=prec, flexible=True)),
        "bicgstab": (A, lambda: bicgstab_restarted(A.matvec, b, AMG_KRYLOV_KMAX,
                                                   KRYLOV_RTOL, preconditioner=prec)),
        "minres": (As, lambda: minres(As.matvec, bs, kmax=AMG_KRYLOV_KMAX,
                                      rtol=KRYLOV_RTOL, preconditioner=prec)),
        "cg": (A, lambda: cg(A.matvec, b, kmax=AMG_KRYLOV_KMAX, rtol=KRYLOV_RTOL,
                             preconditioner=prec)),
    }
    out = {}
    for name, (op, run) in runs.items():
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = launch_counts()
        want = solve_launches(name, res, op, per_cycle)
        if got != want or other_launches(got):
            fail(f"19b {name}: launches {got}, want {want} for {res.iterations} iterations")
        add_counts(totals, got)
        again = run()
        if not torch.equal(again.x, res.x) or again.iterations != res.iterations:
            fail(f"19b {name}: a second solve gave other bits")
        x = op.from_dist(res.x).astype(np.float64)
        r64 = b64 - a.matvec(x)
        if name == "minres":
            # MINRES reports phibar, the residual in the M^-1 inner product
            r32 = op.to_dist(r64.astype(np.float32))
            true_rel = float(torch.sqrt(torch.vdot(r32.reshape(-1), prec(r32).reshape(-1)))
                             / res.rnorm0)
        else:
            true_rel = float(np.linalg.norm(r64) / np.linalg.norm(b64))
        rep_rel = float(res.rnorm) / float(res.rnorm0)
        fields = dict(solver=name, matrix=f"laplace2d {NX}^2", storage=(
            "symmetric dia" if op.symmetric else "vanilla dia"), preconditioner="amg",
            rtol=KRYLOV_RTOL, iterations=res.iterations, converged=res.converged,
            cycles=getattr(res, "cycles", None), bicgstab_calls=getattr(res, "calls", None),
            solve_s=seconds, it_per_s=res.iterations / seconds, reported_rel_residual=rep_rel,
            host_rel_residual=true_rel, residual_gate=KRYLOV_RESIDUAL_GATE * KRYLOV_RTOL,
            launches=got)
        show("19b.krylov", **fields)
        if not res.converged:
            fail(f"19b {name}: not converged in {res.iterations} iterations")
        if not abs(true_rel - rep_rel) <= KRYLOV_RESIDUAL_GATE * KRYLOV_RTOL:
            fail(f"19b {name}: host residual {true_rel:.3e} vs reported {rep_rel:.3e}")
        out[name] = res.iterations
    show("19b.summary", iterations=out, symmetric_assemble_s=t_sym)
    # 19f's yardstick: the demo's own solve (AMG-GMRES on 18a's Gaussian
    # bump, whose float32 true residual stops near 0.13 ||b||), beside
    # 18a's AMG-PCG on it
    bump = A.to_dist(gaussian_bump(n, dtype=np.float32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gmres(A.matvec, bump, restart=GMRES_RESTART, max_cycles=cycles,
                rtol=KRYLOV_RTOL, preconditioner=prec)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    pcg = cg(A.matvec, bump, kmax=AMG_KRYLOV_KMAX, rtol=KRYLOV_RTOL, preconditioner=prec)
    x = A.from_dist(res.x).astype(np.float64)
    bump_run = (res.converged, res.iterations,
                float(np.linalg.norm(a.matvec(x) - A.from_dist(bump).astype(np.float64))),
                float(np.linalg.norm(x)))
    show("19b.bump", matrix=f"laplace2d {NX}^2", rhs="gaussian bump (18a's)",
         gmres_iterations=res.iterations, gmres_cycles=res.cycles,
         gmres_converged=res.converged, gmres_solve_s=seconds,
         gmres_reported_rel_residual=float(res.rnorm) / float(res.rnorm0),
         amg_pcg_iterations=pcg.iterations, amg_pcg_converged=pcg.converged)
    return As, bump_run, out


def phase_fsai(a_fem, A_fem, jacobi_its, dev, max_abs, totals):
    """Phase 19c: FSAI-PCG on phase 8's RCM'd 800k FEM, fp32, G and G^T as
    vanilla WELL operators built with A's own settings (fsai_preconditioner,
    its setup timed in its parts). Gates: G's and G^T's stacks through
    well_spmv vs plain; converged in fewer iterations than phase 8's
    Jacobi-PCG; 4 WELL launches a preconditioned iteration (L and L^T of A,
    G, G^T), exactly."""
    split = {}
    prec = fsai_preconditioner(A_fem, timings=split)
    G, Gt = prec.operators
    g_nnz = G.nnz_global
    rng = np.random.default_rng(19)
    for tag, op in (("G", G), ("G^T", Gt)):
        if op.local_format != "well" or op.symmetric:
            fail(f"19c: {tag} is {op.local_format} (symmetric {op.symmetric}), not vanilla well")
        x2 = op.to_dist(rng.standard_normal(a_fem.nrows).astype(np.float32))
        _, err, mabs = well_compare(f"19c FSAI {tag}", dist_rows(op), dist_well(op), x2,
                                    op.well_meta[2], TOL_KERNEL["float32"])
        max_abs["spmv_well"] = max(max_abs["spmv_well"], mabs)
        show("19c.kernel", kernel="spmv_well", matrix=f"FSAI {tag} of fem_p1_2d {N_FEM} RCM",
             nnz=g_nnz, far_nnz=op.well_far_nnz, row_pad=op.row_pad, a_row_pad=A_fem.row_pad,
             rel_l2_vs_plain=err, max_abs_vs_plain=mabs,
             **rows_stats(op.local_rows_ptr, g_nnz))

    b_host = gaussian_bump(a_fem.nrows, dtype=np.float32)
    b = A_fem.to_dist(b_host)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    res = cg(A_fem.matvec, b, kmax=20000, rtol=KRYLOV_RTOL, preconditioner=prec)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = launch_counts()
    want = {"dia": 0, "dia_sym": 0, "well": 4 * (res.iterations + 1)}
    if got != want or other_launches(got):
        fail(f"19c: launches {got}, want {want} for {res.iterations} iterations")
    add_counts(totals, got)
    x = A_fem.from_dist(res.x).astype(np.float64)
    bh = b_host.astype(np.float64)
    show("19c.fsai_pcg", matrix=f"fem_p1_2d {N_FEM} RCM", format=A_fem.local_format,
         symmetric=A_fem.symmetric, dtype="float32", rtol=KRYLOV_RTOL,
         fsai_setup_s=split["setup"], g_assemble_s=split["assemble"],
         transposed_s=split["transposed"], g_nnz=g_nnz,
         iterations=res.iterations, converged=res.converged, solve_s=seconds,
         it_per_s=res.iterations / seconds,
         reported_rel_residual=float(res.rnorm) / float(res.rnorm0),
         host_rel_residual=float(np.linalg.norm(bh - a_fem.matvec(x)) / np.linalg.norm(bh)),
         jacobi_pcg_iterations=jacobi_its, launches=got)
    if not (res.converged and res.iterations < jacobi_its):
        fail(f"19c: FSAI-PCG converged {res.converged} in {res.iterations} iterations, "
             f"Jacobi-PCG {jacobi_its}")


def phase_spai(dev, max_abs, totals):
    """Phase 19d: SPAI-preconditioned GMRES(30) and BiCGStab on the
    convection-diffusion operator at SPAI_NX^2, vanilla DIA, fp32, beside
    Jacobi (a pure rescale here: the diagonal is constant); M built with A's
    own settings (spai_preconditioner, its setup timed in its parts) and its
    DIA stack through dia_spmv vs plain. Gates: the SPAI solves
    converge; every solve's launches exact."""
    a = convection_diffusion_2d(SPAI_NX)
    A = build_dist_matrix(a, n_devices=1, dtype=np.float32, local_format="dia", device=dev)
    split = {}
    spai = spai_preconditioner(A, timings=split)
    (M,) = spai.operators
    if M.local_format != "dia":
        fail(f"19d: M is {M.local_format}, not dia")
    gen = torch.Generator(device=dev).manual_seed(19)
    x2 = torch.randn((M.row_lane_rows, 128), generator=gen, dtype=torch.float32, device=dev)
    _, err, mabs, _ = compare("19d SPAI M", M.local_dia_data, x2, M.dia_offsets, False,
                              TOL_KERNEL["float32"])
    max_abs["dia_spmv"] = max(max_abs["dia_spmv"], mabs)
    show("19d.kernel", kernel="dia_spmv", matrix=f"SPAI M of convection-diffusion "
         f"{SPAI_NX}^2", ndiags=len(M.dia_offsets), rel_l2_vs_plain=err,
         max_abs_vs_plain=mabs, **plan_fields(M.local_dia_data, M.dia_offsets, False, 1))
    b_host = a.matvec(np.random.default_rng(19).standard_normal(a.nrows)).astype(np.float32)
    b = A.to_dist(b_host)
    cycles = -(-SPAI_KMAX // GMRES_RESTART)
    found = {}
    for solver in ("gmres", "bicgstab"):
        for pname, prec in (("spai", spai), ("jacobi", A.jacobi_preconditioner())):
            torch.cuda.synchronize()
            reset_counters()
            t0 = time.perf_counter()
            if solver == "gmres":
                res = gmres(A.matvec, b, restart=GMRES_RESTART, max_cycles=cycles,
                            rtol=KRYLOV_RTOL, preconditioner=prec)
            else:
                res = bicgstab_restarted(A.matvec, b, SPAI_KMAX, KRYLOV_RTOL,
                                         preconditioner=prec)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = launch_counts()
            want = solve_launches(solver, res, A, 1 if pname == "spai" else 0)
            if got != want or other_launches(got):
                fail(f"19d {solver} {pname}: launches {got}, want {want}")
            add_counts(totals, got)
            found[f"{solver} {pname}"] = res.iterations
            show("19d.spai", solver=solver, preconditioner=pname,
                 matrix=f"convection-diffusion {SPAI_NX}^2", rtol=KRYLOV_RTOL,
                 iterations=res.iterations, converged=res.converged,
                 cycles=getattr(res, "cycles", None),
                 bicgstab_calls=getattr(res, "calls", None), solve_s=seconds,
                 spai_setup_s=split["setup"], m_assemble_s=split["assemble"],
                 m_nnz=M.nnz_global,
                 reported_rel_residual=float(res.rnorm) / float(res.rnorm0), launches=got)
            if pname == "spai" and not res.converged:
                fail(f"19d: SPAI-{solver} did not converge in {res.iterations}")
    show("19d.summary", iterations=found)


def phase_lsqr_pipelined(a_cd, A_cd, As, plain_solves, dev, totals):
    """Phase 19e: (a) LSQR, a fixed LSQR_ITERS iterations on 19a's NX^2
    convection-diffusion fp32 DIA operator with its cached transpose as
    rmatvec, beside the same run on the plain versions on the card: the
    rnorm histories within LSQR_TOL relative, 1 + 2 * LSQR_ITERS dia_spmv
    launches; (b) cg_pipelined on the symmetric fp32 NX^2 Laplacian (19b's
    operator) to 1e-6, beside phase 4's cg count, 2 + k dia_sym_spmv
    launches."""
    At = A_cd.transposed()
    b = A_cd.to_dist(gaussian_bump(a_cd.nrows, dtype=np.float32), side="row")
    runs = {}
    for tag in ("kernel", "plain"):
        if tag == "kernel":
            mv, rmv = A_cd.matvec, At.matvec
        else:
            def mv(p):
                return spmv_dia_stacked_plain(A_cd.local_dia_data, p, A_cd.dia_offsets, False)

            def rmv(p):
                return spmv_dia_stacked_plain(At.local_dia_data, p, At.dia_offsets, False)
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        res = lsqr(mv, rmv, b, kmax=LSQR_ITERS, atol=0.0, btol=0.0)
        torch.cuda.synchronize()
        got = launch_counts()
        runs[tag] = (res, time.perf_counter() - t0, got, other_launches(got))
    res, seconds, got, others = runs["kernel"]
    want = {"dia": 1 + 2 * LSQR_ITERS, "dia_sym": 0, "well": 0}
    if (got != want or others or runs["plain"][3]
            or runs["plain"][2] != {"dia": 0, "dia_sym": 0, "well": 0}):
        fail(f"19e LSQR: launches {got} (plain run {runs['plain'][2]}), want {want}")
    add_counts(totals, got)
    hk, hp = (runs[t][0].history.cpu().numpy().astype(np.float64) for t in ("kernel", "plain"))
    diff = float(np.max(np.abs(hk - hp) / np.abs(hp)))
    show("19e.lsqr", matrix=f"convection-diffusion {NX}^2", iterations=res.iterations,
         istop=res.istop, rnorm0=float(res.rnorm0), rnorm=float(res.rnorm),
         arnorm=float(res.arnorm), history_rel_diff_vs_plain=diff, gate=LSQR_TOL,
         solve_s=seconds, plain_solve_s=runs["plain"][1], launches=got)
    if res.iterations != LSQR_ITERS or not diff <= LSQR_TOL or not np.all(np.isfinite(hk)):
        fail(f"19e LSQR: {res.iterations} iterations, history {diff:.3e} from plain")
    bs = As.to_dist(gaussian_bump(As.nrows_global, dtype=np.float32))
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    res = cg_pipelined(As.matvec, bs, kmax=20000, rtol=1e-6)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = launch_counts()
    want = {"dia": 0, "dia_sym": 2 + res.iterations, "well": 0}
    if got != want or other_launches(got):
        fail(f"19e cg_pipelined: launches {got}, want {want}")
    add_counts(totals, got)
    cg_its = plain_solves["symmetric float32"][0]
    show("19e.cg_pipelined", matrix=f"laplace2d {NX}^2 symmetric dia float32", rtol=1e-6,
         iterations=res.iterations, converged=res.converged, solve_s=seconds,
         it_per_s=res.iterations / seconds, cg_iterations=cg_its,
         reported_rel_residual=float(res.rnorm) / float(res.rnorm0), launches=got)
    if not res.converged:
        fail(f"19e cg_pipelined: not converged in {res.iterations}")


def demo_lines(out: str) -> dict:
    """A demo_cg run's printed result: converged, iterations, r.norm, x.norm."""
    line = next(ln for ln in out.splitlines() if ln.startswith("Converged:"))
    return dict(converged=line.split()[1] == "True",
                iterations=int(line.split(" in ")[1].split()[0]),
                r_norm=float(out.split("r.norm = ")[1].split()[0]),
                x_norm=float(out.split("x.norm = ")[1].split()[0]))


@dataclasses.dataclass
class Demos:
    """Demo subprocesses (19f, 20e): their phase tag, commands, processes,
    logs and inputs."""
    work: Path
    cmds: dict
    procs: dict
    logs: dict
    t0: float
    seconds: float = 0.0
    tag: str = "19f"


def launch_demos(work: Path, cmds: dict, tag: str) -> Demos:
    """Start every command as a subprocess on the card, all together, each
    writing its output to work/<name>.log."""
    demos = Demos(work, cmds, {}, {}, time.perf_counter(), tag=tag)
    try:
        for name, cmd in cmds.items():
            demos.logs[name] = open(work / f"{name}.log", "w+")
            demos.procs[name] = subprocess.Popen(
                cmd, stdout=demos.logs[name], stderr=subprocess.STDOUT,
                cwd=Path(__file__).resolve().parent)
    except BaseException:
        stop_demos(demos)
        raise
    return demos


def start_demos() -> Demos:
    """Phase 19f, first half: write the demos' input files and start the
    four demos as subprocesses on the card, all together (each waits on its
    own host work most of the time), before 19a, whose host rebuilds they
    overlap (``wait_demos`` joins them before 19b's timed solves):
    (1) demo_cg --lap2d NX --dia --fp32 --amg --solver gmres; (2) demo_cg
    --petsc/--rhs --dia --solver bicgstab on PETSc files of the port's
    writers (the convection-diffusion operator at DEMO_NX^2, float64);
    (3) demo_cg --mtx --format auto --symmetric --fp32 --fsai on the RCM'd
    fem_p1_2d(HALO_FEM) written by the port's Matrix Market writer;
    (4) demo_restrict --n DEMO_RESTRICT_N --devices 4."""
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_demos"
    work.mkdir(parents=True, exist_ok=True)
    a_cd = convection_diffusion_2d(DEMO_NX)
    write_petsc_binary_matrix(str(work / "cd.petsc"), a_cd)
    write_petsc_binary_vector(str(work / "cd_rhs.petsc"),
                              np.random.default_rng(19).standard_normal(a_cd.nrows))
    fem, _ = rcm_reorder(fem_p1_2d(HALO_FEM), keep_best=True)
    write_matrix_market(str(work / "fem.mtx"), fem)
    demo = [sys.executable, "-m", "spmv_torch.demos.demo_cg"]
    cmds = {
        "amg_gmres": demo + ["--lap2d", str(NX), "--dia", "--fp32", "--amg", "--solver",
                             "gmres", "--rtol", str(KRYLOV_RTOL), "--kmax",
                             str(AMG_KRYLOV_KMAX)],
        "petsc_bicgstab": demo + ["--petsc", str(work / "cd.petsc"), "--rhs",
                                  str(work / "cd_rhs.petsc"), "--dia", "--solver", "bicgstab",
                                  "--rtol", str(DEMO_RTOL), "--kmax", str(DEMO_KMAX)],
        "mtx_fsai": demo + ["--mtx", str(work / "fem.mtx"), "--format", "auto",
                            "--symmetric", "--fp32", "--fsai", "--rtol", "1e-6",
                            "--kmax", "20000"],
        "restrict": [sys.executable, "-m", "spmv_torch.demos.demo_restrict", "--n",
                     str(DEMO_RESTRICT_N), "--devices", "4"],
    }
    return launch_demos(work, cmds, "19f")


def stop_demos(demos: Demos) -> None:
    """Kill whatever demo still runs and close the logs."""
    for p in demos.procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()
    for fh in demos.logs.values():
        fh.close()


def wait_demos(demos: Demos) -> None:
    """Join every demo within DEMO_TIMEOUT of their start; fail past it."""
    try:
        for name, p in demos.procs.items():
            try:
                p.wait(timeout=max(DEMO_TIMEOUT - (time.perf_counter() - demos.t0), 1))
            except subprocess.TimeoutExpired:
                fail(f"{demos.tag} {name}: still running after {DEMO_TIMEOUT} s")
    finally:
        demos.seconds = time.perf_counter() - demos.t0
        stop_demos(demos)
    show(f"{demos.tag}.demos_done", seconds_all_demos=demos.seconds)


def check_demos(demos: Demos, bump_run, dev) -> None:
    """Phase 19f, second half: each demo exited 0, and its printed residual
    agrees with the same solve in this process: (1) 19b's AMG-GMRES run on
    the same Gaussian bump (the demo's AMG levels are ELL, this process's
    DIA: iterations within 1, r.norm within DEMO_AMG_TOL); (2) and (3) the
    same iterations and r.norm to 1e-10 and 1e-6, run here on the same
    files; (4) its printed norms equal the host CSR's to 1e-12."""
    from spmv_torch.demos.demo_restrict import restriction_1d

    work = demos.work
    a_cd = read_petsc_binary_matrix_host(str(work / "cd.petsc"))
    A = build_dist_matrix(a_cd, n_devices=1, dtype=np.float64, local_format="dia", device=dev)
    b = read_petsc_binary_vector_host(str(work / "cd_rhs.petsc"))
    res = bicgstab(A.matvec, A.to_dist(b), kmax=DEMO_KMAX, rtol=DEMO_RTOL)
    x = A.from_dist(res.x)
    mine = {"petsc_bicgstab": dict(converged=res.converged, iterations=res.iterations,
                                   r_norm=float(np.linalg.norm(a_cd.matvec(x) - b)),
                                   x_norm=float(np.linalg.norm(x)))}
    f = read_matrix_market(str(work / "fem.mtx"))
    A = build_dist_matrix(f, n_devices=1, symmetric=True, dtype=np.float32,
                          local_format="auto", device=dev)
    bf = gaussian_bump(f.nrows, dtype=np.float32)
    res = cg(A.matvec, A.to_dist(bf), kmax=20000, rtol=1e-6,
             preconditioner=fsai_preconditioner(A, local_format="auto"))
    x = A.from_dist(res.x)
    mine["mtx_fsai"] = dict(converged=res.converged, iterations=res.iterations,
                            r_norm=float(np.linalg.norm(
                                f.matvec(x.astype(np.float64)) - bf.astype(np.float64))),
                            x_norm=float(np.linalg.norm(x)))
    mine["amg_gmres"] = dict(zip(("converged", "iterations", "r_norm", "x_norm"), bump_run))
    rmat = restriction_1d(DEMO_RESTRICT_N)
    coarse = rmat.matvec(gaussian_bump(DEMO_RESTRICT_N))
    norms = {"|R f|    = ": np.linalg.norm(coarse),
             "|R^T R f|= ": np.linalg.norm(rmat.transpose().matvec(coarse))}
    for name, p in demos.procs.items():
        out = (work / f"{name}.log").read_text()
        cmd = " ".join(demos.cmds[name][1:])
        if p.returncode != 0:
            fail(f"19f {name}: exit {p.returncode}: {out[-2000:]}")
        if name == "restrict":
            got = {k: float(out.split(k)[1].split()[0]) for k in norms}
            errs = {k: abs(got[k] - v) / v for k, v in norms.items()}
            show("19f.demo", demo=name, cmd=cmd, printed=got,
                 rel_diff_vs_host=list(errs.values()), seconds_all_demos=demos.seconds)
            if max(errs.values()) > 1e-12 or "verified against the host CSR" not in out:
                fail(f"19f restrict: printed norms {got}, host {norms}")
            continue
        got, want = demo_lines(out), mine[name]
        tol_its, tol_r = {"amg_gmres": (1, DEMO_AMG_TOL), "petsc_bicgstab": (0, 1e-10),
                          "mtx_fsai": (0, 1e-6)}[name]
        rdiff = abs(got["r_norm"] - want["r_norm"]) / max(want["r_norm"], 1e-300)
        show("19f.demo", demo=name, cmd=cmd, printed=got, this_process=want,
             r_norm_rel_diff=rdiff, seconds_all_demos=demos.seconds)
        # AMG-GMRES tests the true residual, which in float32 stops at the
        # bump's floor (phase 18a: 0.13 ||b|| at NX^2): there the two runs
        # must agree on not converging
        converged_ok = (got["converged"] == want["converged"] if name == "amg_gmres"
                        else got["converged"] and want["converged"])
        if not (converged_ok and np.isfinite(got["r_norm"])
                and abs(got["iterations"] - want["iterations"]) <= tol_its
                and rdiff <= tol_r):
            fail(f"19f {name}: printed {got}, this process's run {want}")


def phase_krylov(a_lap, head, plain_solves, a_fem, A_fem, jacobi_its, dev, max_abs):
    """Phase 19: the general Krylov path and the transpose operator (19a-f;
    19f's demos run beside 19a and are checked last). Returns the
    single-RHS launch counts of its gated runs and 19b's iterations by
    solver."""
    totals = {"dia": 0, "dia_sym": 0, "well": 0}
    t0 = time.perf_counter()
    demos = start_demos()
    try:
        a_cd, A_cd = phase_transpose(dev, max_abs, totals)
    except BaseException:
        stop_demos(demos)
        raise
    show("19a.seconds", seconds=time.perf_counter() - t0)
    wait_demos(demos)
    t0 = time.perf_counter()
    As, bump_run, krylov_its = phase_general_krylov(a_lap, head, plain_solves, dev, totals)
    show("19b.seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_fsai(a_fem, A_fem, jacobi_its, dev, max_abs, totals)
    show("19c.seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_spai(dev, max_abs, totals)
    show("19d.seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_lsqr_pipelined(a_cd, A_cd, As, plain_solves, dev, totals)
    del A_cd, As
    show("19e.seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    check_demos(demos, bump_run, dev)
    show("19f.seconds", seconds=time.perf_counter() - t0,
         demos_seconds_beside_19a=demos.seconds)
    show("19.krylov", launches=totals)
    return totals, krylov_its


# ----------------------------------------------------------------- phase 20

@contextlib.contextmanager
def counting(*targets):
    """Count calls of module-level functions while the block runs:
    ``targets`` are (module, name) pairs that share one counter (a module
    that imports a function by name holds its own reference, so each is
    patched); yields the one-element counter list."""
    count = [0]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def wrap(fn):
        def counted(*args, **kwargs):
            count[0] += 1
            return fn(*args, **kwargs)
        return counted

    for mod, name, fn in saved:
        setattr(mod, name, wrap(fn))
    try:
        yield count
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def gather_counter():
    """``counting`` over the halo gathers of the matvec and of the MPK."""
    return counting((dist_matrix_mod, "halo_gather"), (powers_mod, "halo_gather"))


def sync_counter():
    """``counting`` over the s-step solvers' host syncs."""
    return counting((cg_sstep_mod, "host_sync"), (gmres_sstep_mod, "host_sync"))


def single_counts() -> dict:
    """Every kernel's launch counter: the single-RHS (``launch_counts``),
    the double-single single-RHS and the block ones."""
    return {**launched("dia", "dia_sym", "well", "dia_ds", "well_ds"), **block_launches()}


def launch_gate(tag: str, got: dict, want: dict) -> None:
    """Exact launch counts: ``want`` for its kernels and none of any other
    kernel (every single-RHS and block kernel counted)."""
    others = (single_launches() + sum(block_launches().values())
              - sum(got.get(k, 0) for k in want))
    if any(got.get(k, 0) != n for k, n in want.items()) or others:
        fail(f"{tag}: launches {got} (+{others} others), want {want}")


def start_sstep_demos() -> Demos:
    """Phase 20e, first half: the three demos of the s-step group as
    subprocesses, started together after 20b and joined in 20e:
    (1) demo_cg --lap2d SSTEP_DEMO_NX --dia --sstep 4 --mpk --devices 4;
    (2) demo_cg on 19f's convection-diffusion PETSc files, --dia --sstep 4
    --solver gmres --newton 16 --mpk --devices 4 (the reference demo's
    kmax and rtol); (3) demo_cg --lap2d SSTEP_DEMO_NX --dia --symmetric
    --fp32 --deflated 4, which 20d runs in this process."""
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_demos"
    demo = [sys.executable, "-m", "spmv_torch.demos.demo_cg"]
    solve = ["--kmax", str(SSTEP_KMAX), "--rtol", str(SSTEP_RTOL)]
    cmds = {
        "sstep_mpk": demo + ["--lap2d", str(SSTEP_DEMO_NX), "--dia", "--sstep", str(SSTEP_S),
                             "--mpk", "--devices", str(MPK_DEVICES), *solve],
        "newton_mpk": demo + ["--petsc", str(work / "cd.petsc"), "--rhs",
                              str(work / "cd_rhs.petsc"), "--dia", "--sstep", str(SSTEP_S),
                              "--solver", "gmres", "--newton", str(DEMO_NEWTON_M), "--mpk",
                              "--devices", str(MPK_DEVICES)],
        "deflated": demo + ["--lap2d", str(SSTEP_DEMO_NX), "--dia", "--symmetric", "--fp32",
                            "--deflated", str(DEFLATED_D), *solve],
    }
    return launch_demos(work, cmds, "20e")


def phase_mpk(a, dev, max_abs, totals):
    """Phase 20a: the matrix-powers basis at NX^2, float64, vanilla DIA on
    MPK_DEVICES stacked shards, s = SSTEP_S. The depth-s plan (its host BFS
    and window packing timed), its ghost growth; the window's dia_spmv vs
    its plain version on a random input at the window's shape (folded into
    max_abs); then chebyshev_powers_basis against the s-matvec basis
    (relative L2 <= MPK_TOL), exactly one halo_gather and s dia_spmv
    launches a basis and nothing else, the same bits on a second build.
    Returns (A, plan) for 20b."""
    t0 = time.perf_counter()
    A = build_dist_matrix(a, n_devices=MPK_DEVICES, dtype=np.float64, local_format="dia",
                          device=dev)
    t_asm = time.perf_counter() - t0
    t0 = time.perf_counter()
    pp = build_powers_plan(a, A, s=SSTEP_S)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    if pp.local_format != "dia":
        fail(f"20a: the powers plan took {pp.local_format}, not dia")
    stats = powers_ghost_stats(pp, A)
    # both depths pad their ghost buffers to col_pad (as the reference's
    # plans do); the logical ghost rows show the stencil's growth
    ghosts = (int(pp.plan.nghosts.max()), int(A.plan.nghosts.max()))
    stats.update(ghost_rows_depth_s=ghosts[0], ghost_rows_depth_1=ghosts[1],
                 ghost_rows_growth=ghosts[0] / max(ghosts[1], 1))
    gen = torch.Generator(device=dev).manual_seed(20)
    xw = torch.randn((MPK_DEVICES * pp.dia_rows // 128, 128), generator=gen,
                     dtype=torch.float64, device=dev)
    _, err, mabs, _ = compare("20a window dia_spmv", pp.dia_data, xw, pp.dia_offsets, False,
                              TOL_KERNEL["float64"])
    max_abs["dia_spmv"] = max(max_abs["dia_spmv"], mabs)
    show("20a.kernel", kernel="dia_spmv", matrix=f"laplace2d {NX}^2 window, D={MPK_DEVICES}",
         dtype="float64", window_rows=pp.dia_rows, offsets=list(pp.dia_offsets),
         rel_l2_vs_plain=err, max_abs_vs_plain=mabs,
         **plan_fields(pp.dia_data, pp.dia_offsets, False, 1))
    del xw
    x = A.to_dist(gaussian_bump(a.nrows))
    c = e = MPK_INTERVAL / 2
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        reset_counters()
        with gather_counter() as gathers:
            t0 = time.perf_counter()
            V = chebyshev_powers_basis(pp, x, c, e)
            torch.cuda.synchronize()
            runs.append((V, time.perf_counter() - t0, single_counts(), gathers[0]))
    V, t_mpk, got, n_gather = runs[1]
    launch_gate("20a MPK basis", got, {"dia": SSTEP_S})
    if n_gather != 1 or runs[0][3] != 1:
        fail(f"20a: {n_gather} halo gathers for one MPK basis, want 1")
    if not torch.equal(runs[0][0], V):
        fail("20a: a second MPK basis gave other bits")
    add_counts(totals, got)
    torch.cuda.synchronize()
    reset_counters()
    with gather_counter() as gathers:
        t0 = time.perf_counter()
        Vn = chebyshev_basis(A.matvec, x, SSTEP_S, c, e)
        torch.cuda.synchronize()
        t_naive = time.perf_counter() - t0
    launch_gate("20a naive basis", single_counts(), {"dia": SSTEP_S})
    add_counts(totals, single_counts())
    rel = float(torch.linalg.vector_norm(V - Vn) / torch.linalg.vector_norm(Vn))
    show("20a.mpk", matrix=f"laplace2d {NX}^2", dtype="float64", devices=MPK_DEVICES,
         s=SSTEP_S, assemble_s=t_asm, plan_s=t_plan, ghost_stats=stats,
         window_rows=pp.dia_rows, gl_pad=pp.gl_pad, rel_l2_vs_naive=rel, gate=MPK_TOL,
         halo_gathers_mpk=n_gather, halo_gathers_naive=gathers[0], launches_mpk=got,
         basis_s_mpk=t_mpk, basis_s_naive=t_naive, second_build_same_bits=True)
    if not rel <= MPK_TOL:
        fail(f"20a: MPK basis {rel:.3e} from the naive basis")
    del V, Vn, runs
    return A, pp


def sstep_run(tag, A, b, kernel, builder, solves):
    """One gated cg_sstep(s=SSTEP_S) solve at NX^2 float64, run twice:
    converged, the same bits both times; one host sync a block (setup reads
    |r0| and the power iteration's lmax, the end the true residual, and the
    best-iterate fallback one more); the launches exact: ``kernel`` once for
    |r0|, 12 times for lmax, s times a block and once or twice at the end,
    and (with the MPK ``builder``) one halo gather a block beside the
    plain applies'."""
    out = []
    for _ in range(2):
        torch.cuda.synchronize()
        reset_counters()
        with sync_counter() as syncs, gather_counter() as gathers:
            t0 = time.perf_counter()
            res = cg_sstep(A.matvec, b, s=SSTEP_S, kmax=SSTEP_KMAX, rtol=SSTEP_RTOL,
                           basis_builder=builder)
            torch.cuda.synchronize()
            out.append((res, time.perf_counter() - t0, single_counts(), syncs[0], gathers[0]))
    res, seconds, got, n_sync, n_gather = out[0]
    if not (torch.equal(out[1][0].x, res.x) and out[1][0].iterations == res.iterations):
        fail(f"{tag}: a second solve gave other bits")
    blocks = res.iterations // SSTEP_S
    if n_sync not in (blocks + 3, blocks + 4):
        fail(f"{tag}: {n_sync} host syncs for {blocks} blocks, want one a block")
    tail = n_sync - blocks - 2  # the final residual, and the fallback's
    launch_gate(tag, got, {kernel: 13 + SSTEP_S * blocks + tail, **(
        {"dia_sym": 0} if kernel == "dia" else {"dia": 0})})
    if builder is not None and n_gather != 13 + blocks + tail:
        fail(f"{tag}: {n_gather} halo gathers for {blocks} blocks, want one a block")
    x = A.from_dist(res.x)
    bh = A.from_dist(b, side="col")
    host = float(np.linalg.norm(bh - solves["a"].matvec(x)))
    bn = float(np.linalg.norm(bh))
    fields = dict(run=tag, iterations=res.iterations, blocks=blocks, converged=res.converged,
                  reported_rel_residual=float(res.rnorm) / bn, host_rel_residual=host / bn,
                  host_syncs=n_sync, halo_gathers=n_gather, launches=got, solve_s=seconds,
                  it_per_s=res.iterations / seconds, cg_iterations=solves["cg"],
                  second_solve_same_bits=True)
    show("20b.cg_sstep", **fields)
    if not res.converged:
        fail(f"{tag}: not converged in {res.iterations} iterations")
    if abs(host - float(res.rnorm)) > SSTEP_RESIDUAL_GATE * bn:
        fail(f"{tag}: host residual {host / bn:.3e} vs reported "
             f"{float(res.rnorm) / bn:.3e}")
    return res.iterations


def phase_sstep_cg(a, As64, A4, pp, cg_its, dev, totals):
    """Phase 20b: cg_sstep(s=SSTEP_S) at NX^2 float64 on the Gaussian bump,
    rtol SSTEP_RTOL: on phase 4's symmetric DIA operator at D = 1
    (dia_sym_spmv), and through the MPK at D = MPK_DEVICES (20a's plan,
    dia_spmv on the windows); each gated by ``sstep_run``, the iterations
    beside phase 4's CG."""
    solves = {"a": a, "cg": cg_its}
    its = {}
    for tag, A, kernel, builder in (
            ("20b D=1 symmetric", As64, "dia_sym", None),
            (f"20b D={MPK_DEVICES} mpk", A4, "dia",
             lambda r, c, e: chebyshev_powers_basis(pp, r, c, e))):
        b = A.to_dist(gaussian_bump(a.nrows))
        its[tag] = sstep_run(tag, A, b, kernel, builder, solves)
        add_counts(totals, single_counts())
    return its


def phase_sstep_gmres(a_lap, head, gmres_its, dev, totals):
    """Phase 20c: gmres_sstep(s=SSTEP_S, restart=32) on A o M, M 18a's AMG
    W-cycle (its hierarchy reused), NX^2 float32, on 19b's b = A x*, x =
    M u; gated as 19b (converged, exact launches: every A o M apply 1 +
    the cycle's dia_spmv launches, the same bits on a second solve, the
    float64 host residual within KRYLOV_RESIDUAL_GATE rtol of the
    reported), the steps beside 19b's GMRES(30). Then the Newton basis: an
    NEWTON_M-step Arnoldi harvest on the NEWTON_NX^2 convection-diffusion
    operator (float64 vanilla DIA, D = MPK_DEVICES, b = A x*),
    gmres_sstep(newton_ops=, basis_builder=newton_powers_basis) for
    NEWTON_CYCLES cycles beside the same solve with the s-apply Newton
    basis: the same steps, residuals within NEWTON_TOL relative; one halo
    gather and one host sync a block, exact launches, the reported
    residual the host's within 1e-8 ||b||."""
    A, h = head
    per_cycle = sum(amg_cycle_applies(h))
    prec = h.as_preconditioner()
    n = a_lap.nrows
    b_host = a_lap.matvec(np.random.default_rng(19).standard_normal(n)).astype(np.float32)
    b = A.to_dist(b_host)
    cycles = -(-AMG_KRYLOV_KMAX // 32)

    def am(v):
        return A.matvec(prec(v))

    out = []
    for _ in range(2):
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        res = gmres_sstep(am, b, s=SSTEP_S, restart=32, max_cycles=cycles, rtol=KRYLOV_RTOL)
        x = prec(res.x)
        torch.cuda.synchronize()
        out.append((res, x, time.perf_counter() - t0, single_counts()))
    res, x, seconds, got = out[0]
    if not (torch.equal(out[1][1], x) and out[1][0].iterations == res.iterations):
        fail("20c AMG: a second solve gave other bits")
    applies = 1 + 12 + res.iterations + res.cycles
    launch_gate("20c AMG", got, {"dia": applies * (1 + per_cycle) + per_cycle,
                                  "dia_sym": 0})
    add_counts(totals, got)
    r64 = b_host.astype(np.float64) - a_lap.matvec(A.from_dist(x).astype(np.float64))
    true_rel = float(np.linalg.norm(r64) / np.linalg.norm(b_host.astype(np.float64)))
    rep_rel = float(res.rnorm) / float(res.rnorm0)
    show("20c.amg", solver="gmres_sstep", matrix=f"laplace2d {NX}^2", preconditioner="amg",
         s=SSTEP_S, restart=32, rtol=KRYLOV_RTOL, iterations=res.iterations,
         cycles=res.cycles, converged=res.converged, gmres_19b_iterations=gmres_its,
         solve_s=seconds, reported_rel_residual=rep_rel, host_rel_residual=true_rel,
         launches=got, second_solve_same_bits=True)
    if not res.converged:
        fail(f"20c AMG: not converged in {res.iterations} steps")
    if not abs(true_rel - rep_rel) <= KRYLOV_RESIDUAL_GATE * KRYLOV_RTOL:
        fail(f"20c AMG: host residual {true_rel:.3e} vs reported {rep_rel:.3e}")

    a_cd = convection_diffusion_2d(NEWTON_NX)
    t0 = time.perf_counter()
    Acd = build_dist_matrix(a_cd, n_devices=MPK_DEVICES, dtype=np.float64, local_format="dia",
                            device=dev)
    pp = build_powers_plan(a_cd, Acd, s=SSTEP_S)
    t_setup = time.perf_counter() - t0
    bh = a_cd.matvec(np.random.default_rng(20).standard_normal(a_cd.nrows))
    b = Acd.to_dist(bh)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    ritz = newton_shifts_from_operator(Acd.matvec, b, m=NEWTON_M)
    torch.cuda.synchronize()
    t_ritz = time.perf_counter() - t0
    launch_gate("20c Arnoldi", single_counts(), {"dia": NEWTON_M})
    add_counts(totals, single_counts())
    ops = newton_basis_ops(ritz, SSTEP_S)
    runs = {}
    for tag, builder in (("mpk", lambda q: newton_powers_basis(pp, q, ops)), ("naive", None)):
        torch.cuda.synchronize()
        reset_counters()
        with sync_counter() as syncs, gather_counter() as gathers:
            t0 = time.perf_counter()
            r = gmres_sstep(Acd.matvec, b, s=SSTEP_S, restart=32, max_cycles=NEWTON_CYCLES,
                            rtol=KRYLOV_RTOL, newton_ops=ops, basis_builder=builder)
            torch.cuda.synchronize()
            runs[tag] = (r, time.perf_counter() - t0, single_counts(), syncs[0], gathers[0])
    r, seconds, got, n_sync, n_gather = runs["mpk"]
    rn = runs["naive"][0]
    blocks = r.iterations // SSTEP_S
    launch_gate("20c Newton MPK", got, {"dia": 1 + SSTEP_S * blocks + r.cycles, "dia_sym": 0})
    add_counts(totals, got)
    add_counts(totals, runs["naive"][2])
    host = float(np.linalg.norm(bh - a_cd.matvec(Acd.from_dist(r.x))))
    bn = float(np.linalg.norm(bh))
    rdiff = abs(float(r.rnorm) - float(rn.rnorm)) / float(rn.rnorm)
    show("20c.newton", matrix=f"convection-diffusion {NEWTON_NX}^2", dtype="float64",
         devices=MPK_DEVICES, s=SSTEP_S, restart=32, arnoldi_m=NEWTON_M,
         setup_s=t_setup, ritz_s=t_ritz, max_abs_imag=float(np.abs(ritz.imag).max()),
         leja_shifts=[[float(z.real), float(z.imag)] for z in modified_leja(ritz)[:SSTEP_S]],
         ops=[list(o) for o in ops], iterations=r.iterations, cycles=r.cycles,
         converged=r.converged, rel_residual=float(r.rnorm) / bn, host_rel_residual=host / bn,
         naive_iterations=rn.iterations, naive_rel_residual=float(rn.rnorm) / bn,
         rnorm_rel_diff_vs_naive=rdiff, host_syncs=n_sync, halo_gathers=n_gather,
         launches=got, solve_s=seconds, naive_solve_s=runs["naive"][1])
    if not (np.isfinite(float(r.rnorm)) and float(r.rnorm) < float(r.rnorm0)):
        fail(f"20c Newton: no progress ({float(r.rnorm):.3e} from {float(r.rnorm0):.3e})")
    if (r.iterations, r.cycles) != (rn.iterations, rn.cycles) or not rdiff <= NEWTON_TOL:
        fail(f"20c Newton: MPK {r.iterations} steps, rnorm {float(r.rnorm):.6e}; naive "
             f"{rn.iterations}, {float(rn.rnorm):.6e}")
    if n_sync != 1 + blocks + r.cycles or n_gather != 1 + blocks + r.cycles:
        fail(f"20c Newton: {n_sync} host syncs, {n_gather} halo gathers for {blocks} "
             f"blocks and {r.cycles} cycles")
    if abs(host - float(r.rnorm)) > SSTEP_RESIDUAL_GATE * bn:
        fail(f"20c Newton: host residual {host / bn:.3e} vs reported {float(r.rnorm) / bn:.3e}")
    return res.iterations


def phase_deflated(dev, max_abs, totals):
    """Phase 20d: LOBPCG and deflated CG at SSTEP_DEMO_NX^2 float32 on
    symmetric DIA storage, as ``demo_cg --deflated 4`` sets them up
    (``demo_cg.deflation_basis``: a 32-step Lanczos bound, LOBPCG with
    the degree-16 Chebyshev filter, maxiter 100, tol 1e-3), beside CG on
    the same Gaussian bump, rtol SSTEP_RTOL. First dia_sym_spmm vs its
    plain version at the block's width (nrhs DEFLATED_D); then exact
    launches (Lanczos: 32 dia_sym_spmv; LOBPCG: 1 + 17 dia_sym_spmm an
    iteration; cg_deflated: D + 1 + k dia_sym_spmv), the Ritz values
    inside the spectrum (above lambda_1 less RITZ_TOL: Rayleigh quotients
    of a symmetric operator cannot fall below it), both solves converged,
    the same bits on a second deflated solve; the iterations printed
    beside CG's, not gated (a basis short of the bottom eigenvectors can
    slow CG down). Returns (iterations, r.norm on the host, x.norm) for
    20e's demo."""
    from spmv_torch.demos.demo_cg import deflation_basis

    a = create_laplace_2d(SSTEP_DEMO_NX, SSTEP_DEMO_NX)
    A = build_dist_matrix(a, n_devices=1, symmetric=True, dtype=np.float32,
                          local_format="dia", device=dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    xs = (lanes_block(gen, A.local_dia_data.shape[1], DEFLATED_D, torch.float32, dev),)
    block_check(max_abs, "20d", "dia_sym_spmm", f"laplace2d {SSTEP_DEMO_NX}^2", "float32",
                DEFLATED_D,
                lambda x: spmm_dia_cuda.spmm_dia_stacked(A.local_dia_data, x, A.dia_offsets,
                                                         True),
                lambda x: spmm_dia_stacked_plain(A.local_dia_data, x, A.dia_offsets, True),
                lambda x: spmv_dia_cuda.spmv_dia_stacked(A.local_dia_data, x, A.dia_offsets,
                                                         True), xs, TOL_KERNEL["float32"])
    del xs
    b_host = gaussian_bump(a.nrows, dtype=np.float32)
    b = A.to_dist(b_host)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    W, eig = deflation_basis(A, DEFLATED_D, np.float32)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    got = single_counts()
    launch_gate("20d set-up", got, {"dia_sym": 32, "dia_sym_spmm": 1 + 17 * eig.iterations})
    add_counts(totals, got)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        res = cg_deflated(A.matvec, b, W, kmax=SSTEP_KMAX, rtol=SSTEP_RTOL)
        torch.cuda.synchronize()
        runs.append((res, time.perf_counter() - t0, single_counts()))
    res, seconds, got = runs[0]
    if not (torch.equal(runs[1][0].x, res.x) and runs[1][0].iterations == res.iterations):
        fail("20d: a second deflated solve gave other bits")
    launch_gate("20d cg_deflated", got, {"dia_sym": DEFLATED_D + 1 + res.iterations})
    add_counts(totals, got)
    reset_counters()
    t0 = time.perf_counter()
    plain = cg(A.matvec, b, kmax=SSTEP_KMAX, rtol=SSTEP_RTOL)
    torch.cuda.synchronize()
    t_cg = time.perf_counter() - t0
    add_counts(totals, single_counts())
    bh = b_host.astype(np.float64)
    x, xc = A.from_dist(res.x).astype(np.float64), A.from_dist(plain.x).astype(np.float64)
    r_norm = float(np.linalg.norm(a.matvec(x) - bh))
    bn = float(np.linalg.norm(bh))
    # the 5-point Laplacian's extreme eigenvalues
    lam1 = 4 - 4 * np.cos(np.pi / (SSTEP_DEMO_NX + 1))
    lam_max = 4 + 4 * np.cos(np.pi / (SSTEP_DEMO_NX + 1))
    ritz = np.asarray(eig.eigenvalues, np.float64)
    show("20d.deflated", matrix=f"laplace2d {SSTEP_DEMO_NX}^2 symmetric dia float32",
         d=DEFLATED_D, setup_s=t_setup, lobpcg_iterations=eig.iterations,
         lobpcg_converged=eig.converged, ritz_values=ritz.tolist(),
         lambda_1=lam1, iterations=res.iterations, converged=res.converged,
         reported_rel_residual=float(res.rnorm) / float(res.rnorm0),
         host_rel_residual=r_norm / bn, solve_s=seconds, cg_iterations=plain.iterations,
         cg_converged=plain.converged, cg_host_rel_residual=float(
             np.linalg.norm(a.matvec(xc) - bh)) / bn, cg_solve_s=t_cg, launches=got,
         second_solve_same_bits=True)
    if not (res.converged and plain.converged):
        fail(f"20d: deflated CG converged {res.converged}, CG {plain.converged}")
    if not (np.all(ritz >= lam1 - RITZ_TOL) and np.all(ritz <= lam_max + RITZ_TOL)):
        fail(f"20d: LOBPCG Ritz values {ritz} outside [{lam1}, {lam_max}]")
    return res.iterations, r_norm, float(np.linalg.norm(x))


def check_sstep_demos(demos: Demos, deflated_run, dev) -> None:
    """Phase 20e, second half: each demo exited 0 and printed the result of
    the same solve run here: (1) s-step CG through the MPK at
    SSTEP_DEMO_NX^2 float64 D = 4; (2) the Newton MPK CA-GMRES on 19f's
    PETSc files (a 16-step Ritz harvest, restart 32, 4 cycles: the
    reference demo's kmax 100 and rtol 1e-10); (3) 20d's deflated solve.
    The same convergence, iterations and r.norm within DEMO_SSTEP_TOL."""
    a = create_laplace_2d(SSTEP_DEMO_NX, SSTEP_DEMO_NX)
    A = build_dist_matrix(a, n_devices=MPK_DEVICES, dtype=np.float64, local_format="dia",
                          device=dev)
    pp = build_powers_plan(a, A, s=SSTEP_S)
    bh = gaussian_bump(a.nrows)
    res = cg_sstep(A.matvec, A.to_dist(bh), s=SSTEP_S, kmax=SSTEP_KMAX, rtol=SSTEP_RTOL,
                   basis_builder=lambda r, c, e: chebyshev_powers_basis(pp, r, c, e))
    x = A.from_dist(res.x)
    mine = {"sstep_mpk": dict(converged=res.converged, iterations=res.iterations,
                              r_norm=float(np.linalg.norm(a.matvec(x) - bh)),
                              x_norm=float(np.linalg.norm(x)))}
    work = demos.work
    a_cd = read_petsc_binary_matrix_host(str(work / "cd.petsc"))
    bh = read_petsc_binary_vector_host(str(work / "cd_rhs.petsc"))
    A = build_dist_matrix(a_cd, n_devices=MPK_DEVICES, dtype=np.float64, local_format="dia",
                          device=dev)
    b = A.to_dist(bh)
    ritz = arnoldi_ritz(A.matvec, b, m=DEMO_NEWTON_M).values
    ops = newton_basis_ops(ritz, SSTEP_S)
    pp = build_powers_plan(a_cd, A, s=SSTEP_S)
    res = gmres_sstep(A.matvec, b, s=SSTEP_S, restart=32, max_cycles=4, rtol=1e-10,
                      shifts=ritz, basis_builder=lambda q: newton_powers_basis(pp, q, ops))
    x = A.from_dist(res.x)
    mine["newton_mpk"] = dict(converged=res.converged, iterations=res.iterations,
                              r_norm=float(np.linalg.norm(a_cd.matvec(x) - bh)),
                              x_norm=float(np.linalg.norm(x)))
    its, r_norm, x_norm = deflated_run
    mine["deflated"] = dict(converged=True, iterations=its, r_norm=r_norm, x_norm=x_norm)
    for name, p in demos.procs.items():
        out = (work / f"{name}.log").read_text()
        if p.returncode != 0:
            fail(f"20e {name}: exit {p.returncode}: {out[-2000:]}")
        got, want = demo_lines(out), mine[name]
        rdiff = abs(got["r_norm"] - want["r_norm"]) / max(want["r_norm"], 1e-300)
        show("20e.demo", demo=name, cmd=" ".join(demos.cmds[name][1:]), printed=got,
             this_process=want, r_norm_rel_diff=rdiff, seconds_all_demos=demos.seconds,
             mpk_line=next((ln for ln in out.splitlines() if ln.startswith("MPK:")), None),
             newton_line=next((ln for ln in out.splitlines() if ln.startswith("Newton")),
                              None))
        tol_its, tol_r = DEMO_SSTEP_TOL[name]
        if not (got["converged"] == want["converged"] and np.isfinite(got["r_norm"])
                and abs(got["iterations"] - want["iterations"]) <= tol_its
                and rdiff <= tol_r):
            fail(f"20e {name}: printed {got}, this process's run {want}")


def phase_pipelined_fp64(a, As64, cg_its, totals) -> None:
    """Phase 20f: cg_pipelined in float64 on phase 4's symmetric NX^2
    operator and Gaussian bump, rtol 1e-6, beside phase 4's CG: converged,
    2 + k dia_sym_spmv launches. In float64 the recurrence does not drift
    as in float32 (19e: 8825 against 7107), so the counts should meet."""
    b = As64.to_dist(gaussian_bump(a.nrows))
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    res = cg_pipelined(As64.matvec, b, kmax=20000, rtol=1e-6)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = single_counts()
    launch_gate("20f cg_pipelined", got, {"dia_sym": 2 + res.iterations, "dia": 0})
    add_counts(totals, got)
    show("20f.cg_pipelined", matrix=f"laplace2d {NX}^2 symmetric dia float64", rtol=1e-6,
         iterations=res.iterations, cg_iterations=cg_its, converged=res.converged,
         solve_s=seconds, it_per_s=res.iterations / seconds,
         reported_rel_residual=float(res.rnorm) / float(res.rnorm0), launches=got)
    if not res.converged:
        fail(f"20f cg_pipelined: not converged in {res.iterations}")


def phase_sstep(a, As64, head, plain_solves, gmres_its, dev, max_abs):
    """Phase 20: the communication-avoiding solvers (20a-f; 20e's demos
    run beside 20c-f and are checked last). Returns the launch counts of
    its gated runs."""
    totals = {}
    cg_its = plain_solves["symmetric float64"][0]
    t0 = time.perf_counter()
    A4, pp = phase_mpk(a, dev, max_abs, totals)
    show("20a.seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_sstep_cg(a, As64, A4, pp, cg_its, dev, totals)
    del A4, pp
    show("20b.seconds", seconds=time.perf_counter() - t0)
    demos = start_sstep_demos()
    try:
        t0 = time.perf_counter()
        phase_sstep_gmres(a, head, gmres_its, dev, totals)
        show("20c.seconds", seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        deflated_run = phase_deflated(dev, max_abs, totals)
        show("20d.seconds", seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        phase_pipelined_fp64(a, As64, cg_its, totals)
        show("20f.seconds", seconds=time.perf_counter() - t0)
    except BaseException:
        stop_demos(demos)
        raise
    wait_demos(demos)
    t0 = time.perf_counter()
    check_sstep_demos(demos, deflated_run, dev)
    show("20e.seconds", seconds=time.perf_counter() - t0, demos_seconds=demos.seconds)
    show("20.sstep", launches=totals)
    return totals


# ---------------------------------------------------------------- phase 21
SPMV_WELL_NX = 1024  # 21a's WELL cases: the 3200^2 WELL assembly would pass the phase's time
EIG_NX = 1024        # 21d, 21e: transposed() takes 12.6-15.6 s at 3200^2 (PERF.md)
EIG_CONVERGE_NX = 48  # 21e: the reference's demo converges here on the CPU (69 iterations)
EXPM_T, EXPM_M = -1.0, 48
EXPM_TOL = 1e-10     # 21b: vs the exact Kronecker propagator, relative L2
LOGDET_M, LOGDET_PROBES = 32, 16
SLQ_PLAIN_TOL = 1e-12  # 21c: the same probes through the plain versions, relative
SVD_M, EIG_K, CHEB_DEG, EIG_MAXITER = 48, 4, 16, 100
ARNOLDI_M = 60
SPMV_ITERS = 100
# 21a: the demo's flags, its grid, the kernel counter its applies move and
# the tolerance of its norm(y) against the same chain through the plain versions
SPMV_DEMOS = (
    ("dia", ["--dia"], NX, "dia", 1e-12),
    ("dia_sym_fp32", ["--dia", "--symmetric", "--fp32"], NX, "dia_sym", 1e-5),
    ("auto", ["--format", "auto"], NX, "dia_ds", 1e-12),
    ("well_fp32", ["--format", "well", "--fp32"], SPMV_WELL_NX, "well", 1e-5),
    ("well_ds", ["--format", "well_ds"], SPMV_WELL_NX, "well_ds", 1e-12),
)
SPMV_DEMO_TIMEOUT = 300  # seconds, the five demos one after another


@contextlib.contextmanager
def plain_kernels():
    """The operator applies of ``DistMatrix`` run the plain torch versions
    of the single-RHS kernels while the block is inside."""
    swaps = {"spmv_dia_stacked": spmv_dia_stacked_plain,
             "spmv_dia_ds_stacked": spmv_dia_ds_stacked_plain,
             "spmv_well_stacked": spmv_well_rows_plain,
             "spmv_well_ds_stacked": spmv_well_ds_rows_plain}
    saved = {name: getattr(dist_matrix_mod, name) for name in swaps}
    for name, fn in swaps.items():
        setattr(dist_matrix_mod, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(dist_matrix_mod, name, fn)


class DemoChain:
    """Commands run one after another in a thread (21a's demos, so that no
    two share the card), each writing work/<name>.log."""

    def __init__(self, work: Path, cmds: dict):
        self.work, self.cmds, self.codes, self.current = work, cmds, {}, None
        self.stopped, self.t0, self.seconds = False, time.perf_counter(), 0.0
        self.lock = threading.Lock()  # a command starts only while not stopped
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        for name, cmd in self.cmds.items():
            with open(self.work / f"{name}.log", "w") as log:
                with self.lock:
                    if self.stopped:
                        return
                    self.current = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                                    cwd=Path(__file__).resolve().parent)
                left = SPMV_DEMO_TIMEOUT - (time.perf_counter() - self.t0)
                try:
                    self.codes[name] = self.current.wait(timeout=max(left, 1))
                except subprocess.TimeoutExpired:
                    self.stop_current()
                    self.codes[name] = self.current.wait()

    def stop_current(self):
        with self.lock:
            self.stopped = True
            if self.current is not None and self.current.poll() is None:
                self.current.kill()

    def stop(self):
        self.stop_current()
        self.thread.join(timeout=60)
        if self.thread.is_alive():
            fail("21a: the demo thread did not stop")

    def join(self):
        self.thread.join(timeout=SPMV_DEMO_TIMEOUT + 5)
        self.seconds = time.perf_counter() - self.t0
        self.stop()


def spmv_demo_lines(out: str) -> dict:
    """A demo_spmv run's printed result: ms/apply, GFLOP/s and norm(y)."""
    line = next(ln for ln in out.splitlines() if ln.startswith("SpMV:"))
    return dict(ms_per_apply=float(line.split()[1]), gflops=float(line.split()[3]),
                norm_y=float(out.split("norm(y) = ")[1].split()[0]))


def spmv_operators(a_lap, A64, dev) -> dict:
    """21a: the operator each demo builds, built here the same way (A64 is
    the vanilla float64 one)."""
    a_well = create_laplace_2d(SPMV_WELL_NX, SPMV_WELL_NX)
    ops = {}
    for name, flags, nx, _key, _tol in SPMV_DEMOS:
        a = a_lap if nx == NX else a_well
        if name == "dia":
            ops[name] = (a, A64)
            continue
        fp32 = "--fp32" in flags
        fmt = flags[flags.index("--format") + 1] if "--format" in flags else "dia"
        ops[name] = (a, build_dist_matrix(a, symmetric="--symmetric" in flags,
                                          dtype=np.float32 if fp32 else np.float64,
                                          local_format=fmt, device=dev))
    return ops


def phase_spmv_demos(chain_run: DemoChain, ops: dict) -> dict:
    """21a, after the demos: each exited 0; in this process the same
    operator's warm-up and SPMV_ITERS chained applies launch its kernel
    exactly SPMV_ITERS + 1 times and nothing else; the chain through the
    plain versions gives the demo's norm(y) (and this process's kernel
    chain's) within the case's tolerance. Each demo's ms/apply is printed
    beside this process's chained kernel ms/apply (CUDA events). Returns the
    launch counts."""
    from spmv_torch.demos.demo_spmv import SCALE, chain

    totals = {}
    for name, flags, nx, key, tol in SPMV_DEMOS:
        out = (chain_run.work / f"21a_{name}.log").read_text()
        code = chain_run.codes.get(f"21a_{name}")
        if code != 0:
            fail(f"21a demo_spmv {' '.join(flags)}: exit {code}: {out[-2000:]}")
        printed = spmv_demo_lines(out)
        a, A = ops[name]
        dtype = np.float32 if "--fp32" in flags else np.float64
        scale = float(dtype(SCALE))
        x = A.to_dist(gaussian_bump(a.nrows, dtype=dtype))
        torch.cuda.synchronize()
        reset_counters()
        chain(A, x, 1, scale)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y = chain(A, x, SPMV_ITERS, scale)
        end.record()
        end.synchronize()
        got = single_counts()
        launch_gate(f"21a {name}", got, {key: SPMV_ITERS + 1})
        add_counts(totals, got)
        with plain_kernels():
            y_plain = chain(A, x, SPMV_ITERS, scale)
        norm_k = float(np.linalg.norm(A.from_dist(y)))
        norm_p = float(np.linalg.norm(A.from_dist(y_plain)))
        if not np.isfinite(norm_k):
            fail(f"21a {name}: non-finite norm(y)")
        diff_demo = abs(printed["norm_y"] - norm_p) / norm_p
        diff_here = abs(norm_k - norm_p) / norm_p
        show("21a.demo_spmv", demo=name, cmd=" ".join(chain_run.cmds[f"21a_{name}"][1:]),
             rows=a.nrows, nnz=a.nnz, local_format=A.local_format, printed=printed,
             norm_plain_chain=norm_p, norm_kernel_chain=norm_k,
             rel_diff_demo_vs_plain=diff_demo, rel_diff_kernel_vs_plain=diff_here,
             tolerance=tol, kernel_chain_ms_per_apply=start.elapsed_time(end) / SPMV_ITERS,
             launches=got, seconds_all_demos=chain_run.seconds)
        if not (diff_demo <= tol and diff_here <= tol):
            fail(f"21a {name}: norm(y) demo {printed['norm_y']}, kernel chain {norm_k}, "
                 f"plain chain {norm_p}")
        del y, y_plain, x
    return totals


def laplace_1d_expm(n: int, t: float, u: np.ndarray) -> np.ndarray:
    """exp(t T) u for T = tridiag(-1, 2, -1) of order n, from T's sine
    eigenbasis: s_k(i) = sqrt(2/(n+1)) sin(i k pi/(n+1)), mu_k = 2 - 2
    cos(k pi/(n+1))."""
    i = np.arange(1, n + 1)
    S = np.sqrt(2.0 / (n + 1)) * np.sin(np.outer(i, i) * np.pi / (n + 1))
    mu = 2.0 - 2.0 * np.cos(i * np.pi / (n + 1))
    return S @ (np.exp(t * mu) * (S @ u))


def phase_expm(As64) -> dict:
    """21b: expm_multiply(t = EXPM_T, m = EXPM_M) on phase 4's symmetric
    float64 NX^2 DIA operator, v = u (x) u with u a 1-D Gaussian bump. The
    2-D Laplacian is T (x) I + I (x) T, so exp(tA)(u (x) u) = (e^{tT}u) (x)
    (e^{tT}u), exact on the host. Gates: relative error <= EXPM_TOL, the same
    run through the plain version within 1e-13, exactly EXPM_M dia_sym_spmv
    launches."""
    from spmv_torch.solvers.funm import expm_multiply

    u = gaussian_bump(NX)
    v = As64.to_dist(np.kron(u, u))
    eu = laplace_1d_expm(NX, EXPM_T, u)
    exact = np.kron(eu, eu)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    y, est = expm_multiply(As64.matvec, v, t=EXPM_T, m=EXPM_M)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = single_counts()
    launch_gate("21b expm", got, {"dia_sym": EXPM_M})
    yk = As64.from_dist(y, side="col")
    del y
    torch.cuda.empty_cache()

    def plain(p):
        return spmv_dia_stacked_plain(As64.local_dia_data, p, As64.dia_offsets, True)

    yp, _ = expm_multiply(plain, v, t=EXPM_T, m=EXPM_M)
    yp = As64.from_dist(yp, side="col")
    torch.cuda.empty_cache()
    err, vs_plain = rel_l2(yk, exact), rel_l2(yk, yp)
    show("21b.expm", matrix=f"laplace2d {NX}^2 symmetric dia float64", t=EXPM_T, m=EXPM_M,
         rel_err_vs_exact=err, err_est=est, rel_diff_vs_plain=vs_plain, seconds=seconds,
         launches=got)
    if not (err <= EXPM_TOL and vs_plain <= 1e-13):
        fail(f"21b: expm error {err:.3e} (<= {EXPM_TOL}), vs plain {vs_plain:.3e}")
    return got


def run_eig_demo(argv, a, A, tag):
    """demo_eig's mode on this process's operator (``demo_eig.run``),
    counters zeroed just before: its printed lines, result and launches."""
    from spmv_torch.demos import demo_eig
    from spmv_torch.utils.timing import PhaseTimer

    args = demo_eig.parse_args(argv + ["--device", A.device.type])
    timer = PhaseTimer()
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    lines, result = demo_eig.run(args, a, A, timer)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = single_counts()
    for line in lines:
        print(f"# {tag} {line}", flush=True)
    return lines, result, got, seconds


def phase_logdet(a, A64) -> dict:
    """21c: demo_eig --lap2d NX --logdet LOGDET_M --probes LOGDET_PROBES on
    the vanilla float64 DIA operator: 1 + probes * m dia_spmv launches; the
    same probes through the plain version give the same estimate within
    SLQ_PLAIN_TOL. The distance to the exact log det, sum over (i, j) of
    log(4 - 2 cos(i pi/(NX+1)) - 2 cos(j pi/(NX+1))), is printed in standard
    errors, not gated: the reference's own 16-probe, m = 32 estimate at
    512^2 sits 0.9-2.4 standard errors above the exact value on four seeds
    (tests/slq_bias_reference.py), a quadrature bias above one sigma."""
    from spmv_torch.solvers.funm import slq_logdet

    argv = ["--lap2d", str(NX), "--logdet", str(LOGDET_M), "--probes", str(LOGDET_PROBES)]
    _lines, (mean, se), got, seconds = run_eig_demo(argv, a, A64, "21c")
    launch_gate("21c logdet", got, {"dia": 1 + LOGDET_M * LOGDET_PROBES})

    def plain(p):
        return spmv_dia_stacked_plain(A64.local_dia_data, p, A64.dia_offsets, False)

    mean_p, se_p = slq_logdet(plain, A64.to_dist(np.ones(a.nrows)),
                              torch.Generator().manual_seed(0), n_probes=LOGDET_PROBES,
                              m=LOGDET_M)
    c = 2.0 * np.cos(np.arange(1, NX + 1) * np.pi / (NX + 1))
    exact = float(np.sum(np.log(4.0 - c[:, None] - c[None, :])))
    vs_plain = abs(mean - mean_p) / abs(mean_p)
    show("21c.logdet", matrix=f"laplace2d {NX}^2 dia float64", m=LOGDET_M,
         probes=LOGDET_PROBES, logdet=mean, stderr=se, plain_logdet=mean_p, plain_stderr=se_p,
         rel_diff_vs_plain=vs_plain, exact=exact, sigmas_from_exact=(mean - exact) / se,
         seconds=seconds, launches=got)
    if not vs_plain <= SLQ_PLAIN_TOL:
        fail(f"21c: the plain versions' estimate {mean_p} differs from {mean}")
    return got


def laplace_2d_eigs(n: int) -> np.ndarray:
    """The n^2 eigenvalues of the n x n 5-point Laplacian, ascending."""
    c = 2.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))
    return np.sort((c[:, None] + c[None, :]).ravel())


def eig_operator(argv, dev):
    """demo_eig's host matrix and operator for ``argv`` on ``dev`` (host
    work)."""
    from spmv_torch.demos import demo_eig

    args = demo_eig.parse_args(argv + ["--device", dev.type])
    a = demo_eig.load_matrix(args)
    return a, demo_eig.build_operator(args, a)


SVD_ARGV = ["--lap2d", str(EIG_NX), "--svd", str(SVD_M), "-k", str(EIG_K)]
ARNOLDI_ARGV = ["--convdiff", str(EIG_NX), "--arnoldi", str(ARNOLDI_M)]


def lobpcg_argv(nx: int) -> list:
    return ["--lap2d", str(nx), "-k", str(EIG_K), "--cheb", str(CHEB_DEG), "--maxiter",
            str(EIG_MAXITER)]


def eig_operators(dev) -> dict:
    """21d-21f's operators, built while the demos run: the 1024^2 vanilla
    float64 DIA operator with its transposed() (21d), the LOBPCG operators
    at EIG_NX^2 and EIG_CONVERGE_NX^2 (21e) and the convection-diffusion
    ELL operator (21f)."""
    ops = {"21d": eig_operator(SVD_ARGV, dev), "21e": eig_operator(lobpcg_argv(EIG_NX), dev),
           "21e2": eig_operator(lobpcg_argv(EIG_CONVERGE_NX), dev),
           "21f": eig_operator(ARNOLDI_ARGV, dev)}
    ops["21d"][1].transposed()  # cached: 21d's run finds it built
    return ops


def phase_svd(a, A) -> dict:
    """21d: demo_eig --lap2d EIG_NX --svd SVD_M -k EIG_K (vanilla float64
    DIA, A^T by transposed()): 1 + 2m + 1 dia_spmv launches (the warm-up, m
    of A, m + 1 of A^T); each sigma_j at most the closed-form sigma_j (1 +
    1e-12) (Golub-Kahan Ritz values are lower bounds); each certificate
    equal to the host |A^T u - s v| within the reference test's 1e-8
    relative (tests/test_svds.py:35), or both under its converged floor
    1e-10 sigma_0."""
    _lines, r, got, seconds = run_eig_demo(SVD_ARGV, a, A, "21d")
    launch_gate("21d svd", got, {"dia": 2 + 2 * SVD_M})
    want = laplace_2d_eigs(EIG_NX)[::-1][: len(r.s)]
    at = a.transpose()
    host = np.array([np.linalg.norm(at.matvec(A.from_dist(r.u[j], side="row"))
                                    - r.s[j] * A.from_dist(r.v[j], side="col"))
                     for j in range(len(r.s))])
    show("21d.svd", matrix=f"laplace2d {EIG_NX}^2 dia float64", m=SVD_M, steps=r.steps,
         sigma=r.s.tolist(), closed_form=want.tolist(), certificates=r.residuals.tolist(),
         host_residuals=host.tolist(), seconds=seconds, launches=got)
    if not np.all(r.s <= want * (1 + 1e-12)):
        fail(f"21d: sigma {r.s} above the closed form {want}")
    if not np.all(np.abs(r.residuals - host) <= 1e-8 * host + 1e-10 * r.s[0]):
        fail(f"21d: certificates {r.residuals} against host residuals {host}")
    return got


def lobpcg_block_timing(A, dev) -> tuple[str, dict]:
    """dia_spmm where LOBPCG runs it (21e): float64 at EIG_NX^2, nrhs
    EIG_K, the operator's own data scaled by 1/9: device time of kernel and
    plain version, the chained time beside, cuSPARSE SpMM on the same block
    (device time), the bytes bound (K + 2 nrhs) npad 8 B."""
    a = create_laplace_2d(EIG_NX, EIG_NX)
    data = A.local_dia_data / 9.0
    xs = lanes_block(torch.Generator(device=dev).manual_seed(23), data.shape[1], EIG_K,
                     torch.float64, dev)

    def kernel(v):
        return spmm_dia_cuda.spmm_dia_stacked(data, v, A.dia_offsets, False)

    def plain(v):
        return spmm_dia_stacked_plain(data, v, A.dia_offsets, False)

    chained_k, chained_p, runs_k, runs_p = time_in_turns(kernel, plain, xs, iters_p=10)
    lib = library_block_ms(a, dev, 1.0 / 9.0, np.float64, EIG_K, timer=yardstick_ms)
    npad = data.shape[1] * 128
    nbytes = (len(A.dia_offsets) + 2 * EIG_K) * npad * 8
    row = dict(ms=device_ms(kernel, xs), plain_ms=yardstick_ms(plain, xs, 5),
               library_ms=min(lib["row_major"], lib["column_major"]),
               bound_ms=bound_ms(nbytes), bytes=nbytes, nrhs=EIG_K, dtype="float64",
               timing="device", chained_ms=chained_k, plain_chained_ms=chained_p)
    matrix = f"float64 laplace2d {EIG_NX}^2 nrhs {EIG_K}, LOBPCG (demo_eig)"
    show("21e.timing", kernel="dia_spmm", matrix=matrix, **row, ms_runs=runs_k,
         plain_ms_runs=runs_p, library_block_ms=lib,
         **plan_fields(data, A.dia_offsets, False, EIG_K))
    return matrix, row


def lobpcg_case(nx: int, a, A, dev, max_abs, tag):
    """demo_eig --lap2d nx -k EIG_K --cheb CHEB_DEG --maxiter EIG_MAXITER
    on the vanilla float64 DIA operator A (matmat: dia_spmm at nrhs EIG_K);
    first dia_spmm against its plain version at that shape.
    Gates: 1 + 32 dia_spmv launches (the warm-up, the Lanczos bound) and 1 +
    (CHEB_DEG + 1) k dia_spmm launches; theta_j at least the closed-form
    lambda_j (1 - 1e-12) (Rayleigh-Ritz values are upper bounds); the
    demo's printed host residuals (four digits) equal to LOBPCG's own
    within 1e-3 relative, or within 1e-9 where both sit at the rounding
    floor (eps |A| / max|theta| is 2e-11 at 1024^2). Returns (result, counts,
    closed-form eigenvalues)."""
    xs = (lanes_block(torch.Generator(device=dev).manual_seed(22), A.local_dia_data.shape[1],
                      EIG_K, torch.float64, dev),)
    block_check(max_abs, tag, "dia_spmm", f"laplace2d {nx}^2", "float64", EIG_K,
                lambda x: spmm_dia_cuda.spmm_dia_stacked(A.local_dia_data, x, A.dia_offsets,
                                                         False),
                lambda x: spmm_dia_stacked_plain(A.local_dia_data, x, A.dia_offsets, False),
                lambda x: spmv_dia_cuda.spmv_dia_stacked(A.local_dia_data, x, A.dia_offsets,
                                                         False), xs, TOL_KERNEL["float64"],
                **plan_fields(A.local_dia_data, A.dia_offsets, False, EIG_K))
    del xs
    lines, res, got, seconds = run_eig_demo(lobpcg_argv(nx), a, A, tag)
    launch_gate(f"{tag} LOBPCG", got, {"dia": 33, "dia_spmm": 1 + (CHEB_DEG + 1)
                                        * res.iterations})
    theta = np.asarray(res.eigenvalues, np.float64)
    lam = laplace_2d_eigs(nx)[:EIG_K]
    scale = np.abs(theta).max()
    printed = np.array([float(ln.split("=")[-1]) for ln in lines[1:]])
    own = np.asarray(res.resid_norms, np.float64) / scale
    show(f"{tag}.lobpcg", matrix=f"laplace2d {nx}^2 dia float64", k=EIG_K, cheb=CHEB_DEG,
         maxiter=EIG_MAXITER, iterations=res.iterations, converged=res.converged,
         theta=theta.tolist(), closed_form=lam.tolist(), printed_host_residuals=printed.tolist(),
         lobpcg_residuals=own.tolist(), seconds=seconds, launches=got)
    if not np.all(theta >= lam * (1 - 1e-12)):
        fail(f"{tag}: Ritz values {theta} below the closed form {lam}")
    if not np.all(np.abs(printed - own) <= 1e-3 * own + 1e-9):
        fail(f"{tag}: printed host residuals {printed} against LOBPCG's {own}")
    return res, got, lam


def phase_lobpcg(eig_ops, dev, max_abs) -> tuple[dict, tuple]:
    """21e at EIG_NX^2 (maxiter EIG_MAXITER; converged is reported, not
    gated: the reference stops short there on the CPU too) and at
    EIG_CONVERGE_NX^2, where the reference converges: converged, and each
    theta within tol * max|theta| of the closed form. Then the block
    kernel's timing row at EIG_NX^2."""
    _res, got, _lam = lobpcg_case(EIG_NX, *eig_ops["21e"], dev, max_abs, "21e")
    totals = dict(got)
    timing = lobpcg_block_timing(eig_ops["21e"][1], dev)
    res2, got2, lam2 = lobpcg_case(EIG_CONVERGE_NX, *eig_ops["21e2"], dev, max_abs, "21e2")
    add_counts(totals, got2)
    theta2 = np.asarray(res2.eigenvalues, np.float64)
    if not (res2.converged and np.all(np.abs(theta2 - lam2) <= 1e-6 * np.abs(theta2).max())):
        fail(f"21e at {EIG_CONVERGE_NX}^2: converged {res2.converged}, theta {theta2}, "
             f"closed form {lam2}")
    return totals, timing


def phase_arnoldi(a, A) -> dict:
    """21f: demo_eig --convdiff EIG_NX --arnoldi ARNOLDI_M (ELL: plain torch
    gathers, no kernel): every Ritz value inside the field of values' bound,
    |theta| <= sqrt(|A|_1 |A|_inf) (1 + 1e-6)."""
    _lines, r, got, seconds = run_eig_demo(ARNOLDI_ARGV, a, A, "21f")
    launch_gate("21f arnoldi", got, {})
    absa = CSRHost(a.rowptr, a.colind, np.abs(a.values), a.ncols)
    norm_inf = float(absa.matvec(np.ones(a.ncols)).max())
    norm_1 = float(absa.transpose().matvec(np.ones(a.nrows)).max())
    bound = np.sqrt(norm_1 * norm_inf)
    show("21f.arnoldi", matrix=f"convection-diffusion {EIG_NX}^2 ell float64", m=ARNOLDI_M,
         steps=r.steps, spectral_radius=r.spectral_radius, bound=bound,
         rightmost=[r.rightmost.real, r.rightmost.imag], seconds=seconds)
    if not np.all(np.abs(r.values) <= bound * (1 + 1e-6)):
        fail(f"21f: Ritz values past {bound}: {np.abs(r.values).max()}")
    return got


def phase_checkpoint(a_lap, A64, ckpt, dev) -> None:
    """21g: the NX^2 vanilla float64 DIA operator and an RCM'd
    fem_p1_2d(HALO_FEM) symmetric float32 WELL operator, saved before the
    demos were joined, load with the same bits on a matvec; a Jacobi-PCG
    on the FEM (rtol 1e-6) stopped at 50 iterations, saved and resumed
    from the saved x, converges; from_scipy -> build_dist_matrix (ELL, 4
    stacked shards) -> matvec matches scipy @ x within 1e-12."""
    from spmv_torch.interop import from_scipy, to_scipy
    from spmv_torch.io.checkpoint import load_dist_matrix, load_solver_state, save_solver_state

    (fem, F, paths, save_s) = ckpt
    t0 = time.perf_counter()
    loaded = [load_dist_matrix(p, device=dev) for p in paths]
    load_s = time.perf_counter() - t0
    for (a, A), B, name in zip(((a_lap, A64), (fem, F)), loaded, ("dia", "well")):
        x = A.to_dist(np.random.default_rng(24).standard_normal(a.nrows).astype(
            np.float64 if name == "dia" else np.float32))
        if not torch.equal(A.matvec(x), B.matvec(x)):
            fail(f"21g: the loaded {name} operator's matvec gave other bits")
    b = F.to_dist(gaussian_bump(fem.nrows, dtype=np.float32))
    jac = loaded[1].jacobi_preconditioner()
    part = cg(loaded[1].matvec, b, kmax=50, rtol=1e-6, preconditioner=jac)
    state = str(paths[1]).replace("fem_well", "fem_state")
    save_solver_state(state, loaded[1], part.x, iteration=part.iterations)
    vecs, it = load_solver_state(state, loaded[1])
    res = cg(loaded[1].matvec, b, x0=vecs["x"], kmax=20000, rtol=1e-6, preconditioner=jac)
    s = to_scipy(fem)
    xs = np.random.default_rng(25).standard_normal(fem.ncols)
    Ai = build_dist_matrix(from_scipy(s), n_devices=4, local_format="ell", device=dev)
    interop = rel_l2(Ai.from_dist(Ai.matvec(Ai.to_dist(xs))), s @ xs)
    show("21g.checkpoint", operators=[f"laplace2d {NX}^2 dia float64",
                                      f"fem_p1_2d({HALO_FEM}) rcm symmetric well float32"],
         save_s=save_s, load_s=load_s, matvec_same_bits=True, resumed_from_iteration=it,
         resumed_iterations=res.iterations, resumed_converged=res.converged,
         interop_rel_err=interop)
    if not (it == 50 and res.converged and interop <= 1e-12):
        fail(f"21g: resume from {it}: converged {res.converged}; interop {interop:.3e}")


def save_checkpoints(A64, dev) -> tuple:
    """21g's first half, host work while the demos run: the FEM operator and
    both operators' checkpoints under build/chip_smoke_demos."""
    from spmv_torch.io.checkpoint import save_dist_matrix

    fem, _ = rcm_reorder(fem_p1_2d(HALO_FEM), keep_best=True)
    F = build_dist_matrix(fem, symmetric=True, dtype=np.float32, local_format="well",
                          device=dev)
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_demos"
    paths = [str(work / "lap_dia.npz"), str(work / "fem_well.npz")]
    t0 = time.perf_counter()
    save_dist_matrix(paths[0], A64)
    save_dist_matrix(paths[1], F)
    return fem, F, paths, time.perf_counter() - t0


def phase_eig_spmv(a, As64, dev, max_abs) -> tuple[dict, dict]:
    """Phase 21: the spectral toolbox and demo_spmv. The five demo_spmv
    runs start first, one after another in a thread; this process builds
    its operators and writes the checkpoints (host work) meanwhile, joins
    the demos, then runs 21a's in-process gates and 21b-21g on the card.
    Returns (launch counts, {kernel: {shape: timing row}})."""
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_demos"
    work.mkdir(parents=True, exist_ok=True)
    demo = [sys.executable, "-m", "spmv_torch.demos.demo_spmv"]
    cmds = {f"21a_{name}": demo + ["--lap2d", str(nx), *flags, "--iters", str(SPMV_ITERS)]
            for name, flags, nx, _key, _tol in SPMV_DEMOS}
    chain_run = DemoChain(work, cmds)
    totals = {}
    try:
        t0 = time.perf_counter()
        A64 = build_dist_matrix(a, dtype=np.float64, local_format="dia", device=dev)
        ops = spmv_operators(a, A64, dev)
        ckpt = save_checkpoints(A64, dev)
        eig_ops = eig_operators(dev)
        show("21.host_seconds", seconds=time.perf_counter() - t0)
        chain_run.join()
        t0 = time.perf_counter()
        add_counts(totals, phase_spmv_demos(chain_run, ops))
        del ops
        show("21a.seconds", seconds=time.perf_counter() - t0, demos_seconds=chain_run.seconds)
        for tag, step in (("21b", lambda: phase_expm(As64)),
                          ("21c", lambda: phase_logdet(a, A64)),
                          ("21d", lambda: phase_svd(*eig_ops["21d"]))):
            t0 = time.perf_counter()
            add_counts(totals, step())
            show(f"{tag}.seconds", seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        got, (matrix, row) = phase_lobpcg(eig_ops, dev, max_abs)
        add_counts(totals, got)
        show("21e.seconds", seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        add_counts(totals, phase_arnoldi(*eig_ops["21f"]))
        show("21f.seconds", seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        phase_checkpoint(a, A64, ckpt, dev)
        show("21g.seconds", seconds=time.perf_counter() - t0)
    finally:
        chain_run.stop()
    show("21.eig_spmv", launches=totals)
    return totals, {"dia_spmm": {matrix: row}}


def dia_csr(A) -> CSRHost:
    """The host CSR of a one-shard DIA operator's stored entries."""
    k = len(A.dia_offsets)
    flat = interleaved_to_flat(A.local_dia_data[0], k).cpu().numpy().astype(np.float64)
    npad = flat.shape[1]
    rows = np.tile(np.arange(npad), k)
    cols = rows + np.repeat(np.asarray(A.dia_offsets), npad)
    vals = flat.reshape(-1)
    keep = (vals != 0) & (rows < A.nrows_global)
    return CSRHost.from_coo(rows[keep], cols[keep], vals[keep], A.nrows_global,
                            A.nrows_global)


def phase_amg_timing(head, dev, max_abs) -> dict:
    """Phase 18f (run with phase 10): device ms per apply (torch.profiler)
    of dia_spmv on the AMG levels 1 and 2 of 18a (800^2 and 200^2, K = 9),
    kernel, plain and the cuSPARSE yardstick, with their bytes bound and
    launches per PCG iteration; the bf16 DIA kernels at 3200^2 (bound at
    2-byte values) and dia_spmv / dia_spmm (nrhs 8) at K = 65 and 297 (the
    1-D interval levels' widths) on a random banded 1M-row matrix, each
    held against its plain version on the card first (bf16: BF16_TOL; the
    K > 64 ones TOL_KERNEL float32). Returns {kernel: {shape: row}} for the
    kernels JSON's other_shapes."""
    A, h = head
    applies = amg_cycle_applies(h)
    out = {"dia_spmv": {}, "dia_sym_spmv": {}, "dia_spmm": {}, "dia_sym_spmm": {}}
    for i in (1, 2):
        lvl = h.levels[i]
        La = lvl.A
        data, offs = La.local_dia_data, La.dia_offsets
        csr = dia_csr(La)
        norm = float(np.bincount(np.repeat(np.arange(csr.nrows), csr.row_nnz()),
                                 weights=np.abs(csr.values), minlength=csr.nrows).max())
        s = 0.9 / norm  # ||s A||_inf < 1: chained applies stay bounded
        sdata = data * s
        x2 = torch.zeros((La.row_lane_rows, 128), dtype=torch.float32, device=dev)
        x2.view(-1)[: La.nrows_global] = torch.as_tensor(
            gaussian_bump(La.nrows_global, dtype=np.float32), device=dev)

        def kernel(v, d=sdata, o=offs):
            return spmv_dia_cuda.spmv_dia_stacked(d, v, o, False)

        def plain(v, d=sdata, o=offs):
            return spmv_dia_stacked_plain(d, v, o, False)

        nbytes = (len(offs) + 2) * La.row_pad * 4
        row = dict(ms=device_ms(kernel, x2), plain_ms=yardstick_ms(plain, x2, 10),
                   library_ms=library_device_ms(csr, dev, s), bound_ms=bound_ms(nbytes),
                   bytes=nbytes, timing="device", rows=La.nrows_global, ndiags=len(offs),
                   launches_per_pcg_iteration=applies[i],
                   library="torch CSR @ x (cuSPARSE), same level operator")
        out["dia_spmv"][f"AMG level {i} ({La.nrows_global} rows, K={len(offs)})"] = row
        show("18f.timing", kernel="dia_spmv", matrix=f"AMG level {i} of laplace2d {NX}^2",
             **row)
    # bf16 storage at 3200^2
    a = create_laplace_2d(NX, NX)
    gen = torch.Generator(device=dev).manual_seed(181)
    for sym in (False, True):
        d = csr_to_dia(a, row_align=ROW_ALIGN, dtype=torch.bfloat16, symmetric=sym,
                       device=dev)
        d.data.mul_(1.0 / 9.0)
        data = d.data.unsqueeze(0)
        x = torch.zeros(d.nrows_pad, dtype=torch.bfloat16, device=dev)
        x[: a.nrows] = torch.as_tensor(gaussian_bump(a.nrows, dtype=np.float32), device=dev)
        x2 = x.view(-1, 128)
        for block in (False, True):
            kname = ("dia_sym_" if sym else "dia_") + ("spmm" if block else "spmv")
            wrapper, plain_fn = ((spmm_dia_cuda.spmm_dia_stacked, spmm_dia_stacked_plain)
                                 if block else
                                 (spmv_dia_cuda.spmv_dia_stacked, spmv_dia_stacked_plain))
            kernel = functools.partial(wrapper, data, offsets=d.offsets, symmetric=sym)
            plain = functools.partial(plain_fn, data, offsets=d.offsets, symmetric=sym)
            xs = (torch.randn((x2.shape[0], NRHS * 128), generator=gen, device=dev)
                  .to(torch.bfloat16) if block else x2)
            y_k = kernel(xs)
            torch.cuda.synchronize()
            y_p = plain(xs)
            _, err, mabs = check_close(f"18f {kname} bf16", y_k.float(), y_p.float(), BF16_TOL)
            # the Laplacian's values are exact in bf16 and every product of
            # two bf16 values is exact in fp32: kernel and plain round the
            # same fp32 sums once
            if not torch.equal(y_k, y_p):
                fail(f"18f {kname} bf16 laplace2d {NX}^2: not bit for bit the plain version")
            max_abs[kname] = max(max_abs[kname], mabs)
            nrhs = NRHS if block else 1
            nbytes = (d.ndiags + 2 * nrhs) * d.nrows_pad * 2
            lib_ms, lib_text = library_bf16(a, dev, 1.0 / 9.0, nrhs)
            row = dict(ms=device_ms(kernel, xs), plain_ms=yardstick_ms(plain, xs, 5),
                       library_ms=lib_ms, bound_ms=bound_ms(nbytes), bytes=nbytes,
                       timing="device", dtype="bfloat16", nrhs=nrhs,
                       rel_l2_vs_plain=err, max_abs_vs_plain=mabs, bit_equal_to_plain=True,
                       library=lib_text, **plan_fields(d.data, d.offsets, sym, nrhs, block))
            out[kname][f"bf16 laplace2d {NX}^2" + (f" nrhs {NRHS}" if block else "")] = row
            show("18f.timing", kernel=kname, matrix=f"laplace2d {NX}^2", **row)
        del d, data
    # K > 64: random banded, 1M rows, each storage type; the symmetric
    # kernel on each band's lower half
    nr = 8192
    tols = {**TOL_KERNEL, "bfloat16": BF16_TOL}
    for k in (65, 297):
        full = tuple(range(-(k // 2), k - k // 2))
        for dt in (torch.float32, torch.float64, torch.bfloat16):
            dname = str(dt).split(".")[1]
            x2 = torch.randn((nr, 128), generator=gen, device=dev).to(dt)
            xs = torch.randn((nr, NRHS * 128), generator=gen, device=dev).to(dt)
            for kname, sym, v in (("dia_spmv", False, x2), ("dia_spmm", False, xs),
                                  ("dia_sym_spmv", True, x2)):
                offs = tuple(o for o in full if o <= 0) if sym else full
                data = (torch.randn((1, nr, len(offs) * 128), generator=gen, device=dev)
                        / k).to(dt)
                wrapper, plain_fn = ((spmm_dia_cuda.spmm_dia_stacked, spmm_dia_stacked_plain)
                                     if kname == "dia_spmm" else
                                     (spmv_dia_cuda.spmv_dia_stacked, spmv_dia_stacked_plain))
                kernel = functools.partial(wrapper, data, offsets=offs, symmetric=sym)
                plain = functools.partial(plain_fn, data, offsets=offs, symmetric=sym)
                y_k = kernel(v)
                torch.cuda.synchronize()
                if not torch.equal(kernel(v), y_k):
                    fail(f"18f {kname} K={k} {dname}: a second apply gave other bits")
                _, err, mabs = check_close(f"18f {kname} K={k} {dname}", y_k.float(),
                                           plain(v).float(), tols[dname])
                max_abs[kname] = max(max_abs[kname], mabs)
                nrhs = v.shape[1] // 128
                nbytes = (len(offs) + 2 * nrhs) * nr * 128 * data.element_size()
                row = dict(ms=device_ms(kernel, v), plain_ms=yardstick_ms(plain, v, 1),
                           library_ms=None, bound_ms=bound_ms(nbytes), bytes=nbytes,
                           timing="device", rows=nr * 128, ndiags=len(offs), nrhs=nrhs,
                           dtype=dname, rel_l2_vs_plain=err, max_abs_vs_plain=mabs,
                           library="none: random dense band, timed for the kernel alone",
                           **plan_fields(data, offs, sym, nrhs, kname == "dia_spmm"))
                band = "lower half of random band" if sym else "random band"
                out[kname][f"{dname} {band} K={k}, {nr * 128} rows"
                           + (f" nrhs {NRHS}" if nrhs > 1 else "")] = row
                show("18f.timing", kernel=kname, matrix=f"{band} K={k}", **row)
                del data
    return out


def library_bf16(a: CSRHost, dev, scale: float, nrhs: int) -> tuple:
    """(device ms, description) of one torch CSR @ x (nrhs 1) or @ X on
    bfloat16 values, or (None, torch's own error text) where torch refuses
    it on the card."""
    m = csr_tensor(a, dev, scale)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        mb = torch.sparse_csr_tensor(m.crow_indices(), m.col_indices(),
                                     m.values().to(torch.bfloat16), size=m.shape)
    shape = (a.ncols,) if nrhs == 1 else (a.ncols, nrhs)
    x0 = torch.randn(shape, device=dev).to(torch.bfloat16)
    what = f"torch CSR @ {'x' if nrhs == 1 else 'X'}, bfloat16 values"
    try:
        mb @ x0
        torch.cuda.synchronize()
    except RuntimeError as exc:  # torch's refusal is the finding
        return None, f"{what}: {str(exc).splitlines()[0]}"
    ms = device_ms(lambda v: mb @ v, x0)
    del m, mb
    return ms, f"{what} (cuSPARSE), device time"


PARENT_PAIRS = 10  # --parent: chained-event pairs a case, in turns


def amg_level_shapes(dev) -> list:
    """(matrix, offsets, rows) of the vanilla DIA levels below the finest in
    phase 18a's hierarchy on the NX^2 Laplacian: the shapes dia_spmv runs at
    inside the AMG cycle (800^2 and 200^2, K = 9)."""
    a = create_laplace_2d(NX, NX)
    A = build_dist_matrix(a, n_devices=1, dtype=np.float32, local_format="dia", device=dev)
    h = amg_setup(a, A, **AMG_KW)
    return [(f"AMG level {i} of laplace2d {NX}^2", tuple(lvl.A.dia_offsets),
             lvl.A.nrows_global) for i, lvl in enumerate(h.levels)
            if i > 0 and lvl.A.local_format == "dia" and not lvl.A.symmetric]


def parent_cases(amg_shapes=()) -> list:
    """(kernel, matrix, offsets, symmetric, nrhs, rows) that ``phase_parent``
    times: the shapes the main path runs the four DIA kernels at — 3200^2
    (phases 4, 6 and 18), 1024^2 (13, 16 and 18b-c; phase 16d's
    block_cg_dia runs dia_sym_spmm there at nrhs 8), 512^2 (16 and 18e),
    the AMG levels of ``amg_shapes`` (``amg_level_shapes``) — phase 18f's
    wide bands on 1M rows, and dia_sym_spmm at nrhs 3 and 11."""
    def lap(n):
        return (-n, -1, 0, 1, n)

    def band(k):
        return tuple(range(-(k // 2), k - k // 2))

    def lower(offs):
        return tuple(o for o in offs if o <= 0)

    out = [("dia_spmv", f"laplace2d {NX}^2", lap(NX), False, 1, NX * NX)]
    out += [("dia_spmv", matrix, offs, False, 1, rows) for matrix, offs, rows in amg_shapes]
    for k in (65, 297):
        out.append(("dia_spmv", f"random band K={k}", band(k), False, 1, 8192 * 128))
    for n in (NX, AMG_SYM_NX):
        out.append(("dia_sym_spmv", f"laplace2d {n}^2", lower(lap(n)), True, 1, n * n))
    for k in (65, 297):
        out.append(("dia_sym_spmv", f"lower half of random band K={k}", lower(band(k)),
                    True, 1, 8192 * 128))
    out.append(("dia_spmm", f"laplace2d {NX}^2", lap(NX), False, 1, NX * NX))
    for n in (NX, REFINE_NX, BLOCK_NX):
        out.append(("dia_spmm", f"laplace2d {n}^2", lap(n), False, NRHS, n * n))
    for k in (65, 297):
        out.append(("dia_spmm", f"random band K={k}", band(k), False, NRHS, 8192 * 128))
    for n, nrhs in ((NX, NRHS), (REFINE_NX, NRHS), (REFINE_NX, 3), (REFINE_NX, 11)):
        out.append(("dia_sym_spmm", f"laplace2d {n}^2", lower(lap(n)), True, nrhs, n * n))
    return out


def parent_args(kname, offs_dev, plan, table, nrhs) -> tuple:
    """The parent's arguments of ``kname`` between (data, x, y,
    npad, K) and (nshards, stream): dia_spmv and dia_sym_spmm read the
    offsets on the card, the tile kernels (dia_sym_spmv, dia_spmm) a window
    plan, whose table layout this tree keeps."""
    if kname == "dia_spmv":
        return (offs_dev.data_ptr(),)
    if kname == "dia_sym_spmm":
        return (offs_dev.data_ptr(), nrhs)
    tile = (table.data_ptr(), plan.rows, plan.smem_bytes)
    return tile + ((nrhs,) if kname == "dia_spmm" else ())


def phase_parent(parent: Path, dev, cases=None, pairs: int = PARENT_PAIRS) -> list:
    """``--parent DIR``: this tree's four DIA kernels against the parent's
    (DIR's library, built from DIR's csrc/ by DIR's _build.py and called with
    its own argument list, ``parent_args``; this tree's through the entry
    its ``route`` names), in float32, float64 and bfloat16, on ``cases``
    (default ``parent_cases`` with the AMG levels of ``amg_level_shapes``).
    Both are called straight through their libraries, so the two chains
    carry the same host work. Random data in [-1, 1) / (2K) (||A||_inf < 1:
    chained applies stay bounded) and x from a seed. Each case: the same
    bits as the parent's apply, and for dia_sym_spmm every column the bits
    of this tree's dia_sym_spmv on it (gated once every case is timed: the
    sums are the same operations in the same order); ``pairs`` pairs of
    chained CUDA events over 100 applies, parent and new alternating (parent
    first, then new first); device time (``device_ms``) in turns parent,
    new, new, parent; the bytes bound; the route and, for the tile kernel,
    its plan. Returns the rows."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", Path(parent) / "spmv_torch" / "_build.py")
    pb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pb)
    plib, lib = pb.load_library(), _build.load_library()
    if cases is None:
        t0 = time.perf_counter()
        amg_shapes = amg_level_shapes(dev)
        show("p.amg_levels", levels=[dict(matrix=m, offsets=list(o), rows=r)
                                     for m, o, r in amg_shapes],
             seconds=time.perf_counter() - t0)
        cases = parent_cases(amg_shapes)
    gen = torch.Generator(device=dev).manual_seed(808)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows_out = []
    for kname, matrix, offs, sym, nrhs, nrows in cases:
        npad = -(-nrows // ROW_ALIGN) * ROW_ALIGN
        k = len(offs)
        block = kname in ("dia_spmm", "dia_sym_spmm")
        for dt in (torch.float32, torch.float64, torch.bfloat16):
            tag = spmv_dia_cuda.DTYPES[dt]
            data = ((torch.rand((npad // 128, k * 128), generator=gen, device=dev) * 2 - 1)
                    / (2 * k)).to(dt)
            x0 = torch.randn((npad // 128, nrhs * 128), generator=gen, device=dev).to(dt)
            offs_dev = spmv_dia_cuda.device_offsets(offs, dev)
            plan, table = spmv_dia_cuda.device_window_plan(offs, sym, nrhs, dt, dev)
            r = spmv_dia_cuda.route(offs, sym, block, dt)
            name, args, _ = spmv_dia_cuda.entry(r, offs, sym, block, nrhs, dt, dev)
            pfn, nfn = getattr(plib, f"{kname}_{tag}"), getattr(lib, name)
            pargs = parent_args(kname, offs_dev, plan, table, nrhs)

            def old(v, pfn=pfn, data=data, pargs=pargs):
                y = torch.empty_like(v)
                rc = pfn(data.data_ptr(), v.data_ptr(), y.data_ptr(), npad, k, *pargs, 1,
                         stream)
                if rc != 0:
                    fail(f"parent {kname}_{tag} failed: CUDA error {rc}")
                return y

            def new(v, nfn=nfn, data=data, args=args, name=name):
                y = torch.empty_like(v)
                rc = nfn(data.data_ptr(), v.data_ptr(), y.data_ptr(), npad, k, *args, 1,
                         stream)
                if rc != 0:
                    fail(f"{name} failed: CUDA error {rc}")
                return y

            y_new = new(x0)
            same = bool(torch.equal(old(x0), y_new))
            columns_same = None
            if kname == "dia_sym_spmm":
                columns_same = all(
                    torch.equal(yc, spmv_dia_cuda.spmv_dia_stacked(data.unsqueeze(0), xc,
                                                                   offs, True))
                    for xc, yc in zip(columns(x0), columns(y_new)))
            chained = {"parent": [], "new": []}
            for i in range(pairs):
                for who in (("parent", "new") if i % 2 == 0 else ("new", "parent")):
                    f = old if who == "parent" else new
                    chained[who].append(1e3 * bench_chained(f, x0, iters=100))
            dev_runs = [device_ms(f, x0) for f in (old, new, new, old)]
            nbytes = (k + 2 * nrhs) * npad * data.element_size()
            row = dict(kernel=kname, matrix=matrix, nrhs=nrhs, dtype=str(dt).split(".")[1],
                       parent_ms=float(np.mean(chained["parent"])),
                       new_ms=float(np.mean(chained["new"])),
                       new_faster_in_pairs=sum(n < p for p, n in zip(chained["parent"],
                                                                      chained["new"])),
                       pairs=pairs,
                       parent_device_ms=(dev_runs[0] + dev_runs[3]) / 2,
                       new_device_ms=(dev_runs[1] + dev_runs[2]) / 2,
                       bound_ms=bound_ms(nbytes), bytes=nbytes,
                       parent_runs_ms=chained["parent"], new_runs_ms=chained["new"],
                       device_runs_ms=dev_runs, same_bits_as_parent=same,
                       columns_equal_dia_sym_spmv=columns_same, entry=name,
                       route=dataclasses.asdict(r),
                       **({"window_plan": plan.summary()} if r.kernel == "tile" else {}))
            show("p.parent", **row)
            rows_out.append(row)
            del data, x0, y_new
    differ = [f"{r['kernel']} {r['matrix']} nrhs {r['nrhs']} {r['dtype']}"
              for r in rows_out if not r["same_bits_as_parent"]
              or r["columns_equal_dia_sym_spmv"] is False]
    if differ:
        fail(f"--parent: not the parent's bits, or a dia_sym_spmm column not "
             f"dia_sym_spmv's, on {differ}")
    return rows_out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None, metavar="DIR",
                    help="only time the four DIA kernels against DIR's (phase_parent)")
    args = ap.parse_args()
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
    if args.parent is not None:
        phase_parent(args.parent, dev)
        return 0

    t0 = time.perf_counter()
    a = create_laplace_2d(NX, NX)
    show("0.generate", rows=a.nrows, nnz=a.nnz, seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    max_abs = phase_kernels(a, dev)
    show("3.seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    counts, its_per_s, plain_solves, As64 = phase_main_path(a, dev)
    show("4.seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_halo(dev)
    show("5.seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    times = phase_timing(a, dev)
    show("6.cg", it_per_s=its_per_s)
    show("6.seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_cg_update(a, dev)
    show("22.seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_symgs(dev)
    show("23.seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_dia_stream(dev)
    show("24.seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_poisson2d(dev)
    show("25.seconds", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    max_abs["spmv_well"], a4, w4 = phase_well_kernel(dev)
    show("7.seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    (counts["well"], fem_its, a_fem, A_fem, fem_abs, fem_fp64,
     fem_jacobi_its) = phase_fem_main_path(dev)
    max_abs["spmv_well"] = max(max_abs["spmv_well"], fem_abs)
    show("8.seconds", seconds=time.perf_counter() - t0, it_per_s=fem_its)
    t0 = time.perf_counter()
    phase_well_halo(dev)
    show("9.seconds", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    w4ds = phase_ds_kernels(a, a4, w4, dev)
    # every DS comparison is bit for bit (ds_compare fails otherwise)
    max_abs.update(dia_ds_spmv=0.0, well_ds_spmv=0.0)
    show("11.seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    ds_counts, per_iter, A_fem_ds = phase_ds_main_path(a, a_fem, fem_fp64, dev)
    counts.update(ds_counts)
    show("12.seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_refine(dev)
    show("13.seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_ds_halo(dev)
    show("14.seconds", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    block_abs, d32 = phase_block_kernels(a, w4, w4ds, dev)
    max_abs.update(block_abs)
    show("15.seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    block_counts, circuit_ops = phase_block_path(dev, max_abs)
    counts.update(block_counts)
    show("16.seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_block_halo(dev)
    show("17.seconds", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    amg_counts, amg_head = phase_amg(a, plain_solves, dev, max_abs)
    for key, n in amg_counts.items():
        counts[key] += n
    show("18.seconds", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    krylov_counts, krylov_its = phase_krylov(a, amg_head, plain_solves, a_fem, A_fem,
                                             fem_jacobi_its, dev, max_abs)
    for key, n in krylov_counts.items():
        counts[key] += n
    show("19.seconds", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    for key, n in phase_sstep(a, As64, amg_head, plain_solves, krylov_its["gmres"], dev,
                              max_abs).items():
        counts[key] = counts.get(key, 0) + n
    show("20.seconds", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    eig_counts, eig_shapes = phase_eig_spmv(a, As64, dev, max_abs)
    for key, n in eig_counts.items():
        counts[key] = counts.get(key, 0) + n
    del As64
    show("21.seconds", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    timing = phase_timing_all(a, times, a4, w4, a_fem, A_fem, dev)
    show("10a.seconds", seconds=time.perf_counter() - t0)
    timing.update(phase_ds_timing(a, a4, w4ds, A_fem_ds, a_fem, dev))
    show("10b.seconds", seconds=time.perf_counter() - t0)
    single_ms = {"dia_spmv": times["dia_spmv"][0], "dia_sym_spmv": times["dia_sym_spmv"][0],
                 "spmv_well": timing["spmv_well"]["other_shapes"][f"bench {N_WELL}"]["ms"],
                 "dia_ds_spmv": timing["dia_ds_spmv"]["ms"],
                 "well_ds_spmv":
                     timing["well_ds_spmv"]["other_shapes"][f"bench {N_WELL}"]["ms"]}
    timing.update(phase_block_timing(a, d32, a4, w4, w4ds, single_ms, circuit_ops, dev))
    show("10c.seconds", seconds=time.perf_counter() - t0)
    for kname, shapes in phase_amg_timing(amg_head, dev, max_abs).items():
        timing[kname].setdefault("other_shapes", {}).update(shapes)
    for kname, shapes in eig_shapes.items():
        timing[kname].setdefault("other_shapes", {}).update(shapes)
    del amg_head
    show("10.seconds", seconds=time.perf_counter() - t0,
         ds_launches_per_cg_iteration=per_iter)

    kernels = []
    for kname, key, source, replaces in (
            ("dia_spmv", "dia", "spmv_torch/csrc/spmv_dia.cu",
             "spmv_tpu/ops/spmv_dia_pallas.py:191"),
            ("dia_sym_spmv", "dia_sym", "spmv_torch/csrc/spmv_dia.cu",
             "spmv_tpu/ops/spmv_dia_pallas.py:265"),
            ("spmv_well", "well", "spmv_torch/csrc/spmv_well.cu",
             "spmv_tpu/ops/spmv_well_pallas.py:43"),
            ("dia_ds_spmv", "dia_ds", "spmv_torch/csrc/spmv_dia_ds.cu",
             "spmv_tpu/ops/spmv_dia_ds_pallas.py:164"),
            ("well_ds_spmv", "well_ds", "spmv_torch/csrc/spmv_well_ds.cu",
             "spmv_tpu/ops/spmv_well_pallas.py:407"),
            ("dia_spmm", "dia_spmm", "spmv_torch/csrc/spmm_dia.cu",
             "spmv_tpu/ops/spmm_dia_pallas.py:43"),
            ("dia_sym_spmm", "dia_sym_spmm", "spmv_torch/csrc/spmm_dia.cu",
             "spmv_tpu/ops/spmv_dia_pallas.py:265"),
            ("well_spmm", "well_spmm", "spmv_torch/csrc/spmm_well.cu",
             "spmv_tpu/ops/spmm_well_pallas.py:38"),
            ("dia_ds_spmm", "dia_ds_spmm", "spmv_torch/csrc/spmm_dia_ds.cu",
             "spmv_tpu/ops/spmv_dia_ds_pallas.py:377"),
            ("well_ds_spmm", "well_ds_spmm", "spmv_torch/csrc/spmm_well.cu",
             "spmv_tpu/ops/spmm_well_pallas.py:240")):
        row = timing[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[key],
            "max_abs_err": max_abs[kname], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": "bytes", "library_ms": row["library_ms"],
            **{k: row[k] for k in ("other_shapes", "nrhs", "single_rhs_x8_ms", "nrhs1",
                                   "timing", "chained_ms", "library_chained_ms")
               if k in row},
        })
    # DS timing rows carry their runs; the kernels line keeps the summary
    for k in kernels:
        for shape in (k, *k.get("other_shapes", {}).values()):
            shape.pop("ms_runs", None)
            shape.pop("plain_ms_runs", None)
    print(smi[0], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
