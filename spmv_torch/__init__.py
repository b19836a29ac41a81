"""spmv_torch — the PyTorch/CUDA port of spmv_tpu for NVIDIA Hopper.

Module names mirror ``spmv_tpu`` so each counterpart is found by name:

====================  ===================================================
spmv_tpu (JAX/Pallas)  spmv_torch (PyTorch/CUDA)
====================  ===================================================
formats.csr            formats.csr   (host CSR, numpy, carried across)
ds                     ds            (double-single on torch tensors)
gen                    gen           (numpy generators)
formats.dia            formats.dia   (DiaMatrix holding a torch tensor,
                       dia_transpose)
formats.well           formats.well  (WellMatrix, SymWellMatrix; numpy packer)
formats.ell            formats.ell   (EllMatrix; numpy packer, transpose
                       terms built on the host)
ops.spmv_ell           ops.spmv_ell  (plain torch gathers, no scatter-add)
ops.spmv_dia           ops.spmv_dia  (plain torch DIA apply, CPU path)
ops.spmv_dia_pallas    ops.spmv_dia_cuda + csrc/spmv_dia.cu (sm_90a)
ops.spmv_well_pallas   ops.spmv_well (plain torch, CPU path) +
                       ops.spmv_well_cuda + csrc/spmv_well.cu (sm_90a);
                       its double-single part: ops.spmv_well_ds +
                       ops.spmv_well_ds_cuda + csrc/spmv_well_ds.cu
ops.spmv_dia_ds_pallas ops.spmv_dia_ds (plain torch, CPU path) +
                       ops.spmv_dia_ds_cuda + csrc/spmv_dia_ds.cu; its
                       block part: csrc/spmm_dia_ds.cu
ops.spmm_dia_pallas    ops.spmm_dia (SpMM lane layout, plain torch) +
                       ops.spmm_dia_cuda + csrc/spmm_dia.cu (also the
                       symmetric block kernel of spmv_dia_pallas)
ops.spmm_well_pallas   ops.spmm_well (plain torch) + ops.spmm_well_cuda +
                       csrc/spmm_well.cu (plain and double-single)
corpus                 corpus        (numpy + scipy generators)
reorder                reorder       (numpy RCM)
io.matrix_market       io.matrix_market
io.petsc               io.petsc      (numpy reader and writers)
parallel.partition     parallel.partition
parallel.comm_plan     parallel.comm_plan (shards stacked on one device)
parallel.dist_matrix   parallel.dist_matrix (ell, dia, dia_ds, well,
                       well_ds, auto; matvec_ds, matmat, matmat_ds;
                       rectangular ELL, hub rows; matvec_transpose,
                       transposed)
parallel.powers        parallel.powers (the matrix-powers kernel: depth-s
                       ghost plans, DIA windows on dia_spmv or ELL; no
                       two-tier plans)
solvers.cg             solvers.cg    (cg, cg_pipelined)
solvers.cg_sstep       solvers.cg_sstep (one host sync per s-block)
solvers.gmres_sstep    solvers.gmres_sstep (CA-GMRES, Chebyshev or Newton
                       basis)
solvers.arnoldi        solvers.arnoldi
solvers.newton_basis   solvers.newton_basis (numpy, copied)
solvers.lobpcg         solvers.lobpcg
solvers.deflation      solvers.deflation (cg_deflated)
solvers.bicgstab       solvers.bicgstab
solvers.gmres          solvers.gmres (GMRES(m) and FGMRES)
solvers.minres         solvers.minres
solvers.lsqr           solvers.lsqr
solvers.spai           solvers.spai  (numpy setup, DistMatrix apply)
solvers.fsai           solvers.fsai  (numpy setup, DistMatrix applies)
solvers.refine         solvers.refine (cg_refined, cg_refined_dist)
solvers.block_cg       solvers.block_cg (block_cg, block_cg_dia,
                       block_cg_refined, block_cg_refined_dist; inner
                       solver "cg" or "chebyshev")
solvers.chebyshev      solvers.chebyshev
solvers.lanczos        solvers.lanczos
solvers.funm           solvers.funm  (Lanczos f(A) v, SLQ; eigh on the host)
solvers.svds           solvers.svds  (Golub-Kahan; B's SVD on the host)
solvers.amg            solvers.amg   (numpy setup, cycle in plain torch
                       around the level operators' kernels)
solvers.precond        solvers.precond (block Jacobi)
utils.timing           utils.timing  (CUDA events)
utils.profiling        utils.profiling (spans: torch.profiler regions and
                       an in-memory record while a profiler records;
                       Chrome traces)
interop                interop       (scipy.sparse; torch sparse COO/CSR
                       in place of BCOO)
io.checkpoint          io.checkpoint (the reference's file format; one-tier
                       plans)
demos.demo_cg          demos.demo_cg
demos.demo_restrict    demos.demo_restrict
demos.demo_eig         demos.demo_eig
demos.demo_spmv        demos.demo_spmv
====================  ===================================================

The package imports torch and numpy only — never jax or spmv_tpu.
"""

from spmv_torch import corpus
from spmv_torch.formats.csr import CSRHost, csr_matmul
from spmv_torch.formats.dia import DiaMatrix, csr_to_dia, dia_transpose
from spmv_torch.formats.ell import EllMatrix, csr_to_ell
from spmv_torch.formats.well import (
    SymWellMatrix,
    WellMatrix,
    csr_to_well,
    csr_to_well_sym,
)
from spmv_torch.gen import (
    create_laplace_1d,
    create_laplace_2d,
    create_laplace_3d,
    gaussian_bump,
    random_csr,
)
from spmv_torch.io.matrix_market import read_matrix_market, write_matrix_market
from spmv_torch.io.petsc import (
    read_petsc_binary_matrix_host,
    read_petsc_binary_vector_host,
    write_petsc_binary_matrix,
    write_petsc_binary_vector,
)
from spmv_torch.interop import from_scipy, from_torch_sparse, to_scipy, to_torch_sparse
from spmv_torch.ops.spmv_ell import spmv_ell, spmv_ell_transpose
from spmv_torch.ops.spmm_dia import spmm_dia, spmm_from_layout, spmm_to_layout
from spmv_torch.ops.spmv_dia_ds import DiaDsMatrix, csr_to_dia_ds, spmv_dia_ds
from spmv_torch.ops.spmv_well import spmv_well, spmv_well_sym
from spmv_torch.ops.spmv_well_ds import WellDsMatrix, csr_to_well_ds, spmv_well_ds
from spmv_torch.parallel.dist_matrix import (
    DistMatrix,
    build_dist_matrix,
    select_local_format,
)
from spmv_torch.parallel.powers import (
    PowersPlan,
    build_powers_plan,
    chebyshev_powers_basis,
    newton_powers_basis,
    powers_ghost_stats,
)
from spmv_torch.reorder import rcm_reorder
from spmv_torch.solvers.arnoldi import ArnoldiRitz, arnoldi_factorization, arnoldi_ritz
from spmv_torch.solvers.block_cg import (
    BlockCGResult,
    block_cg,
    block_cg_dia,
    block_cg_refined,
    block_cg_refined_dist,
)
from spmv_torch.solvers.amg import AMGHierarchy, amg_preconditioner, amg_setup
from spmv_torch.solvers.bicgstab import BiCGStabResult, bicgstab
from spmv_torch.solvers.cg import CGResult, cg, cg_pipelined, cg_residual_history
from spmv_torch.solvers.cg_sstep import cg_sstep
from spmv_torch.solvers.deflation import cg_deflated
from spmv_torch.solvers.chebyshev import (
    ChebyshevResult,
    chebyshev,
    chebyshev_adaptive,
    chebyshev_bounds,
    chebyshev_iterations_for,
)
from spmv_torch.solvers.lanczos import (
    condition_estimate,
    condition_interval,
    lanczos_extreme,
    lanczos_extreme_with_bounds,
    lanczos_factorization,
)
from spmv_torch.solvers.funm import (
    expm_multiply,
    funm_multiply,
    inv_sqrt_multiply,
    slq_logdet,
    slq_trace,
    sqrt_multiply,
)
from spmv_torch.solvers.fsai import fsai_preconditioner, fsai_setup
from spmv_torch.solvers.gmres import GMRESResult, gmres
from spmv_torch.solvers.gmres_sstep import gmres_sstep
from spmv_torch.solvers.lobpcg import LOBPCGResult, lane_block_ops, lobpcg
from spmv_torch.solvers.lsqr import LSQRResult, lsqr
from spmv_torch.solvers.minres import MINRESResult, minres
from spmv_torch.solvers.newton_basis import (
    modified_leja,
    newton_basis_ops,
    newton_recurrence_matrix,
    newton_shifts_from_operator,
)
from spmv_torch.solvers.precond import block_jacobi_preconditioner
from spmv_torch.solvers.refine import RefineResult, cg_refined, cg_refined_dist
from spmv_torch.solvers.spai import spai_preconditioner, spai_setup
from spmv_torch.solvers.svds import SVDSResult, gk_factorization, svds

__all__ = [
    "corpus",
    "from_scipy",
    "to_scipy",
    "from_torch_sparse",
    "to_torch_sparse",
    "EllMatrix",
    "csr_to_ell",
    "spmv_ell",
    "spmv_ell_transpose",
    "CSRHost",
    "csr_matmul",
    "DiaMatrix",
    "csr_to_dia",
    "dia_transpose",
    "WellMatrix",
    "SymWellMatrix",
    "csr_to_well",
    "csr_to_well_sym",
    "spmv_well",
    "spmv_well_sym",
    "DiaDsMatrix",
    "csr_to_dia_ds",
    "spmv_dia_ds",
    "WellDsMatrix",
    "csr_to_well_ds",
    "spmv_well_ds",
    "spmm_dia",
    "spmm_to_layout",
    "spmm_from_layout",
    "read_matrix_market",
    "write_matrix_market",
    "read_petsc_binary_matrix_host",
    "read_petsc_binary_vector_host",
    "write_petsc_binary_matrix",
    "write_petsc_binary_vector",
    "rcm_reorder",
    "select_local_format",
    "create_laplace_1d",
    "create_laplace_2d",
    "create_laplace_3d",
    "gaussian_bump",
    "random_csr",
    "DistMatrix",
    "build_dist_matrix",
    "CGResult",
    "cg",
    "cg_residual_history",
    "cg_pipelined",
    "cg_sstep",
    "gmres_sstep",
    "cg_deflated",
    "PowersPlan",
    "build_powers_plan",
    "chebyshev_powers_basis",
    "newton_powers_basis",
    "powers_ghost_stats",
    "ArnoldiRitz",
    "arnoldi_factorization",
    "arnoldi_ritz",
    "modified_leja",
    "newton_basis_ops",
    "newton_recurrence_matrix",
    "newton_shifts_from_operator",
    "LOBPCGResult",
    "lobpcg",
    "lane_block_ops",
    "BiCGStabResult",
    "bicgstab",
    "GMRESResult",
    "gmres",
    "MINRESResult",
    "minres",
    "LSQRResult",
    "lsqr",
    "spai_setup",
    "spai_preconditioner",
    "fsai_setup",
    "fsai_preconditioner",
    "RefineResult",
    "cg_refined",
    "cg_refined_dist",
    "BlockCGResult",
    "block_cg",
    "block_cg_dia",
    "block_cg_refined",
    "block_cg_refined_dist",
    "AMGHierarchy",
    "amg_setup",
    "amg_preconditioner",
    "ChebyshevResult",
    "chebyshev",
    "chebyshev_adaptive",
    "chebyshev_bounds",
    "chebyshev_iterations_for",
    "condition_estimate",
    "condition_interval",
    "lanczos_extreme",
    "lanczos_extreme_with_bounds",
    "lanczos_factorization",
    "block_jacobi_preconditioner",
    "SVDSResult",
    "gk_factorization",
    "svds",
    "expm_multiply",
    "funm_multiply",
    "inv_sqrt_multiply",
    "sqrt_multiply",
    "slq_logdet",
    "slq_trace",
]
