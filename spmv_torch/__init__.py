"""spmv_torch — the PyTorch/CUDA port of spmv_tpu for NVIDIA Hopper.

Module names mirror ``spmv_tpu`` so each counterpart is found by name:

====================  ===================================================
spmv_tpu (JAX/Pallas)  spmv_torch (PyTorch/CUDA)
====================  ===================================================
formats.csr            formats.csr   (host CSR, numpy, carried across)
gen                    gen           (numpy generators)
formats.dia            formats.dia   (DiaMatrix holding a torch tensor)
formats.well           formats.well  (WellMatrix, SymWellMatrix; numpy packer)
ops.spmv_dia           ops.spmv_dia  (plain torch DIA apply, CPU path)
ops.spmv_dia_pallas    ops.spmv_dia_cuda + csrc/spmv_dia.cu (sm_90a)
ops.spmv_well_pallas   ops.spmv_well (plain torch, CPU path) +
                       ops.spmv_well_cuda + csrc/spmv_well.cu (sm_90a)
corpus                 corpus        (numpy + scipy generators)
reorder                reorder       (numpy RCM)
io.matrix_market       io.matrix_market
parallel.partition     parallel.partition
parallel.comm_plan     parallel.comm_plan (shards stacked on one device)
parallel.dist_matrix   parallel.dist_matrix (ell, dia, well, auto)
solvers.cg             solvers.cg
utils.timing           utils.timing  (CUDA events)
demos.demo_cg          demos.demo_cg
====================  ===================================================

The package imports torch and numpy only — never jax or spmv_tpu.
"""

from spmv_torch import corpus
from spmv_torch.formats.csr import CSRHost
from spmv_torch.formats.dia import DiaMatrix, csr_to_dia
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
)
from spmv_torch.io.matrix_market import read_matrix_market, write_matrix_market
from spmv_torch.ops.spmv_well import spmv_well, spmv_well_sym
from spmv_torch.parallel.dist_matrix import (
    DistMatrix,
    build_dist_matrix,
    select_local_format,
)
from spmv_torch.reorder import rcm_reorder
from spmv_torch.solvers.cg import CGResult, cg, cg_residual_history

__all__ = [
    "corpus",
    "CSRHost",
    "DiaMatrix",
    "csr_to_dia",
    "WellMatrix",
    "SymWellMatrix",
    "csr_to_well",
    "csr_to_well_sym",
    "spmv_well",
    "spmv_well_sym",
    "read_matrix_market",
    "write_matrix_market",
    "rcm_reorder",
    "select_local_format",
    "create_laplace_1d",
    "create_laplace_2d",
    "create_laplace_3d",
    "gaussian_bump",
    "DistMatrix",
    "build_dist_matrix",
    "CGResult",
    "cg",
    "cg_residual_history",
]
