"""Block Jacobi preconditioning over the 128x128 diagonal blocks.

Counterpart of ``spmv_tpu.solvers.precond``. The operator's 128x128
diagonal blocks align with the lane layout of the distributed vectors (one
block per lane row, never crossing a shard, whose padding is a multiple of
128). The blocks are inverted once on the host in float64; the apply is one
batched (G, 128, 128) @ (G, 128) product on the vectors' device, with no
exchange between shards.
"""
from __future__ import annotations

import numpy as np
import torch

from spmv_torch.formats.csr import CSRHost
from spmv_torch.formats.dia import LANES
from spmv_torch.parallel.dist_matrix import DistMatrix
from spmv_torch.parallel.partition import owner_ranges


def block_jacobi_preconditioner(a: CSRHost, A: DistMatrix):
    """z = diag_blocks(A)^-1 r for ``cg``: ``a`` is the host CSR the
    operator was assembled from (the block extraction is a host pass over
    its nonzeros), ``A`` supplies the layout and device. Rows with an empty
    block row (padding, or no in-block entry) get a unit diagonal, so
    padding passes through unscaled."""
    nd = A.n_devices
    g = A.row_pad // LANES
    ranges = owner_ranges(a.nrows, nd)

    blocks = np.zeros((nd, g, LANES, LANES), np.float64)
    rows = np.repeat(np.arange(a.nrows, dtype=np.int64), a.row_nnz())
    cols = a.colind.astype(np.int64)
    shard = np.searchsorted(ranges, rows, side="right") - 1
    lr = rows - ranges[shard]          # local row within the shard
    lc = cols - ranges[shard]          # column relative to the same shard
    same = (cols >= ranges[shard]) & (cols < ranges[np.minimum(shard + 1, nd)])
    blk = lr // LANES
    in_blk = same & (lc // LANES == blk)
    np.add.at(blocks,
              (shard[in_blk], blk[in_blk], lr[in_blk] % LANES, lc[in_blk] % LANES),
              a.values[in_blk])
    empty = np.abs(blocks).sum(axis=3) == 0  # (nd, g, 128)
    s_, g_, r_ = np.nonzero(empty)
    blocks[s_, g_, r_, r_] = 1.0

    binv = torch.as_tensor(np.linalg.inv(blocks).reshape(nd * g, LANES, LANES),
                           device=A.device).to(A.dtype)

    def apply(r: torch.Tensor) -> torch.Tensor:
        # r: (D*G, 128) lane layout -> one batched block solve
        return torch.einsum("grc,gc->gr", binv, r)

    return apply
