"""Plain conjugate gradients in float64 torch: the upstream's ``spmv::cg``
(``cg.cpp:55-86``), from x0 = 0, stopping when |r| / |r0| < rtol or after
kmax iterations, optionally with a Jacobi preconditioner (the matrix's
diagonal, taken from the benchmark's own arrays)."""
from __future__ import annotations

import numpy as np

from bench_h100.reference.csr import CSR, TorchCSR


def diagonal(a: CSR) -> np.ndarray:
    rows = np.repeat(np.arange(a.nrows, dtype=np.int64), np.diff(a.rowptr))
    d = np.zeros(a.nrows)
    on = a.colind == rows
    d[rows[on]] = a.values[on]
    return d


def solve(a: TorchCSR, b, kmax: int, rtol: float, inv_diag=None):
    """(x, iterations) for A x = b, b a float64 tensor on ``a``'s device."""
    import torch

    x = torch.zeros_like(b)
    r = b.clone()
    z = r if inv_diag is None else inv_diag * r
    p = z.clone()
    rho = torch.dot(r, z)
    rnorm0 = torch.linalg.vector_norm(r)
    k = 0
    while k < kmax and bool(torch.linalg.vector_norm(r) >= rtol * rnorm0):
        ap = a.apply(p)
        alpha = rho / torch.dot(p, ap)
        x += alpha * p
        r -= alpha * ap
        z = r if inv_diag is None else inv_diag * r
        rho_new = torch.dot(r, z)
        p = z + (rho_new / rho) * p
        rho = rho_new
        k += 1
    return x, k
