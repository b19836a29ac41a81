"""The numbers that decide ``correct``, computed by the plain reference in
float64 from the benchmark's own matrix, in the matrix's original
ordering. The program's outputs are read only to be judged."""
from __future__ import annotations

import numpy as np

from bench_h100.reference import cg
from bench_h100.reference.csr import CSR, TorchCSR


def solution_errors(a: CSR, device, rhs: list, answers: list,
                    solver: dict) -> list[float]:
    """||x - x_ref|| / ||x_ref|| for each answer ``(j, x)``: x_ref is the
    reference's CG from ``rhs[j]`` with the configuration's kmax, rtol and
    preconditioner, worked out from the benchmark's own matrix."""
    import torch

    at = a.on(device)
    inv_diag = None
    if solver.get("preconditioner") == "jacobi":
        inv_diag = 1.0 / at.tensor(cg.diagonal(a))
    elif solver.get("preconditioner") is not None:
        raise ValueError(f"no reference for {solver['preconditioner']!r}")
    refs, out = {}, []
    for j, x in answers:
        if j not in refs:
            refs[j], _ = cg.solve(at, at.tensor(rhs[j]), int(solver["kmax"]),
                                  float(solver["rtol"]), inv_diag)
        ref = refs[j]
        out.append(float(torch.linalg.vector_norm(at.tensor(x) - ref)
                         / torch.linalg.vector_norm(ref)))
    return out


def apply_error(a: TorchCSR, x: np.ndarray, y: np.ndarray) -> float:
    """||y - A x|| / || |A| |x| ||: an apply's error against the rounding
    scale of the sum (the norm of |A| |x| bounds what rounding can reach)."""
    import torch

    xt = a.tensor(x)
    err = torch.linalg.vector_norm(a.tensor(y) - a.apply(xt))
    return float(err / torch.linalg.vector_norm(a.apply(xt, absolute=True)))
