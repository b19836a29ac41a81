"""HPCG 3.1's multigrid-preconditioned CG through the port: the system's
operator as the finest level of ``spmv_torch.solvers.gmg``'s V-cycle, the
coarser levels the benchmark's own generator on the grid halved, assembled
by the port's ``build_dist_matrix``, and ``spmv_torch.solvers.cg.cg`` with
the cycle as its preconditioner.

The configuration's ``solver.mg`` is HPCG's: ``levels`` 4, one pre- and one
post-SymGS, 8 colours; ``kmax`` is a set's iterations, ``rtol`` 0.
"""
from __future__ import annotations

from pathlib import Path

# a program without the multigrid fails here, as the method loads
from spmv_torch.solvers import gmg

ROOT = Path(__file__).resolve().parents[2]
HPCG_MG = {"pre": 1, "post": 1, "colours": 8}


def levels(config: dict, matrix) -> list:
    """[(grid, CSR)], finest first: ``matrix`` on the configuration's grid,
    then the generator's operator on the grid halved, to ``mg.levels``."""
    from bench_h100 import harness

    m = config["matrix"]
    gen = harness.load_module(ROOT, "matrices", m["generator"])
    grid = (int(m["nx"]), int(m["ny"]), int(m["nz"]))
    out = [(grid, matrix)]
    for _ in range(int(config["solver"]["mg"]["levels"]) - 1):
        if any(v % 2 for v in grid):
            raise ValueError(f"grid {out[0][0]} does not halve to "
                             f"{config['solver']['mg']['levels']} levels")
        grid = tuple(v // 2 for v in grid)
        out.append((grid, gen.generate({**m, "nx": grid[0], "ny": grid[1],
                                        "nz": grid[2]})))
    return out


def make_solver(system, solver: dict, matrices: list, tracer=None):
    """(``solve(b) -> (x, iterations)``, ``last``): ``last["reduction"]``
    is the latest set's |r| / |r0| (a 0-d tensor on the card). With a
    tracer, each solve runs in a ``solve`` span, the operator in a counted
    ``matvec`` span and the cycle in a ``precond`` span."""
    from spmv_torch.formats.csr import CSRHost
    from spmv_torch.solvers import cg as cg_module

    mg = solver["mg"]
    if {k: mg[k] for k in HPCG_MG} != HPCG_MG or int(mg["levels"]) != len(matrices):
        raise ValueError(f"the method runs HPCG's cycle {HPCG_MG} on "
                         f"{len(matrices)} levels, got {mg}")
    hosts = {grid: CSRHost(a.rowptr, a.colind, a.values, a.ncols)
             for grid, a in matrices[1:]}
    cycle = gmg.hpcg_hierarchy(system.A, matrices[0][0], len(matrices),
                               generate=lambda *grid: hosts[grid])
    op, pre = system.A.matvec, cycle.as_preconditioner()
    if tracer is not None:
        op = tracer.wrap("matvec", op, counted=True)
        pre = tracer.wrap("precond", pre)
    kmax, rtol = int(solver["kmax"]), float(solver["rtol"])
    last = {}

    def solve(b):
        res = cg_module.cg(op, b, kmax=kmax, rtol=rtol, preconditioner=pre)
        last["reduction"] = res.rnorm / res.rnorm0
        return res.x, res.iterations

    return (solve if tracer is None else tracer.wrap("solve", solve)), last
