"""CG (Jacobi-PCG with the configuration's ``preconditioner: "jacobi"``)
through ``spmv_torch.solvers.cg.cg``, on the system's operator."""
from __future__ import annotations


def make_solver(system, solver: dict, tracer=None):
    """``solve(b) -> (x, iterations)``. With a tracer, each solve runs in
    a ``solve`` span, the operator and the preconditioner inside ``matvec``
    and ``precond`` spans, and each apply is a counted call."""
    from spmv_torch.solvers import cg as cg_module

    op, pre = system.A.matvec, system.precond
    if tracer is not None:
        op = tracer.wrap("matvec", op, counted=True)
        if pre is not None:
            pre = tracer.wrap("precond", pre)
    kmax, rtol = int(solver["kmax"]), float(solver["rtol"])

    def solve(b):
        res = cg_module.cg(op, b, kmax=kmax, rtol=rtol, preconditioner=pre)
        return res.x, res.iterations

    return solve if tracer is None else tracer.wrap("solve", solve)
