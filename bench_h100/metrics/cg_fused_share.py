"""Share of the CG iterations that ran the fused loop, over the process
(``spmv_torch.solvers.cg.iterations``): 100 x fused / (fused + plain).
None where the program keeps no such counter, where it ran no iteration,
or where the traced slice saw no device time (a CPU run)."""
from spmv_torch.solvers import cg


def read(run):
    its = getattr(cg, "iterations", None)
    if not its or run.trace is None or run.trace.busy_s <= 0:
        return None
    total = its["fused"] + its["plain"]
    return 100.0 * its["fused"] / total if total else None
