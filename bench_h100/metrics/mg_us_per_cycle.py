"""Device microseconds of one multigrid V-cycle: the device time of every
operation launched inside the ``precond`` spans of the traced slice, over
the cycles begun in it (``roofline_mg.cycles``)."""
from bench_h100 import roofline_mg


def read(run):
    got = roofline_mg.cycles(run)
    return None if got is None else 1e6 * got[0] / got[1]
