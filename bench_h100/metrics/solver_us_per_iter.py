"""Device microseconds per CG iteration of the operations launched outside
the ``matvec`` and ``precond`` spans (the vector updates and dots, and each
solve's start), over the traced slice."""

from bench_h100 import trace


def read(run):
    return trace.outside_us_per_iteration(run.trace)
