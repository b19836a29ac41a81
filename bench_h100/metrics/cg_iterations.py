"""Iterations per solve (``CGResult.iterations``), over the window's
solves."""


def read(run):
    return run.counters.get("cg_iterations")
