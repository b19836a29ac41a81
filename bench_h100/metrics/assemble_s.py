"""Host seconds of the port's set-up calls (``rcm_reorder``,
``build_dist_matrix``, the preconditioner's set-up), ending in a
synchronize; the benchmark's own input generation is not in it."""


def read(run):
    return run.host.get("assemble_s")
