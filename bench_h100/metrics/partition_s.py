"""Host seconds of the port's assembly phase "partition" (``partition_csr``
and ``compile_plan``), summed over the run's assemblies
(``dist_matrix.build_seconds``)."""
from bench_h100 import spans
from spmv_torch.parallel import dist_matrix


def read(run):
    return spans.timer(run, getattr(dist_matrix, "build_seconds", None),
                       "partition")
