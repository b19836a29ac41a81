"""Host seconds of the port's assembly phase "upload" (the copies of the
stacked arrays to the device), summed over the run's assemblies
(``dist_matrix.build_seconds``)."""
from bench_h100 import spans
from spmv_torch.parallel import dist_matrix


def read(run):
    return spans.timer(run, getattr(dist_matrix, "build_seconds", None),
                       "upload")
