"""Mean host microseconds of the port's ``spmv_torch.apply`` span (one
``DistMatrix.matvec``: its checks, the route, y's allocation, the launch)
over the traced slice."""
from bench_h100 import spans
from spmv_torch.utils import profiling


def read(run):
    return spans.apply_host_us(run, getattr(profiling, "record", None))
