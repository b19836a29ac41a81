"""Host seconds of the port's kernel library's first use: the nvcc build
where the checkout has none yet, then the ctypes binding
(``_build.library["load_s"]``)."""
from bench_h100 import spans
from spmv_torch import _build


def read(run):
    return spans.timer(run, getattr(_build, "library", None), "load_s")
