"""Host microseconds of a CG iteration outside its syncs and applies: the
self time of the port's ``spmv_torch.cg.iteration`` spans (the enqueue of
the vector updates and dots, and the loop's Python), in the traced
slice's whole solves."""
from bench_h100 import spans
from spmv_torch.utils import profiling


def read(run):
    return spans.cg_host_us(run, getattr(profiling, "record", None))
