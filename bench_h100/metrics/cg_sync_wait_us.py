"""Host microseconds a CG iteration spends blocked in the port's
``spmv_torch.cg.sync`` spans (the convergence test's reads), in the traced
slice's whole solves: the device work still queued when the host reaches
the read."""
from bench_h100 import spans
from spmv_torch.utils import profiling


def read(run):
    return spans.cg_sync_wait_us(run, getattr(profiling, "record", None))
