"""Blocking host reads a CG iteration: the port's ``spmv_torch.cg.sync``
spans over its ``spmv_torch.cg.iteration`` spans, in the traced slice's
whole solves (``bench_h100/spans.py``)."""
from bench_h100 import spans
from spmv_torch.utils import profiling


def read(run):
    return spans.cg_host_syncs(run, getattr(profiling, "record", None))
