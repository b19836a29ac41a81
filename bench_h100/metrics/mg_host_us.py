"""Mean host microseconds of one multigrid apply: the port's
``spmv_torch.mg`` spans in the traced slice's record (the cycle's Python
and its launches; the card runs behind it). None without device time or
where the program records no such span."""
from bench_h100 import spans
from spmv_torch.utils import profiling

MG = "spmv_torch.mg"


def read(run):
    record = getattr(profiling, "record", None)
    if not spans.on_device(run) or not record:
        return None
    mg = [s for s in record if s[0] == MG]
    return sum(end - start for _, start, end, _, _ in mg) * 1e-3 / len(mg) if mg else None
