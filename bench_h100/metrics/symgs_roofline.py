"""The SymGS sweeps' share of their roofline: the least bytes of one
cycle's sweeps (the loop's ``mg_sweep_bytes`` counter) at 3.35 TB/s over
the device time a cycle of the sweep kernel (``symgs_dia_lines``, every
instantiation) in the traced slice's breakdown, in percent. None where no
such kernel appears."""
from bench_h100 import roofline_mg

KERNEL = "symgs_dia_lines"


def read(run):
    got = roofline_mg.cycles(run)
    if got is None:
        return None
    sweep_s = sum(s for name, s in run.trace.device_ops if KERNEL in name)
    if sweep_s <= 0:
        return None
    return roofline_mg.share(run.counters.get("mg_sweep_bytes"), sweep_s, got[1])
