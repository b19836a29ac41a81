"""The V-cycle's share of its roofline: its least bytes
(``roofline_mg.cycle_bytes``, from the benchmark's level matrices; the
loop's ``mg_cycle_bytes`` counter) at 3.35 TB/s over the device time a
cycle of the operations launched inside the ``precond`` spans of the
traced slice, in percent."""
from bench_h100 import roofline_mg


def read(run):
    got = roofline_mg.cycles(run)
    if got is None:
        return None
    return roofline_mg.share(run.counters.get("mg_cycle_bytes"), *got)
