"""The port's own spans and set-up timers, reduced to per-layer numbers.

The program (``spmv_torch.utils.profiling``) appends a span
``(name, start_ns, end_ns, parent, request)`` to its in-memory record for
every span that begins and ends while a torch profiler records, so in a
``--trace 1`` run the record holds the traced slice. The readers under
``metrics/`` import the program's record or timer table and pass it here;
this module imports nothing of the program. Every function returns None
where the traced slice saw no device time (a CPU run: no device number
is written from it) or where the program keeps no such record or table
(a version before them).

The CG numbers read only whole solves: those whose ``spmv_torch.cg`` span
lies in the record, so a solve cut by the slice's edges does not skew a
mean. A solve's spans share its request id.
"""
from __future__ import annotations

CG = "spmv_torch.cg"
ITERATION = "spmv_torch.cg.iteration"
SYNC = "spmv_torch.cg.sync"
APPLY = "spmv_torch.apply"


def on_device(run) -> bool:
    return run.trace is not None and run.trace.busy_s > 0


def _whole_solves(run, record):
    """(spans of the record's whole solves, their iteration count), or
    None where there is nothing to read."""
    if not on_device(run) or not record:
        return None
    whole = {request for name, _, _, _, request in record if name == CG}
    spans = [s for s in record if s[4] in whole]
    iterations = sum(s[0] == ITERATION for s in spans)
    return (spans, iterations) if iterations else None


def _us(spans) -> float:
    return sum(end - start for _, start, end, _, _ in spans) * 1e-3


def cg_host_syncs(run, record) -> float | None:
    """Blocking host reads (``cg.sync`` spans) an iteration."""
    got = _whole_solves(run, record)
    if got is None:
        return None
    spans, iterations = got
    return sum(s[0] == SYNC for s in spans) / iterations


def cg_sync_wait_us(run, record) -> float | None:
    """Host µs an iteration spent inside ``cg.sync`` spans."""
    got = _whole_solves(run, record)
    if got is None:
        return None
    spans, iterations = got
    return _us(s for s in spans if s[0] == SYNC) / iterations


def cg_host_us(run, record) -> float | None:
    """Host µs an iteration of ``cg.iteration``'s self time: its duration
    less that of its child spans (the syncs and applies in it)."""
    got = _whole_solves(run, record)
    if got is None:
        return None
    spans, iterations = got
    own = _us(s for s in spans if s[0] == ITERATION)
    children = _us(s for s in spans if s[3] == ITERATION)
    return (own - children) / iterations


def apply_host_us(run, record) -> float | None:
    """Mean host µs of an ``spmv_torch.apply`` span."""
    if not on_device(run) or not record:
        return None
    applies = [s for s in record if s[0] == APPLY]
    return _us(applies) / len(applies) if applies else None


def timer(run, table, key: str) -> float | None:
    """``table[key]`` (one of the program's always-on timers), on the
    device only."""
    if not on_device(run) or table is None or key not in table:
        return None
    return float(table[key])
