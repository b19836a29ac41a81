"""The device's idle share of the traced slice: 1 - (union of the device
operations' intervals) / (the slice's wall time), both over the same
slice, in percent."""

from bench_h100 import trace


def read(run):
    return trace.idle_percent(run.trace)
