"""The operator apply's share of its roofline: the least bytes of one
apply (``roofline.apply_bytes``) at 3.35 TB/s over the device time per
apply of every operation launched inside the ``matvec`` spans of the
traced slice, in percent."""

from bench_h100 import roofline


def read(run):
    return roofline.matvec_share(run)
