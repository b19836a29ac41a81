"""The least bytes of one apply (``roofline.apply_bytes``) over the bytes
the port's apply reads (``dist_matrix.layout_bytes``: the newest assembled
operator's device arrays, x once and y once), in percent: how much of the
apply's traffic its storage layout adds. None where the program keeps no
such record."""
from bench_h100 import roofline
from spmv_torch.parallel import dist_matrix


def read(run):
    record = getattr(dist_matrix, "layout_bytes", None)
    if not record:
        return None
    (nbytes,) = record.values()
    return 100.0 * run.roofline_s * roofline.PEAK_BYTES_PER_S / nbytes
