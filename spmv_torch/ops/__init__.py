"""Compute kernels: plain torch versions (the CPU path and the oracle) and
the CUDA kernels that replace spmv_tpu's Pallas kernels."""
