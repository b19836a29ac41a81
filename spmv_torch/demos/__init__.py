"""CLI demos; each module exposes ``main(argv=None) -> int`` and runs as
``python -m spmv_torch.demos.<name>``."""
