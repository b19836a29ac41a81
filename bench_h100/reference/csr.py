"""The plain reference: a CSR matrix from the benchmark's own arrays, and its
apply in plain PyTorch (float64, on the device the run uses).

Independent of the program: it imports numpy and torch alone and works from
the benchmark's arrays, never from what the program assembled.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np


@dataclasses.dataclass
class CSR:
    """A square or rectangular CSR matrix: int64 ``rowptr``, int32
    ``colind`` (sorted within each row, no duplicates) and float64
    ``values``."""

    rowptr: np.ndarray
    colind: np.ndarray
    values: np.ndarray
    ncols: int

    @property
    def nrows(self) -> int:
        return len(self.rowptr) - 1

    @property
    def nnz(self) -> int:
        return len(self.values)

    def lower_nnz(self) -> int:
        """Entries on or below the diagonal: what symmetric storage keeps."""
        rows = np.repeat(np.arange(self.nrows, dtype=np.int64),
                         np.diff(self.rowptr))
        return int(np.count_nonzero(self.colind <= rows))

    def on(self, device) -> "TorchCSR":
        return TorchCSR(self, device)


class TorchCSR:
    """The matrix as a float64 torch CSR tensor on ``device``; ``apply``
    takes and returns float64 tensors there."""

    def __init__(self, a: CSR, device):
        import torch

        self.device = device
        with warnings.catch_warnings():  # torch calls its sparse CSR "beta"
            warnings.simplefilter("ignore")
            self.m = torch.sparse_csr_tensor(
                torch.as_tensor(a.rowptr, dtype=torch.int64, device=device),
                torch.as_tensor(a.colind, dtype=torch.int64, device=device),
                torch.as_tensor(a.values, dtype=torch.float64, device=device),
                (a.nrows, a.ncols), check_invariants=False)
        self._abs = None

    def apply(self, x, absolute: bool = False):
        """y = A x (``absolute``: |A| |x|)."""
        if not absolute:
            return self.m @ x
        if self._abs is None:
            self._abs = self.m.abs()
        return self._abs @ x.abs()

    def tensor(self, v: np.ndarray):
        import torch

        return torch.as_tensor(np.asarray(v, dtype=np.float64),
                               device=self.device)
