"""The system under test: the port's operator as a configuration asks for
it, assembled from the benchmark's CSR through the port's entry points
(``rcm_reorder``, ``build_dist_matrix``, ``jacobi_preconditioner``), and
the moves of vectors between the original ordering and the port's layout.
"""
from __future__ import annotations

import time

import numpy as np

from bench_h100.reference.csr import CSR


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class System:
    """``A`` (a ``DistMatrix``), ``precond`` (the preconditioner's apply or
    None) and ``order`` (the port's RCM ordering, new -> old, or None).
    ``assemble_s`` is the host time of the port's set-up calls."""

    def __init__(self, config: dict, a: CSR, device):
        from spmv_torch.formats.csr import CSRHost
        from spmv_torch.parallel.dist_matrix import build_dist_matrix
        from spmv_torch.reorder import rcm_reorder

        self.device = device
        self.dtype = np.dtype(config["dtype"])
        t0 = time.perf_counter()
        host = CSRHost(a.rowptr, a.colind, a.values, a.ncols)
        self.order = None
        if config["reorder"] == "rcm":
            host, self.order = rcm_reorder(host, keep_best=True)
        elif config["reorder"] is not None:
            raise ValueError(f"unknown reorder {config['reorder']!r}")
        self.A = build_dist_matrix(
            host, n_devices=1, symmetric=config["storage"] == "symmetric",
            dtype=self.dtype, local_format=config["local_format"],
            device=device)
        if self.A.local_format != config["local_format"]:
            raise ValueError(f"asked for {config['local_format']!r}, the port "
                             f"built {self.A.local_format!r}")
        pre = config["solver"]["preconditioner"]
        if pre == "jacobi":
            self.precond = self.A.jacobi_preconditioner()
        elif pre is None:
            self.precond = None
        else:
            raise ValueError(f"unknown preconditioner {pre!r}")
        sync(device)
        self.assemble_s = time.perf_counter() - t0

    def to_port(self, v: np.ndarray):
        """A vector in the original ordering -> the port's layout."""
        if self.order is not None:
            v = v[self.order]
        return self.A.to_dist(np.ascontiguousarray(v, dtype=self.dtype))

    def from_port(self, t) -> np.ndarray:
        """A vector in the port's layout -> float64, original ordering."""
        v = self.A.from_dist(t).astype(np.float64)
        if self.order is None:
            return v
        out = np.empty_like(v)
        out[self.order] = v
        return out

    def free(self) -> None:
        import torch

        self.A = self.precond = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
