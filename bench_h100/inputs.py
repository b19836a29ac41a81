"""The traffic's inputs, made on the host from the run's seed as plain numpy
arrays in the matrix's original ordering; the same arrays go to the
program and to the reference."""
from __future__ import annotations

import numpy as np


def uniform_vectors(n: int, count: int,
                    rng: np.random.Generator) -> list[np.ndarray]:
    """``count`` vectors with entries uniform on [-1, 1)."""
    return [2.0 * rng.random(n) - 1.0 for _ in range(count)]
