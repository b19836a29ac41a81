"""DIA SpMV wrappers over the CUDA kernels of ``csrc/spmv_dia.cu``.

Counterpart of ``spmv_tpu.ops.spmv_dia_pallas``: ``dia_spmv`` replaces
``_dia_kernel`` and ``dia_sym_spmv`` replaces ``_dia_sym_kernel``. Vectors
stay in the (rows, 128) lane layout, so repeated applies chain with no data
movement.

A CPU tensor takes the plain torch version (``ops/spmv_dia.py``); a CUDA
tensor launches the kernel or raises. ``launches`` counts kernel launches
(one per call on a CUDA tensor, none on the plain path), so a run can show
that its path went through the kernels.

The kernels take float32, float64 and bfloat16 storage (bf16 accumulates
in float32 and stores y in bf16) and any number of diagonals: the offsets
reach them as an int64 array on the card, made once per (offsets, device)
and kept (``device_offsets``).
"""
from __future__ import annotations

import functools

import torch

from spmv_torch.formats.dia import LANES, DiaMatrix
from spmv_torch.ops.spmv_dia import spmv_dia_stacked_plain

DTYPES = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}

launches = {"dia": 0, "dia_sym": 0}


@functools.lru_cache(maxsize=256)
def device_offsets(offsets: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The diagonal offsets as an int64 tensor on ``device``, which the
    kernels read; one copy per (offsets, device) is kept, so repeated
    applies make no host-to-device transfer."""
    return torch.tensor(offsets, dtype=torch.int64, device=device)


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _lanes_ok(lanes: int, block: bool) -> bool:
    """x's width: 128 lanes, or nrhs*128 (the SpMM lane layout) for a block
    apply."""
    return lanes == LANES or (block and lanes > 0 and lanes % LANES == 0)


def _check(data: torch.Tensor, x2: torch.Tensor, offsets, symmetric: bool,
           block: bool = False):
    if data.device != x2.device:
        raise ValueError(f"data on {data.device} but x on {x2.device}")
    if data.dtype not in DTYPES or x2.dtype != data.dtype:
        raise TypeError(f"DIA apply takes float32, float64 or bfloat16 data "
                        f"and x of the same dtype, got {data.dtype} and {x2.dtype}")
    k = len(offsets)
    if k < 1:
        raise ValueError("a DIA apply needs at least one diagonal")
    if symmetric and max(offsets) > 0:
        raise ValueError("symmetric DIA stores offsets <= 0 only")
    if data.dim() != 3 or data.shape[2] != k * LANES:
        raise ValueError(f"data must be (D, R, {k}*128), got {tuple(data.shape)}")
    nd, nr = data.shape[0], data.shape[1]
    if x2.dim() != 2 or x2.shape[0] != nd * nr or not _lanes_ok(x2.shape[1], block):
        raise ValueError(f"x must be ({nd * nr}, {'nrhs*' if block else ''}128) "
                         f"for data {tuple(data.shape)}, got {tuple(x2.shape)}")
    if not (data.is_contiguous() and x2.is_contiguous()):
        raise ValueError("DIA apply takes contiguous data and x")


def spmv_dia_stacked(
    data: torch.Tensor,
    x2: torch.Tensor,
    offsets: tuple[int, ...],
    symmetric: bool,
) -> torch.Tensor:
    """Stacked-shard lane-layout apply, one launch for all D shards:
    data (D, R, K*128), x2 (D*R, 128) -> y2 (D*R, 128). Shard s reads only
    its own R*128 entries of x (zero outside)."""
    _check(data, x2, offsets, symmetric)
    if x2.device.type == "cpu":
        return spmv_dia_stacked_plain(data, x2, offsets, symmetric)
    if x2.device.type != "cuda":
        raise RuntimeError(f"no DIA kernel for device {x2.device}")
    from spmv_torch._build import load_library

    lib = load_library()
    nd, nr = data.shape[0], data.shape[1]
    y2 = torch.empty_like(x2)
    offs = device_offsets(tuple(offsets), x2.device)
    name = ("dia_sym_spmv_" if symmetric else "dia_spmv_") + DTYPES[data.dtype]
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        rc = getattr(lib, name)(data.data_ptr(), x2.data_ptr(), y2.data_ptr(),
                                nr * LANES, len(offsets), offs.data_ptr(),
                                nd, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    launches["dia_sym" if symmetric else "dia"] += 1
    return y2


def spmv_dia_2d(a: DiaMatrix, x2: torch.Tensor) -> torch.Tensor:
    """Lane-layout SpMV: x2 (nrows_pad/128, 128) -> y (nrows_pad/128, 128).
    Dispatches to the symmetric kernel when ``a.symmetric``."""
    return spmv_dia_stacked(a.data.unsqueeze(0), x2, a.offsets, a.symmetric)


def spmv_dia(a: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """Flat-vector SpMV: x of length nrows_pad -> y of length nrows_pad."""
    if x.shape != (a.nrows_pad,):
        raise ValueError(f"x must have length {a.nrows_pad}, got {tuple(x.shape)}")
    return spmv_dia_2d(a, x.view(-1, LANES)).view(-1)
