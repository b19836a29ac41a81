"""Build the CUDA kernels (csrc/*.cu, with their csrc/*.cuh headers) with
nvcc at first use, bind them with ctypes, and launch them.

The library has a plain C interface, so nvcc builds it in seconds (no
PyTorch headers): one nvcc per source, all started together, then one
link. It goes to ``build/spmv_torch/lib<content-hash>.so`` at the
repository root, written under a temporary name and moved into place with
``os.replace`` so a concurrent process never loads a half-written file.
A failed build raises with nvcc's output: there is no fallback.

Every wrapper in ``ops/`` launches through ``launch``, which passes the
device's current stream last, raises on a failed launch and counts it in
``launches`` by the wrapper's key (none on the plain CPU paths), so a run
can show which kernels its path went through.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "spmv_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points -> argument types; each returns a CUDA error code (int)
_DIA_ARGS = [_P, _P, _P, _L, _I, _P, _I, _P]  # data, x, y, npad, ndiags,
#                            offsets (on the card), nshards, stream
_DIA_WIN_ARGS = [_P, _P, _P, _L, _I, _P, _I, _I, _I, _P]  # data, x, y, npad,
#     ndiags, window plan (on the card), tile rows, shared bytes, nshards,
#     stream (the tile kernel of csrc/dia_window.cuh)
_DIA_ROWS_ARGS = [_P, _P, _P, _L, _I, _P, _I, _I, _P]  # data, x, y, npad,
#     ndiags, offsets (in host memory), rows a thread, nshards, stream
_DIA_STREAM_ARGS = [_P, _P, _P, _L, _I, _P, _P, _I, _P]  # data, x, y, npad,
#     ndiags, plan words (in host memory), zeros (on the card), nshards,
#     stream (the stream kernel of csrc/dia_stream.cu)
_WELL_ARGS = [_P] * 6 + [_L, _L, _I, _L, _I, _P]  # values, pos, slice_ptr,
#                 w0, x, y, nslices, entries, tile_groups, col_pad, nshards,
#                 stream (the row lists)
_WELL_SYM_ARGS = ([_P] * 4 + [_L, _I]) * 2 + [_P, _P, _P, _L, _L, _I, _P]
#     L's values, pos, slice_ptr, w0, entries, tile_groups, the same of L^T,
#     diagonal, x, y, nslices, col_pad, nshards, stream
_DIA_DS_ARGS = [_P, _P, _P, _P, _P, _P, _L, _I, _P, _I, _P]  # data hi, lo,
#                 x hi, lo, y hi, lo, npad, ndiags, offsets, nshards, stream
_WELL_DS_ARGS = [_P] * 9 + [_L, _L, _I, _L, _I, _P]  # values hi, lo, pos,
#                 slice_ptr, w0, x hi, lo, y hi, lo, nslices, entries,
#                 tile_groups, col_pad, nshards, stream
# the block (SpMM) entries: the single-RHS arguments plus nrhs before
# nshards
_DIA_SPMM_ARGS = _DIA_ARGS[:6] + [_I] + _DIA_ARGS[6:]
_DIA_WIN_SPMM_ARGS = _DIA_WIN_ARGS[:8] + [_I] + _DIA_WIN_ARGS[8:]
_WELL_SPMM_ARGS = _WELL_ARGS[:10] + [_I] + _WELL_ARGS[10:]
_DIA_DS_SPMM_ARGS = _DIA_DS_ARGS[:9] + [_I] + _DIA_DS_ARGS[9:]
_WELL_DS_SPMM_ARGS = _WELL_DS_ARGS[:13] + [_I] + _WELL_DS_ARGS[13:]
# the CG update (csrc/cg_update.cu): vectors, n, scalars, [partials,
# ticket,] partials' length (the most blocks), [rtol,] stream
_CG_PAP_ARGS = [_P, _P, _L, _P, _P, _P, _I, _P]
_CG_R_ARGS = [_P, _P, _L, _P, _P, _P, _I, ctypes.c_double, _P]
_CG_XP_ARGS = [_P, _P, _P, _L, _P, _I, _P]
# the multigrid smoother and restriction (csrc/symgs_dia.cu): data, r, x,
# w in and w out or rc, grid steps (on the card), ndiags, nx, ny, nz,
# [forward, the band lines of the direction's two launches,] stream
_SYMGS_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
_RESTRICT_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
KERNEL_ENTRIES = {
    **{f"dia_spmv_{t}": _DIA_ARGS for t in ("f32", "f64", "bf16")},
    **{f"dia_spmv_rows_{t}": _DIA_ROWS_ARGS for t in ("f32", "f64", "bf16")},
    **{f"dia_sym_spmv_{t}": _DIA_WIN_ARGS for t in ("f32", "f64", "bf16")},
    **{f"dia_sym_spmv_stream_{t}": _DIA_STREAM_ARGS for t in ("f32", "f64", "bf16")},
    **{f"well_spmv_{t}_{p}": _WELL_ARGS for t in ("f32", "f64")
       for p in ("i16", "i32")},
    **{f"well_sym_spmv_{t}_{p}_{q}": _WELL_SYM_ARGS for t in ("f32", "f64")
       for p in ("i16", "i32") for q in ("i16", "i32")},
    "dia_ds_spmv": _DIA_DS_ARGS,
    **{f"well_ds_spmv_{p}": _WELL_DS_ARGS for p in ("i16", "i32")},
    **{f"dia_spmm_{t}": _DIA_WIN_SPMM_ARGS for t in ("f32", "f64", "bf16")},
    **{f"dia_sym_spmm_{t}": _DIA_SPMM_ARGS for t in ("f32", "f64", "bf16")},
    **{f"well_spmm_{t}_{p}": _WELL_SPMM_ARGS for t in ("f32", "f64")
       for p in ("i16", "i32")},
    "dia_ds_spmm": _DIA_DS_SPMM_ARGS,
    **{f"well_ds_spmm_{p}": _WELL_DS_SPMM_ARGS for p in ("i16", "i32")},
    **{f"cg_pap_{t}": _CG_PAP_ARGS for t in ("f32", "f64")},
    **{f"cg_update_r_{t}": _CG_R_ARGS for t in ("f32", "f64")},
    **{f"cg_update_xp_{t}": _CG_XP_ARGS for t in ("f32", "f64")},
    **{f"symgs_dia_{t}": _SYMGS_ARGS for t in ("f32", "f64")},
    **{f"mg_restrict_{t}": _RESTRICT_ARGS for t in ("f32", "f64")},
}

_lib: ctypes.CDLL | None = None
# seconds of ``load_library``'s first use: the build where the library is
# not built yet, then the binding
library = {"load_s": 0.0}
# kernel launches by key: the wrapper's name ("dia_sym", "well_ds_spmm",
# "cg_pap", ...), or (kernel, grid) for the multigrid's
launches: collections.Counter = collections.Counter()


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise with the first failure's
    output after all have ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, text in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (rc={proc.returncode}): {' '.join(cmd)}\n{text}")


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it is built."""
    out = library_path()
    if out.exists():
        return out
    nvcc = nvcc_path()
    if not Path(nvcc).exists():
        raise RuntimeError(f"nvcc not found (looked for {nvcc}); the CUDA "
                           "kernels need the CUDA toolkit")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [str(Path(tmpdir) / f"{src.stem}.o")
                for src in sorted(CSRC.glob("*.cu"))]
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
              for obj, src in zip(objs, sorted(CSRC.glob("*.cu")))])
        tmp = str(Path(tmpdir) / out.name)
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    if _lib is None:
        t0 = time.perf_counter()
        path = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in KERNEL_ENTRIES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        library["load_s"] = time.perf_counter() - t0
    return _lib


def launch(entry: str, device: torch.device, *args, key, count: int = 1) -> None:
    """Call the C entry ``entry`` with ``args`` and ``device``'s current
    stream last; raise if it returns a CUDA error, else count ``count``
    launches under ``key``."""
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    launches[key] += count
