"""Build the CUDA kernels (csrc/*.cu) with nvcc at first use and bind them
with ctypes.

The library has a plain C interface, so nvcc builds it in seconds (no
PyTorch headers): one nvcc per source, all started together, then one
link. It goes to ``build/spmv_torch/lib<content-hash>.so`` at the
repository root, written under a temporary name and moved into place with
``os.replace`` so a concurrent process never loads a half-written file.
A failed build raises with nvcc's output: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "spmv_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points -> argument types; each returns a CUDA error code (int)
_DIA_ARGS = [_P, _P, _P, _L, _I, _P, _I, _P]  # data, x, y, npad, ndiags,
#                                               offsets, nshards, stream
_WELL_ARGS = [_P, _P, _P, _P, _P, _L, _I, _I, _L, _I, _P]  # values, pos, w0,
#                 x, y, ngroups, k, tile_groups, col_pad, nshards, stream
KERNEL_ENTRIES = {
    **{f"{n}_{t}": _DIA_ARGS for n in ("dia_spmv", "dia_sym_spmv")
       for t in ("f32", "f64")},
    **{f"well_spmv_{t}_{p}": _WELL_ARGS for t in ("f32", "f64")
       for p in ("i16", "i32")},
}

_lib: ctypes.CDLL | None = None


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
    for src in sorted(CSRC.glob("*.cu")):
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
        path = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in KERNEL_ENTRIES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
