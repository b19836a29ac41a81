"""Build the CUDA kernels (csrc/*.cu) with nvcc at first use and bind them
with ctypes.

The library has a plain C interface, so nvcc builds it in seconds (no
PyTorch headers). It goes to ``build/spmv_torch/lib<content-hash>.so`` at
the repository root, written under a temporary name and moved into place
with ``os.replace`` so a concurrent process never loads a half-written file.
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
              "-shared", "-Xcompiler", "-fPIC")
# C entry points: (data, x, y, npad, ndiags, offsets, nshards, stream) -> int
KERNEL_ENTRIES = ("dia_spmv_f32", "dia_spmv_f64",
                  "dia_sym_spmv_f32", "dia_sym_spmv_f64")

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
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
           *[str(p) for p in sorted(CSRC.glob("*.cu"))]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (rc={proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    if _lib is None:
        path = build()
        lib = ctypes.CDLL(str(path))
        for name in KERNEL_ENTRIES:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
