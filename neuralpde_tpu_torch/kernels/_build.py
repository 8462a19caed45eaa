"""Build the port's CUDA kernels and load them.

Every `csrc/*.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into one
shared library with a plain C interface, `build/kernels/libneuralpde_kernels.so`
at the root of the checkout, at first use; `ctypes` loads it.  The library is
rebuilt when it is missing or older than a source.  ptxas reports each
kernel's registers and spills (`-Xptxas -v`).  Nothing here runs at import
time, so the package imports on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIBRARY = BUILD_DIR / "libneuralpde_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the CUDA kernels")
    return found


def build_library(force: bool = False) -> str:
    """Compile `csrc/*.cu` into `LIBRARY` if it is missing or stale, or
    always with ``force``.  Returns the compiler's diagnostics (empty when
    nothing was built)."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not force and LIBRARY.exists() and all(
            LIBRARY.stat().st_mtime >= s.stat().st_mtime for s in sources):
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    partial = LIBRARY.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(partial),
           *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        partial.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(partial, LIBRARY)
    return proc.stdout + proc.stderr


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernel library (once per process)."""
    build_library()
    lib = ctypes.CDLL(str(LIBRARY))
    lib.neuralpde_cuda_error_string.argtypes = [ctypes.c_int]
    lib.neuralpde_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.neuralpde_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
