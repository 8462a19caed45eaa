"""Native host-runtime components (C++ through ctypes).

`sobol.cpp` is the port's own copy of the high-dimensional Sobol engine:
`ops.sampling.sobol_bits` calls it for dimensions beyond the embedded
Joe-Kuo table.  It is compiled with g++ at first use into
``build/native/libsobol.so`` at the root of the checkout (git-ignored) and
rebuilt when the source is newer.  Nothing here runs at import time; with
no g++ the engine is unavailable and `available()` says so.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "sobol.cpp"
LIBRARY = Path(__file__).resolve().parents[2] / "build" / "native" / "libsobol.so"

_lock = threading.Lock()
_state: dict = {}


def _build() -> None:
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    partial = LIBRARY.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(partial),
                    str(SOURCE)], check=True, capture_output=True, timeout=120)
    os.replace(partial, LIBRARY)


def _load() -> ctypes.CDLL | None:
    """The bound library, built if missing or stale; None without g++."""
    with _lock:
        if "lib" not in _state:
            _state["lib"] = None
            try:
                if (not LIBRARY.exists()
                        or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime):
                    _build()
                lib = ctypes.CDLL(str(LIBRARY))
            except (OSError, subprocess.SubprocessError):
                return None
            lib.sobol_points.argtypes = [ctypes.c_uint32, ctypes.c_uint32,
                                         ctypes.c_uint32,
                                         np.ctypeslib.ndpointer(np.uint32)]
            lib.sobol_points.restype = ctypes.c_int
            lib.sobol_max_dim.restype = ctypes.c_int
            _state["lib"] = lib
        return _state["lib"]


def available() -> bool:
    return _load() is not None


def sobol_bits_native(points: int, dim: int, skip: int = 0) -> np.ndarray:
    """Sobol bit patterns from the native engine, shape (dim, points)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native Sobol engine unavailable (no g++?)")
    out = np.empty((dim, points), dtype=np.uint32)
    rc = lib.sobol_points(points, dim, skip, out)
    if rc != 0:
        raise RuntimeError(f"sobol_points failed with code {rc}")
    return out
