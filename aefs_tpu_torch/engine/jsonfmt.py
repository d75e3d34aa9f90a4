"""The port's JSON text of float arrays (``csrc/json_f32.cpp``).

``json_f32_array(arr) -> str`` has ``native.json_f32_array``'s contract
and bytes: float32 1-D in, ``[v0,v1,...]`` out, each value as "%.5g"
writes it, NaN and +-inf as ``0``.  The C++ rounds each value to five
digits in exact integer arithmetic instead of calling ``snprintf``, and
splits an array of 2^16 values or more over up to ``THREADS`` threads
inside the one call (ctypes releases the GIL around it): the upload
reply's two 892,800-value arrays.  The plot pump's and the pool's
256-sample replies run on the calling thread.

The source builds with g++ at first use into
``build/aefs_tpu_torch/libaefs_jsonfmt-<hash>.so`` (the hash covers the
source and the flags).  If the build or the load fails, every call goes
to ``native.json_f32_array``, the same bytes.

Counters (``utils/metrics.py:TRACER``): ``jsonfmt.values``,
``jsonfmt.fallbacks`` (values formatted by ``snprintf``: subnormals,
|v| >= 1e9, or every value when the library is missing) and
``jsonfmt.slices``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from aefs_tpu_torch.utils.metrics import TRACER

_PKG = Path(__file__).resolve().parents[1]
SRC = _PKG / "csrc" / "json_f32.cpp"
BUILD_DIR = _PKG.parent / "build" / "aefs_tpu_torch"
CXX = "g++"
# Portable code, as native.py builds: no -march.
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
THREADS = min(len(os.sched_getaffinity(0)), 8)

_lib = None  # the library, or False once its build or load failed
_lock = threading.Lock()


def build() -> Path:
    """Compile the source (cached by a hash of it and the flags); returns
    the library's path.  Raises on a compiler error."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SRC.read_bytes())
    so = BUILD_DIR / f"libaefs_jsonfmt-{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SRC)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{CXX} failed ({res.returncode}):\n{' '.join(cmd)}\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)
    return so


def library():
    """The loaded library (built on first call), or None if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except (OSError, RuntimeError) as e:
                print(f"Warning: {SRC.name} unavailable, using native.json_f32_array: {e}")
                _lib = False
            else:
                i64, p = ctypes.c_int64, ctypes.c_void_p
                lib.aefs_json_f32_array.argtypes = [p, i64, p, ctypes.c_int, p, p]
                lib.aefs_json_f32_array.restype = i64
                _lib = lib
    return _lib or None


def json_f32_array(arr) -> str:
    """float32 1-D array -> JSON list text, ``native.json_f32_array``'s
    bytes."""
    arr = np.ascontiguousarray(arr, np.float32).reshape(-1)
    TRACER.count("jsonfmt.values", arr.size)
    lib = library()
    if lib is None:
        from aefs_tpu_torch import native

        TRACER.count("jsonfmt.fallbacks", arr.size)
        return native.json_f32_array(arr)
    buf = np.empty(arr.size * 16 + 3, np.uint8)
    fallbacks, slices = ctypes.c_int64(), ctypes.c_int64()
    n = lib.aefs_json_f32_array(arr.ctypes.data, arr.size, buf.ctypes.data, THREADS,
                                ctypes.byref(fallbacks), ctypes.byref(slices))
    TRACER.count("jsonfmt.fallbacks", fallbacks.value)
    TRACER.count("jsonfmt.slices", slices.value)
    return ctypes.string_at(buf.ctypes.data, n).decode("ascii")
