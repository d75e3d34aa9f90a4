"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Every ``.cu`` file under ``aefs_tpu_torch/csrc/`` is compiled by ``nvcc``
at first use into ONE shared library with a plain C interface
(``build/aefs_tpu_torch/libaefs_kernels-<hash>.so``, named by a hash of
the sources and flags so an edited source rebuilds), then loaded with
ctypes.  No PyTorch headers are compiled, so the build takes seconds.

Each kernel module (``resample.py``: K1, K3, the octaver's and the
chorus's block steps; ``comb.py``: K2, K4; ``biquad.py``: K5, the biquad's
streaming block step; ``flanger.py``: K6, the flanger's line solve)
holds the wrappers, their plain versions and one launch counter per
wrapper.  A wrapper takes the plain version only for
CPU tensors; on CUDA tensors it launches the kernel or raises.  A sharded step launches on every card from one thread: each
wrapper makes its operands' card current around the call for PyTorch, and
passes its index to the C entry, which makes it current for the library's
own CUDA runtime before launching.

Each wrapper counts its launches on its own ``launches`` attribute through
``tick``.  A launch made while the calling thread captures a CUDA graph
(``recording``) is recorded for that capture instead: the kernel did not
run, and each replay of the graph adds the captured counts
(``core/packing.py:PackedRunner``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "aefs_tpu_torch"
# -fmad=false: the step kernels repeat the plain versions' double-single
# phase arithmetic and Hermite operation order and must not contract a*b+c
# into FMAs (the two then agree bit for bit); the comb kernel's sums and
# scans likewise round every product like the eager reference does.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lib = None
_lock = threading.Lock()
_capture = threading.local()  # .record: {wrapper: launches} of this thread's capture


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME")


def build() -> Path:
    """Compile csrc/*.cu into the shared library (cached by content hash);
    returns its path.  Raises on a compiler error."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"libaefs_kernels-{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, so)
    return so


def library():
    """The loaded kernel library (built on first call), with argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            ll, f = ctypes.c_longlong, ctypes.c_float
            lib.aefs_octaver_step.argtypes = [p, ll, ll, i, i, i, p, i] + [p] * 9 + [i, p]
            lib.aefs_octaver_step.restype = i
            lib.aefs_chorus_step.argtypes = [p, ll, ll, i, i, i, p, i, f] + [p] * 8 + [i, p]
            lib.aefs_chorus_step.restype = i
            lib.aefs_comb_sums.argtypes = [
                p, i, i, i, p, p, p, i, p, p, i, i, i, i, p, p, p, i, p]
            lib.aefs_comb_sums.restype = i
            lib.aefs_comb_chunks.argtypes = [p, i, i, i, p, p, p, p, i, i, i, p, p, i, p]
            lib.aefs_comb_chunks.restype = i
            lib.aefs_biquad_step.argtypes = [p, ll, ll, i, i, i, p, i] + [p] * 5 + [i, p]
            lib.aefs_biquad_step.restype = i
            lib.aefs_flanger_file.argtypes = [p] * 8 + [i, i, i, i, p]
            lib.aefs_flanger_file.restype = i
            _lib = lib
    return _lib


def check(err: int, what: str):
    """Raise if a launch reported a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the int ctypes takes
    (the raw handle, without building a ``torch.cuda.Stream``)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def require_cuda_f32(name, t, shape=None):
    """Validate a kernel operand: CUDA, float32, contiguous, and ``shape``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def tick(wrapper):
    """Count one launch of ``wrapper``'s kernel: on ``wrapper.launches``,
    or on the record of the capture this thread is making."""
    record = getattr(_capture, "record", None)
    if record is None:
        wrapper.launches += 1
    else:
        record[wrapper] = record.get(wrapper, 0) + 1


@contextlib.contextmanager
def recording():
    """Record this thread's kernel launches in the yielded {wrapper:
    launches} dict instead of counting them on the wrappers."""
    record = _capture.record = {}
    try:
        yield record
    finally:
        _capture.record = None


def credit(record):
    """Count the launches of one replay of a captured ``record``."""
    for wrapper, n in record.items():
        wrapper.launches += n
