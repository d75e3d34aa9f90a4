"""The port's JSON text of float arrays and of the upload's reply
(``csrc/json_f32.cpp``).

``json_f32_array(arr) -> str`` has ``native.json_f32_array``'s contract
and bytes: float32 1-D in, ``[v0,v1,...]`` out, each value as "%.5g"
writes it, NaN and +-inf as ``0``.  The C++ rounds each value to five
digits in exact integer arithmetic instead of calling ``snprintf``, and
splits an array of 2^16 values or more into 8 slices a thread for up to
``THREADS`` threads, which take them in turn, inside the one call (ctypes
releases the GIL around it): the upload reply's two 892,800-value
arrays.  The plot pump's and the pool's 256-sample replies run on the
calling thread.

The source builds with g++ at first use into
``build/aefs_tpu_torch/libaefs_jsonfmt-<hash>.so`` (the hash covers the
source and the flags).  If the build or the load fails, every call goes
to ``native.json_f32_array``, the same bytes.

``reply(head, arrays) -> str`` is the ``file_processed`` reply's text:
``json.dumps(head)`` with ``,"<key>":<json_f32_array(arr)>`` for each of
``arrays`` before its closing brace, written by one C call into one
buffer.  ``head``'s 2-D float32 arrays are written as ``json.dumps``
writes their ``.tolist()``, its ``bytes`` as strings without escapes (the port's
own base64), its ``str`` scanned and, when not plain printable ASCII,
escaped by ``json.dumps``.  Without the library the same text is built by
``json.dumps`` and concatenation.

Counters (``utils/metrics.py:TRACER``): ``jsonfmt.values``,
``jsonfmt.fallbacks`` (values formatted by ``snprintf``: subnormals,
|v| >= 1e9, or every value when the library is missing) and
``jsonfmt.slices``, for every ``json_f32_array`` and every array of a
reply; ``jsonfmt.reply_writes`` (replies written natively),
``jsonfmt.reply_fallbacks`` (replies built by ``json.dumps``) and
``jsonfmt.escaped_strings`` (a native reply's strings that needed
escaping).

A reply's buffer is kept for the next reply (``_spare``), so the pages
of a ~30 MB reply are mapped and faulted in once per process, not once
per upload.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from aefs_tpu_torch.utils.metrics import NO_SPAN, TRACER

_PKG = Path(__file__).resolve().parents[1]
SRC = _PKG / "csrc" / "json_f32.cpp"
BUILD_DIR = _PKG.parent / "build" / "aefs_tpu_torch"
CXX = "g++"
# Portable code, as native.py builds: no -march.
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
THREADS = min(len(os.sched_getaffinity(0)), 8)

_lib = None  # the library, or False once its build or load failed
_lock = threading.Lock()
_spare = []  # reply buffers between replies (list.pop/append: one per caller)


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
                lib.aefs_json_plain.argtypes = [p, i64]
                lib.aefs_json_plain.restype = ctypes.c_int
                lib.aefs_json_bound.argtypes = [ctypes.c_int32, i64, i64]
                lib.aefs_json_bound.restype = i64
                lib.aefs_json_reply.argtypes = [i64, p, p, p, p, ctypes.c_int, p]
                lib.aefs_json_reply.restype = i64
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


# Segment kinds of ``aefs_json_reply``.
TEXT, REPR, G5 = 0, 1, 2


def plain(obj):
    """``obj`` as ``json.dumps`` takes it: arrays as ``.tolist()``,
    ``bytes`` as ASCII text, dicts item by item."""
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, bytes):
        return obj.decode("ascii")
    return obj


def _pieces(obj, lib, out):
    """Append ``json.dumps(plain(obj))`` to ``out`` as pieces: ``bytes``
    of text, or a float32 array that the C call formats."""
    if isinstance(obj, dict) and all(isinstance(k, str) for k in obj):
        out.append(b"{")
        for i, (k, v) in enumerate(obj.items()):
            out.append((", " if i else "").encode() + json.dumps(k).encode() + b": ")
            _pieces(v, lib, out)
        out.append(b"}")
    elif isinstance(obj, np.ndarray) and obj.dtype == np.float32 and obj.ndim == 2:
        out.append(obj)
    elif isinstance(obj, bytes):
        out += [b'"', obj, b'"']
    elif isinstance(obj, str):
        raw = obj.encode("ascii") if obj.isascii() else None
        if raw is not None and lib.aefs_json_plain(raw, len(raw)):
            out += [b'"', raw, b'"']
        else:
            TRACER.count("jsonfmt.escaped_strings")
            out.append(json.dumps(obj).encode("ascii"))
    else:
        out.append(json.dumps(plain(obj)).encode("ascii"))


def _segments(pieces):
    """``aefs_json_reply``'s segments as ``(kind, array, d0, d1)``."""
    segs = []
    for piece in pieces:
        if isinstance(piece, bytes):
            segs.append((TEXT, np.frombuffer(piece, np.uint8), len(piece), 0))
        elif isinstance(piece, tuple):  # (G5, a sample array)
            arr = np.ascontiguousarray(piece[1], np.float32).reshape(-1)
            segs.append((G5, arr, arr.size, 0))
        else:
            arr = np.ascontiguousarray(piece)
            segs.append((REPR, arr, *arr.shape))
    return segs


def reply(head: dict, arrays: dict, span: str | None = None, rid=None) -> str:
    """``json.dumps(plain(head))`` with ``,"<key>":`` + ``json_f32_array(arr)``
    for each item of ``arrays`` before its closing brace.  The arrays'
    formatting is kept as span ``span`` of request ``rid`` (natively, the
    stretch of the C call that formats them)."""
    lib = library()
    if lib is None:
        TRACER.count("jsonfmt.reply_fallbacks")
        text = json.dumps(plain(head))
        with TRACER.span(span, rid) if span else NO_SPAN:
            tail = [f",{json.dumps(k)}:" + json_f32_array(v) for k, v in arrays.items()]
        return text[:-1] + "".join(tail) + "}"
    pieces = []
    _pieces(head, lib, pieces)
    pieces[-1] = pieces[-1][:-1]  # the head's closing brace
    for k, v in arrays.items():
        pieces += [f",{json.dumps(k)}:".encode(), (G5, v)]
    pieces.append(b"}")
    segs = _segments(pieces)
    # Every array the C call reads stays referenced until it returns.
    kinds = np.array([k for k, _a, _d0, _d1 in segs], np.int32)
    ptrs = np.array([a.ctypes.data for _k, a, _d0, _d1 in segs], np.uintp)
    dims = np.array([(d0, d1) for _k, _a, d0, d1 in segs], np.int64)
    need = sum(lib.aefs_json_bound(k, d0, d1) for k, _a, d0, d1 in segs)
    try:
        buf = _spare.pop()
    except IndexError:
        buf = None
    if buf is None or buf.size < need:
        buf = np.empty(need, np.uint8)
    stats = np.zeros(4, np.int64)
    n = lib.aefs_json_reply(len(segs), kinds.ctypes.data, ptrs.ctypes.data, dims.ctypes.data,
                            buf.ctypes.data, THREADS, stats.ctypes.data)
    TRACER.count("jsonfmt.reply_writes")
    TRACER.count("jsonfmt.values", sum(d0 for k, _a, d0, _d1 in segs if k == G5))
    TRACER.count("jsonfmt.fallbacks", int(stats[0]))
    TRACER.count("jsonfmt.slices", int(stats[1]))
    if span and TRACER.enabled and stats[2]:
        TRACER.record(span, rid, int(stats[2]), int(stats[3]))
    text = str(memoryview(buf)[:n], "ascii")
    if len(_spare) < 2:
        _spare.append(buf)
    return text
