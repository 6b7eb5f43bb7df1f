"""ctypes bindings for the native C++ IO library
(``gipuma_tpu_torch/native/gipuma_io.cpp``).

Counterpart of ``gipuma_tpu/io/native.py``, with the same entry points.
The reference keeps its IO hot paths native (OpenMP PLY writer,
displayUtils.h:77-237; raw-FILE dmb IO, fileIoUtils.h:247-368); so does
the port: the shared library is built from the package's own copy of the
source with ``g++`` on first use, into ``gipuma_tpu_torch/build/`` (the
file name carries a hash of the source and flags, so a changed source is
rebuilt).  Every entry point returns None / False where the library cannot
be built or loaded, and the callers (io/dmb.py, io/ply.py) then write and
read with numpy, as the JAX package does.  This is host IO: no device is
involved.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "native" / "gipuma_io.cpp"
_BUILD_DIR = _PKG / "build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None
_lib_tried = False
_lock = threading.Lock()


def _lib_path() -> Path:
    h = hashlib.sha1(_SRC.read_bytes()
                     + " ".join([CXX] + CXX_FLAGS).encode()).hexdigest()[:12]
    return _BUILD_DIR / f"libgipuma_io-{h}.so"


def _load():
    """Build (if needed) and load the native library; None on failure."""
    global _lib, _lib_tried
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        try:
            path = _lib_path()
            if not path.exists():
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                # Build beside the target and rename: processes that build
                # at once never load a half-written library.
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
            lib.gip_write_ply.restype = ctypes.c_longlong
            lib.gip_write_ply.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_uint8)]
            lib.gip_write_dmb.restype = ctypes.c_int
            lib.gip_write_dmb.argtypes = [
                ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_float)]
            lib.gip_read_dmb_header.restype = ctypes.c_int
            lib.gip_read_dmb_header.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32)]
            lib.gip_read_dmb_data.restype = ctypes.c_int
            lib.gip_read_dmb_data.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_longlong]
            _lib = lib
        except (OSError, subprocess.SubprocessError):
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def write_ply_native(path, points: np.ndarray, normals: np.ndarray,
                     colors: np.ndarray) -> int | None:
    """Native binary PLY write; returns the vertex count, or None (the
    caller falls back to numpy)."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float32)
    nrm = np.ascontiguousarray(normals, dtype=np.float32)
    col = np.ascontiguousarray(np.clip(colors, 0, 255), dtype=np.uint8)
    if col.ndim == 1:
        col = np.repeat(col[:, None], 3, axis=1).copy()
    n = lib.gip_write_ply(
        str(path).encode(), pts.shape[0], _fptr(pts), _fptr(nrm),
        col.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return None if n < 0 else int(n)


def write_dmb_native(path, arr: np.ndarray) -> bool:
    """Native .dmb write; False when the library is unavailable or the
    write failed (the caller falls back to numpy)."""
    lib = _load()
    if lib is None:
        return False
    a = np.ascontiguousarray(arr, dtype=np.float32)
    if a.ndim == 2:
        h, w, nb = a.shape[0], a.shape[1], 1
    else:
        h, w, nb = a.shape
    return lib.gip_write_dmb(str(path).encode(), h, w, nb, _fptr(a)) == 0


def read_dmb_native(path) -> np.ndarray | None:
    """Native .dmb read -> [h, w] or [h, w, nb] float32, or None (the
    caller falls back to numpy)."""
    lib = _load()
    if lib is None:
        return None
    h = ctypes.c_int32()
    w = ctypes.c_int32()
    nb = ctypes.c_int32()
    if lib.gip_read_dmb_header(str(path).encode(), ctypes.byref(h),
                               ctypes.byref(w), ctypes.byref(nb)) != 0:
        return None
    count = h.value * w.value * nb.value
    out = np.empty(count, dtype=np.float32)
    if lib.gip_read_dmb_data(str(path).encode(), _fptr(out), count) != 0:
        return None
    if nb.value == 1:
        return out.reshape(h.value, w.value)
    return out.reshape(h.value, w.value, nb.value)
