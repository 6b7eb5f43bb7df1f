"""DMB binary depth/normal map format — byte-compatible with the reference
(fileIoUtils.h:247-368), with fusibile's inputs and with the JAX package's
writer.

Layout: four little-endian int32 (type=1 for float, h, w, nb) followed by
h*w*nb float32 values, row-major, channels interleaved.  Reads and writes
go through the native library (io/native.py) when it builds, and through
numpy otherwise, as in the JAX package; the bytes are the same.
"""
from __future__ import annotations

import os
import struct

import numpy as np

_HEADER = struct.Struct("<iiii")


def read_dmb(path: str | os.PathLike) -> np.ndarray:
    """Read a .dmb file -> [h, w] (nb==1) or [h, w, nb] float32 array."""
    from .native import read_dmb_native
    out = read_dmb_native(path)
    if out is not None:
        return out
    with open(path, "rb") as f:
        dtype_tag, h, w, nb = _HEADER.unpack(f.read(16))
        if dtype_tag != 1:
            raise ValueError(f"{path}: unsupported dmb type {dtype_tag} (only float=1)")
        data = np.frombuffer(f.read(4 * h * w * nb), dtype="<f4", count=h * w * nb)
    if nb == 1:
        return data.reshape(h, w).copy()
    return data.reshape(h, w, nb).copy()


def write_dmb(path: str | os.PathLike, arr: np.ndarray) -> None:
    """Write [h, w] or [h, w, nb] float32 array as .dmb."""
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim == 2:
        h, w = arr.shape
        nb = 1
    elif arr.ndim == 3:
        h, w, nb = arr.shape
    else:
        raise ValueError(f"dmb arrays are 2-D or 3-D, got shape {arr.shape}")
    from .native import write_dmb_native
    if write_dmb_native(path, arr):
        return
    with open(path, "wb") as f:
        f.write(_HEADER.pack(1, h, w, nb))
        f.write(np.ascontiguousarray(arr, dtype="<f4").tobytes())
