"""PFM / PGM readers and writer — capability of fileIoUtils.h:370-475
(ground-truth disparity input).

A numpy copy of ``gipuma_tpu/io/pfm.py:11-53``; the port keeps its own."""
from __future__ import annotations

import os
import re

import numpy as np


def read_pfm(path: str | os.PathLike) -> np.ndarray:
    """Read PF (color) / Pf (gray) PFM; handles both endiannesses and the
    bottom-up row order of the format."""
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").strip()
        if header not in ("PF", "Pf"):
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        color = header == "PF"
        dims = f.readline().decode("latin-1")
        while dims.startswith("#"):
            dims = f.readline().decode("latin-1")
        w, h = (int(v) for v in dims.split())
        scale = float(f.readline().decode("latin-1").strip())
        endian = "<" if scale < 0 else ">"
        count = w * h * (3 if color else 1)
        data = np.frombuffer(f.read(4 * count), dtype=endian + "f4", count=count)
    shape = (h, w, 3) if color else (h, w)
    # PFM stores rows bottom-to-top.
    return np.flipud(data.reshape(shape)).copy()


def write_pfm(path: str | os.PathLike, arr: np.ndarray) -> None:
    arr = np.asarray(arr, dtype=np.float32)
    color = arr.ndim == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{arr.shape[1]} {arr.shape[0]}\n".encode())
        f.write(b"-1.0\n")  # little-endian
        f.write(np.flipud(arr).astype("<f4").tobytes())


def read_pgm(path: str | os.PathLike) -> np.ndarray:
    """Binary P5 PGM (8- or 16-bit)."""
    with open(path, "rb") as f:
        data = f.read()
    m = re.match(rb"P5\s+(?:#.*\s+)?(\d+)\s+(\d+)\s+(\d+)\s", data)
    if not m:
        raise ValueError(f"{path}: not a binary PGM")
    w, h, maxval = (int(m.group(i)) for i in (1, 2, 3))
    offset = m.end()
    dtype = np.dtype(">u2") if maxval > 255 else np.uint8
    img = np.frombuffer(data, dtype=dtype, count=w * h, offset=offset)
    return img.reshape(h, w).astype(np.float32)
