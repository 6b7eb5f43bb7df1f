"""The files of a scan folder, in the formats the program reads and writes.

The benchmark writes the inputs (8-bit grey PNGs, one ``<image>.P`` file of
the 3x4 projection a view, as the reference CLI's ``-p_folder`` takes them)
and reads the outputs back to judge them (``disp.dmb`` and ``normals.dmb``:
four little-endian int32, type 1, h, w, channels, then float32 values;
``results.txt``: the view's JSON record; ``fused.ply``: a binary
little-endian vertex list whose first three properties are float x, y, z).
Nothing here imports the program.
"""
from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _png_chunk(tag: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(tag + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", crc)


def write_png(path, img: np.ndarray) -> None:
    """An 8-bit grey PNG of `img` [H, W] (values 0..255, integral): filter
    type 0 on every row, zlib level 6."""
    u8 = np.asarray(img)
    if u8.ndim != 2:
        raise ValueError(f"grey images are 2-D, got shape {u8.shape}")
    if not np.array_equal(u8, np.clip(np.round(u8), 0, 255)):
        raise ValueError("image values are not 8-bit levels")
    u8 = u8.astype(np.uint8)
    h, w = u8.shape
    raw = np.hstack([np.zeros((h, 1), np.uint8), u8]).tobytes()
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + _png_chunk(b"IHDR",
                             struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + _png_chunk(b"IDAT", zlib.compress(raw, 6))
                + _png_chunk(b"IEND", b""))


def write_P(path, P: np.ndarray) -> None:
    """A 3x4 projection matrix as three rows of text, every float64 digit
    kept (%.17g round-trips)."""
    np.savetxt(path, np.asarray(P, dtype=np.float64).reshape(3, 4),
               fmt="%.17g")


def read_dmb(path) -> np.ndarray:
    """[h, w] or [h, w, nb] float32 of a .dmb file."""
    with open(path, "rb") as f:
        kind, h, w, nb = struct.unpack("<iiii", f.read(16))
        if kind != 1:
            raise ValueError(f"{path}: dmb type {kind}, not float")
        data = np.frombuffer(f.read(4 * h * w * nb), dtype="<f4",
                             count=h * w * nb)
    return data.reshape((h, w) if nb == 1 else (h, w, nb)).astype(np.float32)


def read_results(path) -> dict:
    """The first JSON record of a view's results.txt."""
    text = Path(path).read_text()
    record, _ = json.JSONDecoder().raw_decode(text.lstrip())
    return record


_PLY_TYPES = {"float": "<f4", "float32": "<f4", "double": "<f8",
              "float64": "<f8", "uchar": "u1", "uint8": "u1", "char": "i1",
              "int8": "i1", "short": "<i2", "ushort": "<u2", "int": "<i4",
              "uint": "<u4", "int32": "<i4", "uint32": "<u4"}


def read_ply_points(path) -> np.ndarray:
    """[N, 3] float64 x, y, z of a binary little-endian PLY vertex list."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt, n, props = None, 0, []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: PLY header has no end_header")
            words = line.decode("latin-1").split()
            if not words:
                continue
            if words[0] == "format":
                fmt = words[1]
            elif words[:2] == ["element", "vertex"]:
                n = int(words[2])
            elif words[0] == "property":
                if words[1] not in _PLY_TYPES:
                    raise ValueError(f"{path}: PLY type {words[1]}")
                props.append((words[2], _PLY_TYPES[words[1]]))
            elif words[0] == "end_header":
                break
        if fmt != "binary_little_endian":
            raise ValueError(f"{path}: PLY format {fmt}, not "
                             "binary_little_endian")
        if [p for p, _ in props[:3]] != ["x", "y", "z"]:
            raise ValueError(f"{path}: the first properties are not x, y, z")
        v = np.frombuffer(f.read(), dtype=props, count=n)
    return np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
