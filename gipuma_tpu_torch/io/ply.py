"""PLY point-cloud output — capability of displayUtils.h:77-237
(storePlyFileBinary / storePlyFileAscii): per valid pixel, back-project the
depth to 3D and write x, y, z, nx, ny, nz, r, g, b.

The reference parallelizes its binary writer with OpenMP + critical-section
writes; here the vertex buffer is assembled vectorized in numpy and written
in one call, which is faster and deterministic.

Counterpart of ``gipuma_tpu/io/ply.py``: ``write_ply``, ``write_ply_points``
(the fused cloud; native writer or numpy) and ``read_ply``.
"""
from __future__ import annotations

import os

import numpy as np


_HEADER = """ply
format {fmt} 1.0
element vertex {n}
property float x
property float y
property float z
property float nx
property float ny
property float nz
property uchar red
property uchar green
property uchar blue
end_header
"""


def write_ply(path: str | os.PathLike, depth: np.ndarray, normals: np.ndarray,
              colors: np.ndarray, P: np.ndarray, binary: bool = True) -> int:
    """Write the depth map as a PLY cloud; returns the number of points.

    depth [H,W] (0/NaN = invalid), normals [H,W,3], colors [H,W] or [H,W,3]
    (0..255), P the 3x4 projection of the view the depth map lives in.
    Every valid (depth > 0, finite) pixel is back-projected in float64.
    """
    depth, P = np.asarray(depth), np.asarray(P)
    h, w = depth.shape
    M_inv = np.linalg.inv(P[:, :3])
    p4 = P[:, 3]
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    d = depth.astype(np.float64)
    pts = np.stack([d * xs - p4[0], d * ys - p4[1], d - p4[2]], axis=-1)
    X = pts @ M_inv.T
    valid = np.isfinite(d) & (d > 0) & np.isfinite(X).all(axis=-1)
    return write_ply_points(path, X[valid], np.asarray(normals)[valid],
                            np.asarray(colors)[valid], binary=binary)


def write_ply_points(path: str | os.PathLike, points: np.ndarray,
                     normals: np.ndarray, colors: np.ndarray,
                     binary: bool = True) -> int:
    """Write an unstructured point list [N,3] (+normals [N,3], colors [N,3]
    or [N]); returns N.  Binary writes go through the native C++ writer
    (io/native.py) when it builds, as in the JAX package (the reference
    keeps this hot path native too, displayUtils.h:77-237), and through
    numpy otherwise; the bytes are the same."""
    if binary:
        from .native import write_ply_native
        n = write_ply_native(path, np.asarray(points), np.asarray(normals),
                             np.asarray(colors))
        if n is not None:
            return n
    points = np.asarray(points)
    n = points.shape[0]
    out = np.empty(n, dtype=[
        ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
        ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
        ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    out["x"], out["y"], out["z"] = points[:, 0], points[:, 1], points[:, 2]
    nn = np.asarray(normals)
    out["nx"], out["ny"], out["nz"] = nn[:, 0], nn[:, 1], nn[:, 2]
    cc = np.clip(np.asarray(colors), 0, 255).astype(np.uint8)
    if cc.ndim == 1:
        cc = np.repeat(cc[:, None], 3, axis=1)
    out["red"], out["green"], out["blue"] = cc[:, 0], cc[:, 1], cc[:, 2]
    fmt = "binary_little_endian" if binary else "ascii"
    with open(path, "wb") as f:
        f.write(_HEADER.format(fmt=fmt, n=n).encode())
        if binary:
            f.write(out.tobytes())
        else:
            for r in out:
                f.write((" ".join(str(x) for x in r.tolist()) + "\n").encode())
    return n


def read_ply(path: str | os.PathLike):
    """Minimal PLY reader for round-trip tests (binary_little_endian/ascii,
    the 9-property layout written above)."""
    with open(path, "rb") as f:
        fmt = None
        n = 0
        while True:
            raw = f.readline()
            if not raw:
                raise ValueError(f"{path}: PLY header has no end_header")
            line = raw.decode("latin-1").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line == "end_header":
                break
        dtype = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                 ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
                 ("red", "u1"), ("green", "u1"), ("blue", "u1")]
        if fmt == "binary_little_endian":
            v = np.frombuffer(f.read(), dtype=dtype, count=n)
        else:
            rows = [tuple(t for t in f.readline().decode().split()) for _ in range(n)]
            v = np.array([(float(a), float(b), float(c), float(d), float(e),
                           float(g), int(r), int(gg), int(bb))
                          for a, b, c, d, e, g, r, gg, bb in rows], dtype=dtype)
    pts = np.stack([v["x"], v["y"], v["z"]], axis=1)
    nrm = np.stack([v["nx"], v["ny"], v["nz"]], axis=1)
    col = np.stack([v["red"], v["green"], v["blue"]], axis=1)
    return pts, nrm, col
