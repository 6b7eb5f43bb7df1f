"""Calibration file readers — format parity with fileIoUtils.h:44-175.

Formats:
* Strecha / PMVS / DTU per-view ``.P`` / ``.txt`` files: 3x4 projection
  matrix, optionally preceded by a "CONTOUR" line (readPFileStrechaPmvs,
  fileIoUtils.h:83-110).
* Middlebury ``*_par.txt``: first line = count, then per line
  "name k11..k33 r11..r33 t1 t2 t3"; P = K [R|t]
  (readKRtFileMiddlebury, fileIoUtils.h:111-152).
* KITTI calib: first two lines contain P0/P1 after a colon
  (readCalibFileKitti, fileIoUtils.h:44-55).
* Bundler ``bundle.rd.out`` 3D points for depth-range inference
  (main.cpp:46-115).

A numpy copy of ``gipuma_tpu/io/calib.py:24-166``; the port keeps its own.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np


def _floats(line: str) -> list[float]:
    return [float(t) for t in line.replace(",", " ").split()]


def read_P_file(path: str | os.PathLike) -> np.ndarray:
    """Read a 3x4 projection matrix, skipping CONTOUR lines."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or "CONTOUR" in line:
                continue
            vals = _floats(line)
            if vals:
                rows.extend(vals)
            if len(rows) >= 12:
                break
    if len(rows) < 12:
        raise ValueError(f"{path}: expected 12 values for a 3x4 P, got {len(rows)}")
    return np.array(rows[:12], dtype=np.float64).reshape(3, 4)


def read_krt_file_middlebury(path: str | os.PathLike,
                             image_names: list[str]) -> list[np.ndarray]:
    """Middlebury *_par.txt -> P matrices ordered like image_names."""
    by_name: dict[str, np.ndarray] = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    for line in lines[1:]:  # first line is the camera count
        parts = line.split()
        if len(parts) < 22:
            continue
        name = parts[0]
        vals = [float(v) for v in parts[1:22]]
        K = np.array(vals[0:9]).reshape(3, 3)
        R = np.array(vals[9:18]).reshape(3, 3)
        t = np.array(vals[18:21])
        by_name[name] = K @ np.hstack([R, t[:, None]])
    Ps = []
    for name in image_names:
        if name not in by_name:
            raise KeyError(f"{path}: no calibration for image {name!r}")
        Ps.append(by_name[name])
    return Ps


def read_calib_file_kitti(path: str | os.PathLike) -> tuple[np.ndarray, np.ndarray]:
    """KITTI-style calib: first two lines hold P0 and P1."""
    Ps = []
    with open(path) as f:
        for line in f:
            if ":" in line:
                line = line.split(":", 1)[1]
            vals = _floats(line)
            if len(vals) >= 12:
                Ps.append(np.array(vals[:12]).reshape(3, 4))
            if len(Ps) == 2:
                break
    if len(Ps) != 2:
        raise ValueError(f"{path}: expected two projection matrices")
    return Ps[0], Ps[1]


def read_calib_file_daisy(path: str | os.PathLike) -> np.ndarray:
    """DAISY calibration: the projection matrix is on the line starting with
    'p' (readCalibFileDaisy, fileIoUtils.h:154-165)."""
    with open(path) as f:
        for line in f:
            if line.strip().startswith("p"):
                vals = _floats(line.split(":", 1)[-1] if ":" in line
                               else line.lstrip("p "))
                if len(vals) >= 12:
                    return np.array(vals[:12]).reshape(3, 4)
    raise ValueError(f"{path}: no projection line found")


def read_camera_file_strecha(path: str | os.PathLike) -> float:
    """First value of a Strecha camera file = focal length
    (readCameraFileStrecha, fileIoUtils.h:73-82)."""
    with open(path) as f:
        return float(f.readline().split()[0])


def read_bounding_volume(path: str | os.PathLike) -> tuple[np.ndarray, np.ndarray]:
    """Two corner points, one per line (fileIoUtils.h:57-70)."""
    with open(path) as f:
        p1 = np.array(_floats(f.readline())[:3])
        p2 = np.array(_floats(f.readline())[:3])
    return p1, p2


def bundler_depth_range(path: str | os.PathLike,
                        camera_center: np.ndarray) -> tuple[float, float]:
    """Depth range from bundler bundle.rd.out 3D points.

    Mirrors from_bundler_get_range (main.cpp:46-115): range =
    [min_dist * 0.6, max_dist * 1.2] over point-to-camera distances.
    """
    with open(path) as f:
        header = f.readline()
        if header.startswith("#"):
            counts = f.readline()
        else:
            counts = header
        num_cams, num_points = (int(v) for v in counts.split()[:2])
        # Skip camera blocks: 5 lines each (f k1 k2 / R x3 / t).
        for _ in range(num_cams * 5):
            f.readline()
        dmin, dmax = np.inf, -np.inf
        for _ in range(num_points):
            pos_line = f.readline()
            if not pos_line:
                break
            X = np.array(_floats(pos_line)[:3])
            f.readline()  # color
            f.readline()  # view list
            dist = float(np.linalg.norm(X - camera_center))
            dmin = min(dmin, dist)
            dmax = max(dmax, dist)
    return dmin * 0.6, dmax * 1.2


def load_projection_matrices(img_names: list[str],
                             p_folder: str | None = None,
                             krt_file: str | None = None,
                             calib_file: str | None = None,
                             pmvs_folder: str | None = None) -> list[np.ndarray]:
    """Dispatch on calibration source, mirroring getCameraParameters's input
    selection (cameraGeometryUtils.h:186-236)."""
    if pmvs_folder:
        # PMVS layout: txt/<name-without-ext>.txt
        Ps = []
        for name in img_names:
            stem = Path(name).stem
            Ps.append(read_P_file(Path(pmvs_folder) / "txt" / f"{stem}.txt"))
        return Ps
    if p_folder:
        return [read_P_file(Path(p_folder) / f"{name}.P") for name in img_names]
    if krt_file:
        return read_krt_file_middlebury(krt_file, img_names)
    if calib_file:
        return list(read_calib_file_kitti(calib_file))
    raise ValueError("no calibration source given")
