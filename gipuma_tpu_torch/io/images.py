"""Image loading — the reference's cv::imread grayscale/color float path
(main.cpp:741-751): grayscale CV_32F (0..255) or float RGB.

Counterpart of ``gipuma_tpu/io/images.py:12-122``.  The JAX package opens
every image with PIL; the port decodes the formats of the datasets' images
itself, so it runs where PIL is not installed:

* PNG at 8 bits (gray, gray+alpha, RGB, RGBA; no interlace, no palette),
  every filter type, by the package's own decoder (``_read_png_raw``);
* binary PGM (P5) and PPM (P6) with maxval 255.

Grayscale conversion is PIL's ``convert("L")`` bit for bit: on 8-bit data
L = (R*19595 + G*38470 + B*7471 + 0x8000) >> 16, alpha dropped.  Any other
file is opened with PIL when PIL imports; without PIL it raises ValueError.
``load_image_raw`` (the ground-truth reader) also decodes 16-bit PNG and
16-bit P5 / P6 (maxval 65535) itself.
"""
from __future__ import annotations

import os
import re
import struct
import zlib
from pathlib import Path

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_NATIVE = ("8-bit PNG (gray, gray+alpha, RGB, RGBA; not interlaced), "
           "binary PGM (P5) and PPM (P6) with maxval 255")
_NATIVE_RAW = ("PNG at 8 or 16 bits (gray, gray+alpha, RGB, RGBA; not "
               "interlaced), binary PGM (P5) and PPM (P6) with maxval 255 "
               "or 65535")


def _pil_open(path: str, formats: str):
    """PIL's Image.open(path); without PIL, ValueError naming the file's
    format and the formats the port reads itself."""
    try:
        from PIL import Image
    except ImportError:
        with open(path, "rb") as fh:
            magic = fh.read(8)
        raise ValueError(
            f"{path}: cannot decode this image without PIL (suffix "
            f"{Path(path).suffix or 'none'!r}, first bytes {magic!r}); "
            f"read without PIL: {formats}") from None
    return Image.open(path)


def _luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's convert("L") of 8-bit RGB [..., 3] -> uint8 (ITU-R 601-2 luma
    in 16-bit fixed point, rounded)."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters -> uint8 [h, stride].

    Pixel (y, x) depends on its left (a), upper (b) and upper-left (c)
    neighbours, already decoded; every filter type is a function of those
    and the filtered byte.  So the pixels of one anti-diagonal t = y + x
    decode together: the loop runs over the h + w - 1 diagonals, each a
    few numpy operations on its pixels' byte lanes, instead of over every
    byte.  ``S[t + 2, y + 1]`` holds pixel (y, t - y); the zero row and the
    two zero diagonals in front are the out-of-image neighbours."""
    npx = stride // bpp
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(
        h, stride + 1)
    ft = rows[:, 0].astype(np.intp)
    if ft.size and ft.max() > 4:
        bad = int(np.argmax(ft > 4))
        raise ValueError(f"PNG filter type {ft[bad]} in row {bad}")
    F = rows[:, 1:].reshape(h, npx, bpp).astype(np.int16)
    S = np.zeros((h + npx + 1, h + 1, bpp), np.int16)
    ys_all = np.arange(h)
    zero = np.zeros((1, bpp), np.int16)
    for t in range(h + npx - 1):
        y0, y1 = max(0, t - npx + 1), min(h - 1, t) + 1
        ys = ys_all[y0:y1]
        a = S[t + 1, y0 + 1:y1 + 1]
        b = S[t + 1, y0:y1]
        c = S[t, y0:y1]
        pa = np.abs(b - c)
        pb = np.abs(a - c)
        pc = np.abs(a + b - c - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(ft[y0:y1, None], (zero, a, b, (a + b) >> 1, paeth))
        S[t + 2, y0 + 1:y1 + 1] = (F[ys, t - ys] + pred) & 0xFF
    yy, xx = np.meshgrid(np.arange(h), np.arange(npx), indexing="ij")
    return S[yy + xx + 2, yy + 1].astype(np.uint8).reshape(h, stride)


def _read_png_raw(path: str) -> np.ndarray:
    """The package's PNG decoder, preserving bit depth (PIL collapses
    16-bit RGB to 8-bit): gray/RGB/gray+alpha/RGBA at 8 or 16 bits, no
    interlace.  Returns uint8/uint16 [H,W] or [H,W,C]; ValueError for
    anything else (palette, interlace, other depths)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG")
    pos, idat = 8, []
    w = h = depth = ctype = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", body)
            if interlace:
                raise ValueError("interlaced PNG unsupported")
        elif ctag == b"IDAT":
            idat.append(body)
        elif ctag == b"IEND":
            break
    if ctype not in (0, 2, 4, 6):
        raise ValueError(f"PNG color type {ctype} unsupported")
    nch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    if depth not in (8, 16):
        raise ValueError(f"bit depth {depth} unsupported")
    bpp = nch * depth // 8                       # bytes per pixel
    stride = w * bpp
    out = _unfilter(zlib.decompress(b"".join(idat)), h, stride, bpp)
    if depth == 16:
        arr = out.reshape(h, w, nch, 2).astype(np.uint16)
        arr = (arr[..., 0] << 8) | arr[..., 1]   # PNG is big-endian
    else:
        arr = out.reshape(h, w, nch)
    return arr[..., 0] if nch == 1 else arr


def _read_pnm(path: str) -> np.ndarray:
    """Binary PGM (P5) / PPM (P6) -> uint8 or uint16 [H,W] / [H,W,3] with
    the stored values (maxval 255 or 65535; ValueError otherwise)."""
    with open(path, "rb") as fh:
        data = fh.read()
    m = re.match(rb"(P[56])(?:\s+|#[^\n]*\n)+(\d+)(?:\s+|#[^\n]*\n)+(\d+)"
                 rb"(?:\s+|#[^\n]*\n)+(\d+)\s", data)
    if not m:
        raise ValueError("not a binary PGM / PPM")
    w, h, maxval = (int(m.group(i)) for i in (2, 3, 4))
    if maxval not in (255, 65535):
        raise ValueError(f"PNM maxval {maxval} unsupported")
    nch = 3 if m.group(1) == b"P6" else 1
    dtype = np.uint8 if maxval == 255 else np.dtype(">u2")
    img = np.frombuffer(data, dtype, w * h * nch, m.end())
    img = img.reshape((h, w, nch) if nch == 3 else (h, w))
    return img.astype(np.uint16) if maxval == 65535 else img


def _read_native(path: str) -> np.ndarray | None:
    """Decode by the file's magic bytes: PNG or P5 / P6, else None."""
    with open(path, "rb") as fh:
        magic = fh.read(8)
    if magic == _PNG_SIG:
        return _read_png_raw(path)
    if magic[:2] in (b"P5", b"P6"):
        return _read_pnm(path)
    return None


def load_image(path: str | os.PathLike, color: bool = False) -> np.ndarray:
    """Load as float32; grayscale [H,W] (luma, 0..255) or color [H,W,3]."""
    p = str(path)
    try:
        arr = _read_native(p)
    except ValueError:
        arr = None
    if arr is None or arr.dtype != np.uint8:
        img = _pil_open(p, _NATIVE)
        return np.asarray(img.convert("RGB" if color else "L"),
                          dtype=np.float32)
    if arr.ndim == 2:                       # gray
        rgb, gray = None, arr
    elif arr.shape[2] == 2:                 # gray + alpha
        rgb, gray = None, arr[..., 0]
    else:                                   # RGB / RGBA
        rgb = arr[..., :3]
        gray = None if color else _luma(rgb)
    if color:
        if rgb is None:
            rgb = np.repeat(gray[..., None], 3, axis=-1)
        return rgb.astype(np.float32)
    return gray.astype(np.float32)


def load_image_raw(path: str | os.PathLike) -> np.ndarray:
    """cv::imread(path, -1) analog (main.cpp:770-772,786,800): decode
    preserving bit depth and channel count, as float32 — the reference
    accepts ANY image as ground truth and converts to CV_32F."""
    p = str(path)
    try:
        arr = _read_native(p)
    except ValueError:
        arr = None
    if arr is None:
        arr = np.asarray(_pil_open(p, _NATIVE_RAW))
    return arr.astype(np.float32)


def decode_normal_map_16u(arr: np.ndarray) -> np.ndarray:
    """16-bit GT normal-map decode (main.cpp:800-817): channels store
    n*32767 + 32767; all-32767 pixels (encoded zero) stay (0,0,0), others
    are normalized.  arr: [H,W,3] float of uint16 values -> [H,W,3] unit
    normals.  (The reference's BGR2RGB swap undoes imread's BGR order —
    our decoder reads the PNG's native RGB, so no swap.)"""
    n = np.asarray(arr, np.float32) - 32767.0
    zero = np.all(n == 0.0, axis=-1)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    out = n / np.maximum(norm, 1e-12)
    out[zero] = 0.0
    return out


def list_images(folder: str | os.PathLike,
                extensions=(".png", ".jpg", ".jpeg", ".ppm", ".pgm", ".tif",
                            ".tiff", ".bmp")) -> list[str]:
    """Sorted image filenames in a folder."""
    return [p.name for p in sorted(Path(folder).iterdir())
            if p.suffix.lower() in extensions]
