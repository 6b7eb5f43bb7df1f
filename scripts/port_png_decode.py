#!/usr/bin/env python3
"""Decode time of the port's PNG loader (gipuma_tpu_torch.io.images) on
this machine's CPU, at DTU's image size (1600x1200 RGB, 8 bits).

    python3 scripts/port_png_decode.py [--repeats N]

Writes one PNG per row-filter choice (None, Sub, Up, Average, Paeth, all
five in turn, and Pillow's own encoding where PIL imports), each from
the same seeded gradient-plus-noise image, into a temporary folder;
decodes each with load_image(color=True) and load_image(color=False)
`--repeats` times, checks the colour decode against the image, and
prints one JSON line per file with the median seconds and the CPU count.
Needs no GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import struct
import sys
import tempfile
import time
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gipuma_tpu_torch.io.images import load_image  # noqa: E402

H, W = 1200, 1600


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, filters) -> bytes:
    """8-bit RGB PNG with row y filtered by filters[y % len(filters)]."""
    h, w, nch = img.shape
    b = img.astype(np.uint8).reshape(h, w * nch)
    rows, prev = [], np.zeros(b.shape[1], np.int32)
    for y in range(h):
        f = filters[y % len(filters)]
        cur = b[y].astype(np.int32)
        a = np.concatenate([np.zeros(nch, np.int32), cur[:-nch]])
        c = np.concatenate([np.zeros(nch, np.int32), prev[:-nch]])
        if f == 0:
            pr = 0
        elif f == 1:
            pr = a
        elif f == 2:
            pr = prev
        elif f == 3:
            pr = (a + prev) // 2
        else:
            p = a + prev - c
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
            pr = np.where((pa <= pb) & (pa <= pc), a,
                          np.where(pb <= pc, prev, c))
        rows.append(bytes([f]) + ((cur - pr) & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + _chunk(b"IEND", b""))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.clip(np.stack([(xx + 2 * yy) % 256, (3 * xx) % 256,
                            (yy * 5) % 256], -1)
                  + rng.integers(-12, 13, (H, W, 3)), 0, 255).astype(np.uint8)
    cases = {"none": (0,), "sub": (1,), "up": (2,), "average": (3,),
             "paeth": (4,), "mixed": (0, 1, 2, 3, 4)}
    with tempfile.TemporaryDirectory() as td:
        files = {}
        for name, filt in cases.items():
            files[name] = os.path.join(td, f"{name}.png")
            with open(files[name], "wb") as f:
                f.write(encode_png(img, filt))
        try:
            from PIL import Image
            files["pillow"] = os.path.join(td, "pillow.png")
            Image.fromarray(img).save(files["pillow"])
        except ImportError:
            pass
        for name, path in files.items():
            if not np.array_equal(load_image(path, color=True), img):
                print(f"port_png_decode: {name}: decode differs from the "
                      "image", file=sys.stderr)
                return 1
            out = {}
            for color in (True, False):
                ts = []
                for _ in range(args.repeats):
                    t0 = time.perf_counter()
                    load_image(path, color=color)
                    ts.append(time.perf_counter() - t0)
                out["rgb_s" if color else "gray_s"] = statistics.median(ts)
            print(json.dumps({"metric": "png_decode", "file": name,
                              "shape": [H, W, 3],
                              "bytes": os.path.getsize(path),
                              "cpus": os.cpu_count(), **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
