"""gipuma_tpu_torch io and eval modules against the JAX package, on the
same files and arrays (numpy in, numpy out):

* .pfm (gray, colour) and binary .pgm (8, 16 bit): bitwise;
* every calibration reader (P / CONTOUR, Middlebury krt, KITTI, DAISY,
  Strecha, bounding volume, bundler range) and load_projection_matrices'
  dispatch: bitwise;
* load_image on 8-bit gray, gray+alpha, RGB and RGBA PNGs (rows of every
  filter type, and Pillow's own encoding) and on P5 / P6: bitwise against
  the JAX loader (PIL); the grayscale conversion is PIL's convert("L");
* load_image_raw on 8- and 16-bit PNGs with filtered rows: bitwise;
* decode_normal_map_16u and list_images: bitwise;
* write_ply_points read back by the JAX read_ply: arrays equal; write_ply
  writes the JAX writer's bytes;
* without PIL, a format the port does not decode raises ValueError (a
  subprocess with PIL hidden), while PNG still loads;
* depth_error, normal_error, accuracy_completeness: within 1e-6 relative,
  with occlusion and valid masks."""
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from gipuma_tpu.eval import metrics as jm
from gipuma_tpu.io import calib as jcal
from gipuma_tpu.io import images as jimg
from gipuma_tpu.io import pfm as jpfm
from gipuma_tpu.io import ply as jply

from gipuma_tpu_torch.eval import metrics as tm
from gipuma_tpu_torch.io import calib as tcal
from gipuma_tpu_torch.io import images as timg
from gipuma_tpu_torch.io import pfm as tpfm
from gipuma_tpu_torch.io import ply as tply

REPO = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


def test_port_imports_no_jax():
    """The port never imports JAX or the JAX package (fresh interpreter)."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import gipuma_tpu_torch as g; print(g.foreign_modules())"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, filters, depth: int = 8) -> bytes:
    """A PNG whose row y is filtered with filters[y % len(filters)] (0-4),
    the filters written out from the PNG specification."""
    h, w = img.shape[:2]
    nch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[nch]
    if depth == 16:
        b = img.astype(">u2").view(np.uint8).reshape(h, w * nch * 2)
    else:
        b = img.astype(np.uint8).reshape(h, w * nch)
    bpp = nch * depth // 8
    rows, prev = [], np.zeros(b.shape[1], np.int32)
    for y in range(h):
        f = filters[y % len(filters)]
        cur = b[y].astype(np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
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
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + _chunk(b"IEND", b""))


def _image(rng, h, w, nch, depth=8):
    """A smooth gradient plus noise (so every filter has work to do)."""
    hi = 255 if depth == 8 else 65535
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 7 + yy * 3) * (hi // 255)
    shape = (h, w) if nch == 1 else (h, w, nch)
    noise = rng.integers(0, hi // 8, shape)
    return np.clip((base if nch == 1 else base[..., None]) + noise, 0, hi)


def test_pfm_pgm_bitwise(tmp_path):
    rng = np.random.default_rng(1)
    for shape in ((7, 9), (7, 9, 3)):
        a = rng.standard_normal(shape).astype(np.float32)
        jpfm.write_pfm(tmp_path / "a.pfm", a)
        tpfm.write_pfm(tmp_path / "b.pfm", a)
        assert ((tmp_path / "a.pfm").read_bytes()
                == (tmp_path / "b.pfm").read_bytes())
        np.testing.assert_array_equal(tpfm.read_pfm(tmp_path / "a.pfm"),
                                      jpfm.read_pfm(tmp_path / "a.pfm"))
    # Big-endian PFM (positive scale), bottom-up rows.
    b = rng.standard_normal((5, 6)).astype(np.float32)
    (tmp_path / "be.pfm").write_bytes(
        b"Pf\n6 5\n1.0\n" + np.flipud(b).astype(">f4").tobytes())
    np.testing.assert_array_equal(tpfm.read_pfm(tmp_path / "be.pfm"), b)
    for maxval, dt in ((255, np.uint8), (65535, ">u2")):
        g = rng.integers(0, maxval + 1, (6, 8)).astype(dt)
        (tmp_path / "g.pgm").write_bytes(
            b"P5\n# a comment\n8 6\n" + str(maxval).encode() + b"\n"
            + g.tobytes())
        got = tpfm.read_pgm(tmp_path / "g.pgm")
        np.testing.assert_array_equal(got, jpfm.read_pgm(tmp_path / "g.pgm"))
        assert got.dtype == np.float32


def test_calibration_readers_bitwise(tmp_path):
    rng = np.random.default_rng(2)
    Ps = [rng.standard_normal((3, 4)) for _ in range(3)]
    names = ["a.png", "b.png", "c.png"]
    pdir = tmp_path / "p"
    pdir.mkdir()
    for n, P in zip(names, Ps):
        (pdir / f"{n}.P").write_text(
            "CONTOUR\n" + "\n".join(" ".join(f"{v:.17g}" for v in r)
                                    for r in P))
    krt = tmp_path / "par.txt"
    lines = [str(len(names))]
    for n in names:
        K = np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]])
        R = np.linalg.qr(rng.standard_normal((3, 3)))[0]
        t = rng.standard_normal(3)
        lines.append(" ".join([n] + [f"{v:.17g}" for v in
                                     np.concatenate([K.ravel(), R.ravel(),
                                                     t])]))
    krt.write_text("\n".join(lines) + "\n")
    kitti = tmp_path / "calib.txt"
    kitti.write_text("\n".join(
        f"P{i}: " + " ".join(f"{v:.17g}" for v in Ps[i].ravel())
        for i in range(2)) + "\n")
    daisy = tmp_path / "daisy.txt"
    daisy.write_text("k 1 2 3\np: " + ", ".join(
        f"{v:.17g}" for v in Ps[2].ravel()) + "\n")
    strecha = tmp_path / "cam.txt"
    strecha.write_text("2759.48 0 1520.69\n0 2764.16 1006.81\n")
    vol = tmp_path / "vol.txt"
    vol.write_text("-1.5 2 3.25\n4, 5.5, -6\n")
    bundle = tmp_path / "pmvs"
    bundle.mkdir()
    (bundle / "txt").mkdir()
    for n, P in zip(names, Ps):
        (bundle / "txt" / f"{Path(n).stem}.txt").write_text(
            "CONTOUR\n" + "\n".join(" ".join(f"{v:.17g}" for v in r)
                                    for r in P))
    pts = rng.standard_normal((4, 3)) + [0, 0, 5]
    cams = ["1 0 0", "1 0 0", "0 1 0", "0 0 1", "0 0 0"] * 2
    body = ["# Bundle file v0.3", "2 4"] + cams
    for X in pts:
        body += [" ".join(f"{v:.17g}" for v in X), "255 255 255", "0"]
    (bundle / "bundle.rd.out").write_text("\n".join(body) + "\n")

    for n in names:
        np.testing.assert_array_equal(tcal.read_P_file(pdir / f"{n}.P"),
                                      jcal.read_P_file(pdir / f"{n}.P"))
    for kw in (dict(p_folder=str(pdir)), dict(krt_file=str(krt)),
               dict(calib_file=str(kitti)), dict(pmvs_folder=str(bundle))):
        got = tcal.load_projection_matrices(names, **kw)
        want = jcal.load_projection_matrices(names, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tcal.read_calib_file_daisy(daisy),
                                  jcal.read_calib_file_daisy(daisy))
    assert (tcal.read_camera_file_strecha(strecha)
            == jcal.read_camera_file_strecha(strecha))
    for g, w in zip(tcal.read_bounding_volume(vol),
                    jcal.read_bounding_volume(vol)):
        np.testing.assert_array_equal(g, w)
    C = np.array([0.1, -0.2, 0.3])
    assert (tcal.bundler_depth_range(bundle / "bundle.rd.out", C)
            == jcal.bundler_depth_range(bundle / "bundle.rd.out", C))
    with pytest.raises(KeyError):
        tcal.read_krt_file_middlebury(krt, ["missing.png"])
    with pytest.raises(ValueError):
        tcal.load_projection_matrices(names)


# (channels, filters): every filter type, alone and mixed.
PNG_CASES = [(nch, filt) for nch in (1, 2, 3, 4)
             for filt in ((0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4, 4, 3))]


@pytest.mark.parametrize("nch,filt", PNG_CASES)
def test_load_image_png_bitwise(tmp_path, nch, filt):
    rng = np.random.default_rng(nch * 10 + len(filt) + filt[0])
    img = _image(rng, 13, 17, nch)
    f = tmp_path / "im.png"
    f.write_bytes(encode_png(img, filt))
    for color in (False, True):
        got = timg.load_image(f, color=color)
        want = jimg.load_image(f, color=color)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(timg.load_image_raw(f),
                                  jimg.load_image_raw(f))
    np.testing.assert_array_equal(timg._read_png_raw(str(f)), img)


def test_load_image_pillow_png_and_pnm(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(3)
    for mode, nch, ext in (("L", 1, ".pgm"), ("RGB", 3, ".ppm"),
                           ("RGBA", 4, None), ("LA", 2, None)):
        img = _image(rng, 21, 30, nch).astype(np.uint8)
        im = Image.fromarray(img, mode)
        files = [tmp_path / f"{mode}.png"]
        im.save(files[0])
        if ext:
            files.append(tmp_path / f"{mode}{ext}")
            im.save(files[1])
        for f in files:
            for color in (False, True):
                np.testing.assert_array_equal(timg.load_image(f, color),
                                              jimg.load_image(f, color))
            np.testing.assert_array_equal(timg.load_image_raw(f),
                                          jimg.load_image_raw(f))


@pytest.mark.parametrize("nch", [1, 3])
def test_load_image_raw_16bit_bitwise(tmp_path, nch):
    rng = np.random.default_rng(4 + nch)
    img = _image(rng, 11, 15, nch, depth=16)
    f = tmp_path / "im16.png"
    f.write_bytes(encode_png(img, (0, 1, 2, 3, 4), depth=16))
    got = timg.load_image_raw(f)
    np.testing.assert_array_equal(got, jimg.load_image_raw(f))
    np.testing.assert_array_equal(got, img.astype(np.float32))
    # decode_normal_map_16u on the decoded 16-bit channels.
    if nch == 3:
        raw = got.copy()
        raw[0, 0] = 32767.0                      # an encoded zero normal
        np.testing.assert_array_equal(timg.decode_normal_map_16u(raw),
                                      jimg.decode_normal_map_16u(raw))


def test_list_images(tmp_path):
    for n in ("b.png", "a.JPG", "c.txt", "d.pgm", "e.tiff", "f.P"):
        (tmp_path / n).write_bytes(b"")
    assert timg.list_images(tmp_path) == jimg.list_images(tmp_path)
    assert timg.list_images(tmp_path) == ["a.JPG", "b.png", "d.pgm",
                                          "e.tiff"]


def test_without_pil_unsupported_format_raises(tmp_path):
    """PIL hidden in a fresh interpreter: PNG still decodes, a BMP raises
    ValueError naming the formats read without PIL."""
    png = tmp_path / "ok.png"
    png.write_bytes(encode_png(np.arange(12, dtype=np.uint8).reshape(3, 4),
                               (4,)))
    bmp = tmp_path / "x.bmp"
    bmp.write_bytes(b"BM" + bytes(60))
    code = f"""
import sys
sys.modules["PIL"] = None
from gipuma_tpu_torch.io.images import load_image, load_image_raw
assert load_image({str(png)!r}).tolist() == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
for fn in (load_image, load_image_raw):
    try:
        fn({str(bmp)!r})
    except ValueError as e:
        assert "without PIL" in str(e) and "PNG" in str(e), e
    else:
        raise SystemExit("no error for an unsupported format")
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("binary", [True, False])
def test_write_ply_points_reads_back_through_jax(tmp_path, binary):
    rng = np.random.default_rng(5)
    pts = rng.standard_normal((50, 3)).astype(np.float32)
    nrm = rng.standard_normal((50, 3)).astype(np.float32)
    col = rng.uniform(-10, 300, (50, 3))
    f = tmp_path / "c.ply"
    assert tply.write_ply_points(f, pts, nrm, col, binary=binary) == 50
    jp, jn, jc = jply.read_ply(f)
    tp, tn, tc = tply.read_ply(f)
    for a, b in ((jp, tp), (jn, tn), (jc, tc)):
        np.testing.assert_array_equal(a, b)
    if binary:
        np.testing.assert_array_equal(jp, pts)
        np.testing.assert_array_equal(jc, np.clip(col, 0, 255).astype(
            np.uint8))


@pytest.mark.parametrize("binary", [True, False])
def test_write_ply_bytes_match_jax(tmp_path, binary):
    """write_ply (a depth map's cloud, now through write_ply_points) writes
    the JAX writer's bytes, invalid pixels and grey colours included."""
    rng = np.random.default_rng(8)
    d = rng.uniform(1, 5, (6, 7))
    d[0, 0], d[1, 1] = 0.0, np.nan
    n = rng.standard_normal((6, 7, 3))
    P = rng.standard_normal((3, 4))
    for col in (rng.uniform(-5, 300, (6, 7)), rng.uniform(0, 255, (6, 7, 3))):
        assert (tply.write_ply(tmp_path / "t.ply", d, n, col, P, binary)
                == jply.write_ply(tmp_path / "j.ply", d, n, col, P, binary))
        assert ((tmp_path / "t.ply").read_bytes()
                == (tmp_path / "j.ply").read_bytes())


def _close(a, b):
    if isinstance(a, float):
        assert (np.isnan(a) and np.isnan(b)) or np.isclose(
            a, b, rtol=1e-6, atol=0), (a, b)
    elif a is None:
        assert b is None
    else:
        np.testing.assert_allclose(a, b, rtol=1e-6)


@pytest.mark.parametrize("masks", [False, True])
def test_depth_and_normal_error_match_jax(masks):
    rng = np.random.default_rng(6)
    gt = rng.uniform(1, 10, (20, 24))
    gt[rng.uniform(size=gt.shape) < 0.1] = 0.0
    gt[0, 0] = np.nan
    depth = gt + rng.normal(0, 1.0, gt.shape)
    depth[rng.uniform(size=gt.shape) < 0.05] = np.inf
    occl = rng.uniform(size=gt.shape) < 0.2 if masks else None
    valid = rng.uniform(size=gt.shape) < 0.8 if masks else None
    kw = dict(tol=1.0, tol2=1.5, occlusion_mask=occl, valid=valid)
    a, b = tm.depth_error(depth, gt, **kw), jm.depth_error(depth, gt, **kw)
    for f in a.__dataclass_fields__:
        _close(getattr(a, f), getattr(b, f))
    n = rng.standard_normal((20, 24, 3))
    g = rng.standard_normal((20, 24, 3))
    g[3, 4] = 0.0
    m = rng.uniform(size=(20, 24)) < 0.7 if masks else None
    a, b = tm.normal_error(n, g, mask=m), jm.normal_error(n, g, mask=m)
    for f in a.__dataclass_fields__:
        _close(getattr(a, f), getattr(b, f))


def test_accuracy_completeness_matches_jax():
    pytest.importorskip("scipy")
    rng = np.random.default_rng(7)
    P = rng.standard_normal((3000, 3))
    G = P[:2000] + 0.01 * rng.standard_normal((2000, 3))
    for kw in (dict(), dict(max_dist=0.02, sample=500, seed=3)):
        assert tm.accuracy_completeness(P, G, **kw) == pytest.approx(
            jm.accuracy_completeness(P, G, **kw), rel=1e-6)
