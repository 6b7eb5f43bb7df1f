"""gipuma_tpu_torch's native IO library (io/native.py, built with g++ from
gipuma_tpu_torch/native/gipuma_io.cpp) against the JAX package's native
writer and the port's numpy writer:

* .ply (write_ply_points, write_ply) and .dmb ([H, W] and [H, W, 3])
  bytes from the port's native writer equal the JAX package's native
  writer's and the port's numpy writer's;
* the native .dmb reader round-trips both shapes;
* where the library cannot be built, available() is false and the same
  bytes come from the numpy path."""
import numpy as np
import pytest

from gipuma_tpu.io import native as jnative

from gipuma_tpu_torch.io import dmb as tdmb
from gipuma_tpu_torch.io import native as tnative
from gipuma_tpu_torch.io import ply as tply


@pytest.fixture
def data():
    rng = np.random.default_rng(17)
    n = 1000
    return dict(
        pts=rng.normal(size=(n, 3)).astype(np.float32),
        nrm=rng.normal(size=(n, 3)).astype(np.float32),
        col=rng.uniform(-20, 280, size=(n, 3)),
        gray=rng.uniform(0, 255, size=n),
        depth=np.where(rng.uniform(size=(24, 32)) < 0.1, 0.0,
                       rng.uniform(3, 8, size=(24, 32))).astype(np.float32),
        normals=rng.normal(size=(24, 32, 3)).astype(np.float32))


@pytest.fixture
def no_library(monkeypatch, tmp_path):
    """The port's library as if g++ were missing: a fresh build directory
    and a compiler that does not exist."""
    monkeypatch.setattr(tnative, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "CXX", "no-such-compiler")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_lib_tried", False)
    yield
    monkeypatch.undo()
    tnative._lib, tnative._lib_tried = None, False


def _numpy_bytes(path_fn, monkeypatch, tmp_path, name):
    """Bytes written by `path_fn(path)` with the native writers off."""
    with monkeypatch.context() as m:
        m.setattr(tnative, "_lib", None)
        m.setattr(tnative, "_lib_tried", True)
        p = tmp_path / f"numpy_{name}"
        path_fn(p)
    return p.read_bytes()


def test_library_builds():
    assert tnative.available()
    assert jnative.available()


@pytest.mark.parametrize("colors", ["rgb", "gray"])
def test_ply_points_bytes(data, tmp_path, monkeypatch, colors):
    col = data["col"] if colors == "rgb" else data["gray"]
    p = tmp_path / "t.ply"
    n = tnative.write_ply_native(p, data["pts"], data["nrm"], col)
    assert n == len(data["pts"])
    jnative.write_ply_native(tmp_path / "j.ply", data["pts"], data["nrm"], col)
    assert p.read_bytes() == (tmp_path / "j.ply").read_bytes()
    # write_ply_points takes the native path; the numpy writer gives the
    # same bytes.
    assert tply.write_ply_points(tmp_path / "w.ply", data["pts"],
                                 data["nrm"], col) == n
    assert (tmp_path / "w.ply").read_bytes() == p.read_bytes()
    want = _numpy_bytes(lambda q: tply.write_ply_points(
        q, data["pts"], data["nrm"], col), monkeypatch, tmp_path, "pts.ply")
    assert want == p.read_bytes()
    pts, nrm, c = tply.read_ply(p)
    np.testing.assert_array_equal(pts, data["pts"])
    np.testing.assert_array_equal(nrm, data["nrm"])


def test_write_ply_depth_map_bytes(data, tmp_path, monkeypatch):
    from gipuma_tpu_torch.utils.synthetic import make_ring_P
    P = make_ring_P(2, 24, 32, 40.0)[0]
    img = np.arange(24 * 32, dtype=np.float64).reshape(24, 32) % 256
    n = tply.write_ply(tmp_path / "d.ply", data["depth"], data["normals"],
                       img, P)
    assert n == int((data["depth"] > 0).sum())
    want = _numpy_bytes(lambda q: tply.write_ply(
        q, data["depth"], data["normals"], img, P), monkeypatch, tmp_path,
        "d.ply")
    assert (tmp_path / "d.ply").read_bytes() == want


@pytest.mark.parametrize("key", ["depth", "normals"])
def test_dmb_bytes_and_roundtrip(data, tmp_path, monkeypatch, key):
    a = data[key]
    tdmb.write_dmb(tmp_path / "t.dmb", a)
    assert jnative.write_dmb_native(tmp_path / "j.dmb", a)
    assert (tmp_path / "t.dmb").read_bytes() == \
        (tmp_path / "j.dmb").read_bytes()
    want = _numpy_bytes(lambda q: tdmb.write_dmb(q, a), monkeypatch,
                        tmp_path, f"{key}.dmb")
    assert (tmp_path / "t.dmb").read_bytes() == want
    back = tnative.read_dmb_native(tmp_path / "t.dmb")
    assert back.shape == a.shape and back.dtype == np.float32
    np.testing.assert_array_equal(back, a)
    np.testing.assert_array_equal(tdmb.read_dmb(tmp_path / "t.dmb"), a)


def test_fallback_without_library(data, tmp_path, no_library):
    assert not tnative.available()
    assert tnative.write_ply_native(tmp_path / "x.ply", data["pts"],
                                    data["nrm"], data["col"]) is None
    assert tnative.write_dmb_native(tmp_path / "x.dmb", data["depth"]) is False
    assert tnative.read_dmb_native(tmp_path / "x.dmb") is None
    tdmb.write_dmb(tmp_path / "f.dmb", data["normals"])
    jnative.write_dmb_native(tmp_path / "j.dmb", data["normals"])
    assert (tmp_path / "f.dmb").read_bytes() == \
        (tmp_path / "j.dmb").read_bytes()
    np.testing.assert_array_equal(tdmb.read_dmb(tmp_path / "f.dmb"),
                                  data["normals"])
    assert tply.write_ply_points(tmp_path / "f.ply", data["pts"],
                                 data["nrm"], data["col"]) == len(data["pts"])
    jnative.write_ply_native(tmp_path / "j.ply", data["pts"], data["nrm"],
                             data["col"])
    assert (tmp_path / "f.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").glob("*.so"))
