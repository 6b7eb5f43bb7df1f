"""The benchmark's scenes: a calibrated rig and its images, made from a seed.

A configuration file (``configs/<name>.json``) states the rig (image size,
intrinsics, camera layout) and the scene (closed objects, an optional
background plane, the surface texture).  ``make_scene`` builds every view
on the given device with a ``torch.Generator`` of the benchmark's own:
each pixel's ray is cast analytically against the objects, and the hit
point's texture is a 3-D value noise, so all views see one consistent
surface.  The same ray cast gives each view's ground truth: z-depth in the
camera frame and the world-frame surface normal.

Nothing here imports the program: the images, the projection matrices and
the ground truth are the benchmark's, handed alike to the program and to
the plain reference.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class Camera:
    """World -> camera rotation R, centre C and intrinsics K (float64)."""

    K: np.ndarray
    R: np.ndarray
    C: np.ndarray

    @property
    def P(self) -> np.ndarray:
        return self.K @ np.hstack([self.R, (-self.R @ self.C)[:, None]])


@dataclasses.dataclass
class Scene:
    cameras: list
    images: list              # [H, W] float32 numpy arrays, 0..255
    height: int
    width: int
    config: dict

    @property
    def Ps(self) -> list:
        return [c.P for c in self.cameras]


def look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """World -> camera rotation of a camera at `eye` looking at `target`
    (camera x right, y down, z forward)."""
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z])


def camera_layout(rig: dict) -> list:
    """The rig's cameras, in the folder's order.

    ``ring``: ``views`` cameras evenly spaced in azimuth on a circle at
    ``elevation_deg``, ``distance`` from the object centre (the origin),
    looking at it; world z is up.  ``cap``: a ``rows`` x ``cols`` grid of
    azimuth and elevation steps of ``step_deg`` about the +z axis on a
    sphere of radius ``distance``, looking at the origin; world y is up."""
    K = np.asarray(rig["K"], dtype=np.float64)
    dist = float(rig["distance"])
    cams = []
    if rig["layout"] == "ring":
        el = math.radians(rig["elevation_deg"])
        up = np.array([0.0, 0.0, 1.0])
        for k in range(rig["views"]):
            az = 2.0 * math.pi * k / rig["views"]
            eye = dist * np.array([math.cos(el) * math.cos(az),
                                   math.cos(el) * math.sin(az), math.sin(el)])
            cams.append(Camera(K, look_at(eye, np.zeros(3), up), eye))
    elif rig["layout"] == "cap":
        step = math.radians(rig["step_deg"])
        up = np.array([0.0, 1.0, 0.0])
        rows, cols = rig["rows"], rig["cols"]
        for r in range(rows):
            el = (r - (rows - 1) / 2.0) * step
            for c in range(cols):
                az = (c - (cols - 1) / 2.0) * step
                eye = dist * np.array([math.cos(el) * math.sin(az),
                                       math.sin(el),
                                       math.cos(el) * math.cos(az)])
                cams.append(Camera(K, look_at(eye, np.zeros(3), up), eye))
    else:
        raise ValueError(f"unknown rig layout {rig['layout']!r}")
    if len(cams) != rig["views"]:
        raise ValueError(f"layout gives {len(cams)} cameras, the rig states "
                         f"{rig['views']}")
    return cams


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash finaliser (murmur3's) on int64 tensors holding
    values below 2^32; products wrap, the low 32 bits are kept."""
    m = 0xFFFFFFFF
    h = h & m
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & m
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & m
    return h ^ (h >> 16)


def _lattice(ix, iy, iz, key: int) -> torch.Tensor:
    h = _mix32(ix * 73856093 ^ iy * 19349663 ^ iz * 83492791 ^ key)
    return h.to(torch.float32) * (1.0 / 4294967296.0)


def value_noise(X: torch.Tensor, cell: float, key: int,
                offset: torch.Tensor) -> torch.Tensor:
    """Smooth value noise in [0, 1] at world points X [..., 3]: a hashed
    random value at each lattice corner of spacing `cell`, blended by the
    smoothstep of the fractional position (C1 across cells)."""
    p = X.to(torch.float64) / cell + offset
    i0 = torch.floor(p)
    f = (p - i0).to(torch.float32)
    f = f * f * (3.0 - 2.0 * f)
    i0 = i0.to(torch.int64)
    out = torch.zeros(X.shape[:-1], dtype=torch.float32, device=X.device)
    for cx in (0, 1):
        wx = f[..., 0] if cx else 1.0 - f[..., 0]
        for cy in (0, 1):
            wy = f[..., 1] if cy else 1.0 - f[..., 1]
            for cz in (0, 1):
                wz = f[..., 2] if cz else 1.0 - f[..., 2]
                v = _lattice(i0[..., 0] + cx, i0[..., 1] + cy,
                             i0[..., 2] + cz, key)
                out = out + wx * wy * wz * v
    return out


def texture_key(cfg: dict, gen: torch.Generator) -> tuple:
    """The seed's texture: a hash key and a lattice offset per octave."""
    octaves = cfg["scene"]["texture"]["octaves"]
    key = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                            device=gen.device).item())
    offs = torch.rand((len(octaves), 3), generator=gen, device=gen.device,
                      dtype=torch.float64) * 1000.0
    return key, offs


def ray_cast(cam: Camera, h: int, w: int, scene_cfg: dict, device):
    """Cast every pixel ray of `cam` against the scene.  Returns (depth [h, w] float64, z-depth in the camera frame, inf
    where no surface is hit; normal [h, w, 3] world frame, unit; X [h, w,
    3] world hit point).  Pixel (row i, column j) is the image point
    (x=j, y=i); its ray is C + t * R^T K^-1 (x, y, 1), so t is the
    z-depth."""
    f64 = torch.float64
    ys = torch.arange(h, device=device, dtype=f64)
    xs = torch.arange(w, device=device, dtype=f64)
    Kinv = torch.as_tensor(np.linalg.inv(cam.K), device=device)
    Rt = torch.as_tensor(cam.R.T.copy(), device=device)
    C = torch.as_tensor(cam.C, device=device)
    pix = torch.stack(torch.broadcast_tensors(xs[None, :], ys[:, None],
                                              torch.ones((), device=device,
                                                         dtype=f64)), -1)
    d = pix @ (Rt @ Kinv).T                               # [h, w, 3]
    best = torch.full(d.shape[:2], math.inf, dtype=f64, device=device)
    normal = torch.zeros(d.shape, dtype=f64, device=device)
    for obj in scene_cfg["objects"]:
        if obj["type"] == "ellipsoid":
            c = torch.as_tensor(obj["center"], dtype=f64, device=device)
            a = torch.as_tensor(obj["radii"], dtype=f64, device=device)
            o = (C - c) / a
            dd = d / a
            qa = (dd * dd).sum(-1)
            qb = (dd * o).sum(-1)
            qc = float((o * o).sum()) - 1.0
            disc = qb * qb - qa * qc
            t = (-qb - torch.sqrt(disc.clamp(min=0.0))) / qa
            t = torch.where((disc >= 0.0) & (t > 0.0), t, math.inf)
            X = C + t[..., None] * d
            n = (X - c) / (a * a)
        elif obj["type"] == "plane":
            pn = torch.as_tensor(obj["normal"], dtype=f64, device=device)
            pn = pn / pn.norm()
            denom = (d * pn).sum(-1)
            t = (obj["offset"] - float((C * pn).sum())) / denom
            t = torch.where(t > 0.0, t, math.inf)
            n = pn.expand(d.shape)
        else:
            raise ValueError(f"unknown object type {obj['type']!r}")
        hit = t < best
        best = torch.where(hit, t, best)
        normal = torch.where(hit[..., None], n, normal)
    normal = normal / normal.norm(dim=-1, keepdim=True).clamp(min=1e-300)
    X = C + torch.where(torch.isfinite(best), best, 0.0)[..., None] * d
    return best, normal, X


def shade(X: torch.Tensor, normal: torch.Tensor, hit: torch.Tensor,
          scene_cfg: dict, key: tuple) -> torch.Tensor:
    """Intensity 0..255 of the hit points: the texture's octaves of value
    noise, a fixed Lambertian light (view-independent), rounded to the
    8-bit levels a camera records; the background value where nothing is
    hit."""
    tex = scene_cfg["texture"]
    k, offs = key
    v = torch.zeros(X.shape[:-1], dtype=torch.float32, device=X.device)
    for o, (cell, weight) in enumerate(tex["octaves"]):
        v = v + weight * value_noise(X, cell, k + o, offs[o])
    light = torch.as_tensor(tex["light"], dtype=torch.float64, device=X.device)
    light = light / light.norm()
    lam = (normal * light).sum(-1).abs().to(torch.float32)
    lo, hi = tex["albedo_range"]
    img = (lo + (hi - lo) * v) * (tex["ambient"] + (1.0 - tex["ambient"]) * lam)
    img = torch.where(hit, img, float(scene_cfg["background"]))
    return img.round().clamp(0.0, 255.0)


def make_scene(cfg: dict, seed: int, device) -> Scene:
    """All views of configuration `cfg` for `seed`, rendered on `device`
    and held on the host as float32 arrays (what the program's loader
    hands it)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rig = cfg["rig"]
    h, w = rig["height"], rig["width"]
    cams = camera_layout(rig)
    key = texture_key(cfg, gen)
    images = []
    for cam in cams:
        depth, normal, X = ray_cast(cam, h, w, cfg["scene"], device)
        img = shade(X, normal, torch.isfinite(depth), cfg["scene"], key)
        images.append(img.cpu().numpy().astype(np.float32))
    return Scene(cameras=cams, images=images, height=h, width=w, config=cfg)


def ground_truth(scene: Scene, view: int, device):
    """(depth [H, W] float64, inf where nothing is hit; normal [H, W, 3])
    of reference view `view`, from the same ray cast as its image."""
    depth, normal, _ = ray_cast(scene.cameras[view], scene.height,
                                scene.width, scene.config["scene"], device)
    return depth, normal
