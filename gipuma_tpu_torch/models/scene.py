"""ScenePack construction: calibration -> device geometry fields.

Counterpart of ``gipuma_tpu/models/scene.py:26-193``.  ``lite=True`` builds
only the geometry fields (what the rect path reads); ``lite=False`` adds
the exact cost path's reference windows (PaddedEO of the image and its
central gradients) and the source views' (image, gx, gy) channels
[V, 3C, H, W], the sampler's layout.  The JAX package's 4-tap table and
128-column block split are TPU gather layouts and are not built here.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import AlgorithmParams
from ..geometry import transforms as T
from ..geometry.camera import Rig
from ..ops import checkerboard as cb
from ..ops.cost import ScenePack
from ..ops.sampling import central_gradients


def ensure_even_width(img: np.ndarray) -> np.ndarray:
    """Pad odd-width images by one edge-replicated column (checkerboard
    layout needs even W; outputs are cropped back by the pipeline)."""
    if img.shape[1] % 2 == 1:
        img = np.concatenate([img, img[:, -1:]], axis=1)
    return img


def build_scene(images: Sequence[np.ndarray], rig: Rig,
                view_subset: Sequence[int], params: AlgorithmParams,
                depth_min: float, depth_max: float,
                lite: bool = False, device=None) -> ScenePack:
    """Pack the reference image (index 0) and the selected source views.

    images: [H, W] or [H, W, C] float arrays (intensity scale 0-255).
    view_subset: indices into `images` / rig.cameras (excluding 0).
    lite=True skips the exact path's sampling arrays (those fields stay
    None); the rect path reads only the geometry fields.  device: None
    means the card (it raises when CUDA is absent); pass "cpu" explicitly
    for the CPU."""
    from ..pipeline import resolve_device
    device = resolve_device(device)
    ref = np.asarray(images[0], dtype=np.float32)
    if ref.ndim == 2:
        ref = ref[..., None]
    h, w = ref.shape[:2]
    assert w % 2 == 0, "width must be even — use ensure_even_width"

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    exact = {}
    if not lite:
        pr, pc = params.box_vrad, params.box_hrad + 2
        ref_j = t(ref)
        gx, gy = central_gradients(ref_j.permute(2, 0, 1))
        exact["ref_img"] = cb.PaddedEO.build(ref_j, pr, pc)
        exact["ref_gx"] = cb.PaddedEO.build(gx.permute(1, 2, 0), pr, pc)
        exact["ref_gy"] = cb.PaddedEO.build(gy.permute(1, 2, 0), pr, pc)
        src = []
        for v in view_subset:
            img = np.asarray(images[v], dtype=np.float32)
            if img.ndim == 2:
                img = img[..., None]
            assert img.shape[:2] == (h, w), \
                "all views must share the image size"
            chw = t(img).permute(2, 0, 1)
            vgx, vgy = central_gradients(chw)
            src.append(torch.cat([chw, vgx, vgy], dim=0))
        exact["src"] = torch.stack(src).contiguous()     # [V, 3C, H, W]

    A_list, b_list = [], []
    for v in view_subset:
        cam = rig.cameras[v]
        A, b = T.warp_coefficients(cam.K, cam.R, cam.t)
        A_list.append(A)
        b_list.append(b)

    ref_cam = rig.cameras[0]
    K1_inv = t(ref_cam.K_inv)
    x, yg = T.pixel_grid(h, w, device=device)
    rays = T.pixel_rays(K1_inv, x, yg)
    M_inv = t(ref_cam.M_inv)
    P_col4 = t(ref_cam.P_col4)
    view_vec = T.view_vectors(M_inv, P_col4, t(ref_cam.C), x, yg)
    ref_t = t(ref)
    return ScenePack(
        A=t(np.stack(A_list)), b=t(np.stack(b_list)),
        k1inv_c0=K1_inv[:, 0].contiguous(), k1inv_c1=K1_inv[:, 1].contiguous(),
        rays=rays, view_vec=view_vec,
        fx=t(rig.f), cx=t(ref_cam.K[0, 2]), cy=t(ref_cam.K[1, 2]),
        alpha_focal=t(rig.alpha), f=t(rig.f), baseline=t(rig.baseline),
        M_inv=M_inv, P_col4=P_col4, R_orig_inv=t(ref_cam.R_orig_inv),
        depth_min=t(depth_min), depth_max=t(depth_max),
        view_valid=torch.ones(len(view_subset), device=device),
        texture_ok=(_texture_mask(ref_t, params) if params.no_texture_check
                    else torch.ones((h, w), dtype=torch.bool, device=device)),
        row_offset=torch.tensor(0, dtype=torch.int32, device=device),
        global_h=torch.tensor(h, dtype=torch.int32, device=device),
        **exact,
    )


def _texture_mask(ref: torch.Tensor, params: AlgorithmParams) -> torch.Tensor:
    """NOTEXTURE_CHECK (hasImageTexture, gipuma.cu:520-547): a pixel is
    textureless when more than hrad*vrad*4/inc^2 * no_texture_per window
    samples have bilateral weight > no_texture_sim."""
    h, w = ref.shape[:2]
    count = torch.zeros((h, w), dtype=torch.int32, device=ref.device)
    rows = torch.arange(h, device=ref.device)
    cols = torch.arange(w, device=ref.device)
    for (dx, dy) in params.window_offsets():
        win = ref[(rows + dy).clamp(0, h - 1)][:, (cols + dx).clamp(0, w - 1)]
        wgt = torch.exp(-(win - ref).abs().mean(-1) / params.gamma)
        count = count + (wgt > params.no_texture_sim).to(torch.int32)
    inc = params.window_increment
    limit = (params.box_hrad * params.box_vrad * 4) // (inc * inc) \
        * params.no_texture_per
    return count <= limit


def pad_scene_views(scene: ScenePack, multiple: int) -> ScenePack:
    """Pad the view axis to a multiple of `multiple`; padded slots copy
    view 0 and carry view_valid = 0 (their costs are forced to MAXCOST)."""
    V = scene.num_views
    target = -(-V // multiple) * multiple
    if target == V:
        return scene
    pad = target - V

    def pad0(a):
        return torch.cat([a, a[:1].repeat((pad,) + (1,) * (a.ndim - 1))])

    return scene._replace(
        A=pad0(scene.A), b=pad0(scene.b),
        src=None if scene.src is None else pad0(scene.src),
        view_valid=torch.cat([scene.view_valid,
                              scene.view_valid.new_zeros(pad)]))
