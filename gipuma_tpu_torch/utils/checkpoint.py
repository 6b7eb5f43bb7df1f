"""Checkpoint / warm start of the PatchMatch state.

Counterpart of ``gipuma_tpu/utils/checkpoint.py``:

* ``save_state`` / ``load_state`` (:28-38): the full PMState (planes +
  cost + the generator's state, where the JAX package stores its PRNG key)
  as .npz — an exact resume point mid-run;
* ``warm_start`` (:53-115): rebuild the plane field from a depth map and
  world-frame normals — a previous run's output, or a coarser pyramid
  level's — and evaluate (or carry in) its cost, so PatchMatch continues
  from that geometry instead of a random init.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..config import MAXCOST, AlgorithmParams
from ..geometry import transforms as T
from ..models.patchmatch import PMState
from ..ops import checkerboard as cb
from ..ops.cost import multiview_cost


def save_state(path: str | os.PathLike, state: PMState) -> None:
    """planes, cost and (when the state has one) the generator's state and
    device type, compressed."""
    arrays = dict(planes=state.planes.cpu().numpy(),
                  cost=state.cost.cpu().numpy())
    if state.gen is not None:
        arrays["gen_state"] = state.gen.get_state().numpy()
        arrays["gen_device"] = np.array(state.gen.device.type)
    np.savez_compressed(path, **arrays)


def load_state(path: str | os.PathLike, device=None) -> PMState:
    """The saved PMState on `device` (None: the card), its generator
    continuing the saved stream.  A generator's state belongs to its
    device type: a state saved on the card loads onto the card, one saved
    on the CPU onto the CPU."""
    from ..pipeline import resolve_device
    device = resolve_device(device)
    with np.load(path) as z:
        planes = torch.as_tensor(z["planes"], device=device)
        cost = torch.as_tensor(z["cost"], device=device)
        gen = None
        if "gen_state" in z:
            saved = str(z["gen_device"])
            if saved != device.type:
                raise ValueError(
                    f"{path}: the generator state was saved on {saved!r} and "
                    f"cannot continue on {device.type!r}")
            gen = torch.Generator(device=device)
            gen.set_state(torch.from_numpy(z["gen_state"].copy()))
    return PMState(planes=planes, cost=cost, gen=gen)


def warm_start(scene, params: AlgorithmParams, gen: torch.Generator,
               depth: np.ndarray, normals_world: np.ndarray,
               cost_fn=multiview_cost) -> PMState:
    """Build a PMState from existing depth + world-frame normal maps (host
    arrays), on the scene's device.

    Inverse of models.patchmatch.finalize: rotates normals back into the
    rebased reference frame, recomputes plane distances, flips normals onto
    the visible hemisphere, and evaluates the multiview cost of the given
    geometry.  Pixels with invalid depth (<= 0 / non-finite) get a
    fronto-parallel plane at the depth-range midpoint."""
    dev = scene.rays.device
    depth = torch.as_tensor(np.asarray(depth, np.float32), device=dev)
    normals_world = torch.as_tensor(np.asarray(normals_world, np.float32),
                                    device=dev)
    return _warm_start_impl(scene, params, gen, depth, normals_world,
                            cost_fn=cost_fn)


def _warm_start_impl(scene, params: AlgorithmParams, gen, depth,
                     normals_world, cost_fn=multiview_cost,
                     cost_init=None) -> PMState:
    """warm_start on device tensors.  cost_init: a carried-in approximate
    cost [H, W] (the upsampled coarse level's, models/pyramid.py) used in
    place of evaluating the cost, inflated by 5%."""
    h, w = scene.rays.shape[:2]
    dev = scene.rays.device
    # Unsharded grid, as the JAX package builds it (no row_offset).
    x, y = T.pixel_grid(h, w, device=dev)

    # R_orig = R_orig_inv^-1: a 3x3 inverse, taken on the host.
    R_orig = torch.linalg.inv(scene.R_orig_inv.cpu()).to(dev)
    n = T._matvec(R_orig, normals_world)
    n = T.normalize(n, eps=1e-20)
    n = T.flip_to_hemisphere(n, scene.view_vec)

    valid = torch.isfinite(depth) & (depth > 0)
    mid = 0.5 * (scene.depth_min + scene.depth_max)
    depth = torch.where(valid, depth, mid)
    fallback = T.flip_to_hemisphere(
        torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype, device=dev).expand(
            n.shape), scene.view_vec)
    n = torch.where(valid[..., None], n, fallback)

    d = T.plane_d_at_pixel(scene.M_inv, scene.P_col4, n, x, y, depth)
    planes = torch.cat([n, d[..., None]], dim=-1)

    if cost_init is not None:
        # The carried value is inflated 5%: sweeps accept only strictly
        # better candidates, so a carried UNDERestimate would reject every
        # re-evaluation and leave the reported cost stale; inflated, the
        # first same-quality exact evaluation is accepted.  Invalid pixels
        # get MAXCOST so the first sweep repairs them.
        cost = torch.where(valid, 1.05 * cost_init.to(planes.dtype),
                           MAXCOST)
        return PMState(planes=planes, cost=cost, gen=gen)
    cost = torch.zeros((h, w), dtype=planes.dtype, device=dev)
    for parity in (0, 1):
        c = cost_fn(scene, params, parity, cb.extract(n, parity),
                    cb.extract(d, parity))
        cost = cb.interleave(cost, c, parity)
    return PMState(planes=planes, cost=cost, gen=gen)
