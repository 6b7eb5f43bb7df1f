"""Carry parameters, scenes and engine state across from the JAX package.

The system has no weights; what carries across is AlgorithmParams, the
rect scene and the PatchMatch state.  These functions take plain Python
and numpy values only (never ``gipuma_tpu`` objects), so the port stays
independent of JAX; the tests use them to feed the identical scene and
state to both engines.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .config import AlgorithmParams, CostCombination, MatchingAlgorithm
from .models.patchmatch import PMState
from .ops import checkerboard as cb
from .ops.cost import ScenePack
from .ops.rect_cost import RectScene
from .pipeline import resolve_device

_ENUMS = {"algorithm": MatchingAlgorithm, "cost_comb": CostCombination}


_EO_KEYS = ("E", "O", "pr", "pc", "h", "w2")


def to_numpy_tree(obj):
    """A NamedTuple of arrays (such as the JAX package's ScenePack, or its
    RectScene with the ScenePack base) -> nested dict of numpy arrays, by
    field name.  The exact path's padded window helpers (PaddedEO) become
    dicts of their planes and sizes; None stays None; other leaves are
    dropped.  Works on any array type numpy can read, without importing
    its library."""
    out = {}
    for f in obj._fields:
        v = getattr(obj, f)
        if v is None:
            out[f] = None
        elif hasattr(v, "_fields"):
            out[f] = to_numpy_tree(v)
        elif all(hasattr(v, k) for k in _EO_KEYS):
            out[f] = {k: (np.asarray(getattr(v, k)) if k in ("E", "O")
                          else int(getattr(v, k))) for k in _EO_KEYS}
        elif hasattr(v, "shape") or isinstance(v, (int, float)):
            out[f] = np.asarray(v)
    return out


def params_from_dict(d: Mapping) -> AlgorithmParams:
    """``dataclasses.asdict`` of the JAX AlgorithmParams -> the port's.
    Enum fields may be given by name (``"BEST_N"``), by value, or as any
    object with a ``name`` attribute."""
    fields = {f.name for f in dataclasses.fields(AlgorithmParams)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"unknown AlgorithmParams fields: {sorted(unknown)}")
    kw = {}
    for k, v in d.items():
        if k in _ENUMS:
            enum = _ENUMS[k]
            if hasattr(v, "name"):
                v = enum[v.name]
            elif isinstance(v, str):
                v = enum[v]
            else:
                v = enum(int(v))
        kw[k] = v
    return AlgorithmParams(**kw)


# Integer fields whatever dtype they arrive in.  src_rect is not one: it
# keeps its own dtype (packed int32 words, or the f32 channels of the
# pack_taps=False layout).
_INT_FIELDS = {"rot_k", "hw_valid", "tile_ok", "fwd2_ok", "ret2_ok"}


def _tensor(a, device, name):
    a = np.array(a)                      # a writable host copy
    if name in _INT_FIELDS or a.dtype.kind in "iu":
        if a.dtype == np.int8:
            return torch.as_tensor(a, device=device)
        return torch.as_tensor(a.astype(np.int32), device=device)
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a.astype(np.float32), device=device)


_EXACT_FIELDS = ("ref_img", "ref_gx", "ref_gy", "src")


def scene_pack_from_numpy(tree: Mapping, device=None) -> ScenePack:
    """A dict of numpy arrays keyed by ScenePack field -> ScenePack, on
    ``device`` (None: the card, as every entry point; pipeline.
    resolve_device).

    The exact path's arrays carry across when the tree has them at full
    size: the PaddedEO planes (dicts from to_numpy_tree), and ``src``
    rebuilt from the JAX package's block split ``src_blocks``
    [V, NB, 3C, H, 128] by joining the blocks and cropping to W.  A lite
    JAX scene (placeholder arrays there) gives a lite ScenePack; keys of
    the JAX package's TPU layouts (the 4-tap ``src`` table) are ignored."""
    device = resolve_device(device)
    kw = {}
    for f in ScenePack._fields:
        if f in _EXACT_FIELDS:
            continue
        a = np.asarray(tree[f])
        if f in ("row_offset", "global_h"):
            kw[f] = torch.as_tensor(a.astype(np.int32), device=device)
        else:
            kw[f] = _tensor(a, device, f)
    h, w = kw["rays"].shape[:2]
    eo = [tree.get(f) for f in ("ref_img", "ref_gx", "ref_gy")]
    blocks = tree.get("src_blocks")
    if (all(isinstance(e, Mapping) and e["h"] == h for e in eo)
            and blocks is not None and np.asarray(blocks).shape[3] == h):
        for f, e in zip(("ref_img", "ref_gx", "ref_gy"), eo):
            kw[f] = cb.PaddedEO(
                E=_tensor(e["E"], device, f), O=_tensor(e["O"], device, f),
                pr=e["pr"], pc=e["pc"], h=e["h"], w2=e["w2"])
        b = np.asarray(blocks, np.float32)                 # [V,NB,3C,H,128]
        V, NB, C3, H, L = b.shape
        src = np.moveaxis(b, 1, 3).reshape(V, C3, H, NB * L)[..., :w]
        kw["src"] = torch.as_tensor(np.ascontiguousarray(src), device=device)
    return ScenePack(**kw)


def rect_scene_from_numpy(tree: Mapping, device=None) -> RectScene:
    """A JAX RectScene given as a dict of numpy arrays -> the port's, on
    ``device`` (None: the card).

    tree["base"] is the ScenePack dict; the other keys are RectScene
    fields (None or absent optional fields stay None).  ``spans`` keeps
    its static shape; ``rot_k_host`` is filled from rot_k; a nested
    ``cull`` scene (config.cull_downscale) carries across the same way."""
    device = resolve_device(device)
    kw = {"base": scene_pack_from_numpy(tree["base"], device)}
    for f in RectScene._fields:
        if f in ("base", "cull", "rot_k_host", "valid_host"):
            continue
        a = tree.get(f)
        if a is None:
            continue
        if f == "spans":
            kw[f] = torch.zeros(np.asarray(a).shape, dtype=torch.int8,
                                device=device)
            continue
        kw[f] = _tensor(a, device, f)
    if tree.get("cull") is not None:
        kw["cull"] = rect_scene_from_numpy(tree["cull"], device)
    kw["rot_k_host"] = tuple(int(k) for k in np.asarray(tree["rot_k"]))
    kw["valid_host"] = tuple(
        bool(v) for v in np.asarray(tree["base"]["view_valid"]))
    return RectScene(**kw)


def state_from_numpy(planes, cost, generator: torch.Generator | None = None,
                     device=None) -> PMState:
    """Engine state from numpy: planes [H, W, 4], cost [H, W], on
    ``device`` (None: the card)."""
    device = resolve_device(device)
    return PMState(
        planes=torch.as_tensor(np.array(planes, np.float32), device=device),
        cost=torch.as_tensor(np.array(cost, np.float32), device=device),
        gen=generator)
