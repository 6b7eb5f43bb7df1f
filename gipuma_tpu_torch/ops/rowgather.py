"""Row-aligned gathers of the rectified cost paths — kernels 1, 4 and 5.

Counterpart of ``gipuma_tpu/ops/pallas_rowgather.py``.  After per-pair
rectification every sample reads from its own image row, so a gather is
a selection along the last axis of a [C, H, W] source:

* NEAREST (``nearest=True``, ``csrc/rowgather.cu``): the two passes of
  every ops/permute2d permutation,
      out[b, c, i, j] = src[c, i, clip(int(clip(x[b, i, j], 0, W-1) + 0.5),
                                       0, W-1)];
  pure selection, so int32-packed f16 pairs (ops/rect_cost._pack_m and
  friends) pass through bit-exactly.  An optional [ceil(H/8), ceil(Ws/128)]
  output-tile mask lets the kernel skip whole tiles; skipped outputs are
  unspecified (the ops/permute2d mask contract).
* lerp (the default, ``csrc/rowgather_lerp.cu``): linear interpolation
  along the row at x = clip(x, 0, W-1), x0 = clip(floor(x), 0, W-2),
  fx = clip(x - x0, 0, 1), out = v0*(1-fx) + v1*fx, from an f32 source
  (v0, v1 = src[x0], src[x0+1]) or from int32 words that pack both taps as
  bf16 (``pack_taps``: PACKED).  With ``grad_fwd`` the packed source holds
  [C' image words, C' y-gradient words] and the output [img, gx, gy] with
  gx = 2*(v1 - v0) of the image word (GFWD).
* affine (``row_gather_affine``, ``csrc/rowgather_affine.cu``): PACKED lerp
  at positions computed from per-candidate affine disparity fields,
  x = (j + dx) - clip(a*(j + dx) + b*(i + dy) + c, lo, hi);
  ``row_gather_affine_rows`` gathers several window rows in one launch.

``src_dy`` (port-only) reads source row clip(i + src_dy, 0, H-1) for
output row i: the edge-replicated row shift the JAX callers make by
slicing a padded copy, done in the gather instead.

On a CUDA tensor the wrappers launch the kernels; on a CPU tensor they run
the plain torch versions below.  A NaN position gives a NaN sample (the
kernels clip with comparisons and read tap 0); the TPU kernels' 128-column
blocks and scratch windows are not carried over: every sample reads its
true clamped position.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels


def pack_taps(src: np.ndarray) -> np.ndarray:
    """Pack both bilinear taps into one int32 word per pixel:
    (bf16(src[..., x]) << 16) | bf16(src[..., x+1]), x+1 edge-clamped,
    rounded half-to-even.  numpy in / numpy out; bitwise equal to the JAX
    package's pack_taps."""
    v0 = np.ascontiguousarray(src, np.float32)
    v1 = np.concatenate([v0[..., 1:], v0[..., -1:]], axis=-1)

    def bf16_hi(f):
        b = f.view(np.uint32)
        rounded = (b + 0x7FFF + ((b >> 16) & 1)) >> 16   # round-half-even
        return rounded.astype(np.uint32)

    packed = (bf16_hi(v0) << np.uint32(16)) | bf16_hi(v1)
    return packed.view(np.int32)


def _to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 holding an unsigned 32-bit pattern -> int32 with those bits."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def unpack_taps(vp: torch.Tensor):
    """bf16 tap pair (v0 in the high half-word, v1 in the low) of an int32
    word -> two float32 tensors (pure bit work on the int32 words; the
    shift wraps)."""
    return (vp & -65536).view(torch.float32), (vp << 16).view(torch.float32)


def _nearest_index(x: torch.Tensor, W: int) -> torch.Tensor:
    return (x.clamp(0.0, float(W - 1)) + 0.5).to(torch.int32).clamp(0, W - 1)


def _shift_rows(src_chw: torch.Tensor, src_dy: int) -> torch.Tensor:
    """out[:, i] = src[:, clip(i + src_dy, 0, H-1)]."""
    if not src_dy:
        return src_chw
    H = src_chw.shape[1]
    rows = (torch.arange(H, device=src_chw.device) + src_dy).clamp(0, H - 1)
    return src_chw[:, rows]


def _lerp_taps(x: torch.Tensor, W: int):
    """The kernels' tap index and weight: x0 (int64) = clip(floor(xx), 0,
    W-2) and fx = clip(xx - x0, 0, 1) at xx = clip(x, 0, W-1).  A NaN
    position keeps NaN in fx and reads tap 0 (a float-to-int cast of NaN
    is undefined on the CPU, so the index is zeroed first)."""
    xx = x.clamp(0.0, float(W - 1))
    x0 = torch.floor(xx).nan_to_num(0.0).to(torch.int64).clamp(0, W - 2)
    fx = (xx - x0.to(torch.float32)).clamp(0.0, 1.0)
    return x0, fx


def _lerp_gather(src: torch.Tensor, x0: torch.Tensor, fx: torch.Tensor,
                 grad_fwd: bool) -> torch.Tensor:
    """src [C, H, W] f32 or packed int32, x0 / fx [B, H, Ws] ->
    [B, Co, H, Ws] f32 (Co = 3C/2 under grad_fwd, else C)."""
    C, H, W = src.shape
    B, _, Ws = x0.shape
    idx = x0[:, None].expand(B, C, H, Ws)
    s = src[None].expand(B, C, H, W)
    if src.dtype == torch.int32:
        v0, v1 = unpack_taps(torch.gather(s, 3, idx))
    else:
        v0, v1 = torch.gather(s, 3, idx), torch.gather(s, 3, idx + 1)
    f = fx[:, None]
    out = v0 * (1 - f) + v1 * f
    if not grad_fwd:
        return out
    half = C // 2
    return torch.cat([out[:, :half], 2.0 * (v1[:, :half] - v0[:, :half]),
                      out[:, half:]], dim=1)


def row_gather_nearest_plain(src_chw: torch.Tensor, x: torch.Tensor
                             ) -> torch.Tensor:
    """Plain torch version: one torch.gather along the last axis after the
    kernel's clip and round.  src_chw [C, H, W] (any 32-bit dtype), x
    [B, H, Ws] -> [B, C, H, Ws].  Computes every output (a tile mask only
    makes outputs unspecified, so ignoring it is a valid result)."""
    C, H, W = src_chw.shape
    B, _, Ws = x.shape
    idx = _nearest_index(x, W).to(torch.int64)               # [B, H, Ws]
    idx = idx[:, None].expand(B, C, H, Ws)
    return torch.gather(src_chw[None].expand(B, C, H, W), 3, idx)


def row_gather_lerp_plain(src_chw: torch.Tensor, x: torch.Tensor,
                          grad_fwd: bool = False, src_dy: int = 0
                          ) -> torch.Tensor:
    """Plain torch version of the lerp kernel (f32, PACKED, GFWD): src_chw
    [C, H, W], x [B, H, Ws] -> [B, Co, H, Ws] f32."""
    x0, fx = _lerp_taps(x, src_chw.shape[-1])
    return _lerp_gather(_shift_rows(src_chw, src_dy), x0, fx, grad_fwd)


@functools.lru_cache(maxsize=64)
def _offsets(dxs: tuple, dev: torch.device) -> torch.Tensor:
    """The column offsets as an int32 tensor on `dev`, made once per
    (offsets, device): a later call copies nothing from the host, so a CUDA
    graph can capture it."""
    return torch.tensor(dxs, dtype=torch.int32, device=dev)


def row_gather_affine_plain(src_chw: torch.Tensor, abc: torch.Tensor,
                            dxs, dy: float, disp_bounds: torch.Tensor,
                            src_dy: int = 0) -> torch.Tensor:
    """Plain torch version of the affine kernel: src_chw [C, H, W] int32
    packed, abc [K, 3, H, Ws] -> [K*E, C, H, Ws] f32, with the kernel's
    association (a*x + b*y) + c."""
    K, _, M, Ws = abc.shape
    dev = abc.device
    xse = (torch.arange(Ws, dtype=torch.int32, device=dev)[None, :]
           + _offsets(tuple(dxs), dev)[:, None]).to(torch.float32)  # [E, Ws]
    yv = torch.arange(M, dtype=torch.int32, device=dev).to(torch.float32) \
        + float(dy)                                           # [M]
    a, b, c = abc[:, 0, None], abc[:, 1, None], abc[:, 2, None]
    disp = (a * xse[None, :, None, :] + b * yv[:, None]) + c  # [K, E, M, Ws]
    disp = torch.minimum(torch.maximum(disp, disp_bounds[0]), disp_bounds[1])
    x0, fx = _lerp_taps(xse[None, :, None, :] - disp, src_chw.shape[-1])
    return _lerp_gather(_shift_rows(src_chw, src_dy),
                        x0.reshape(-1, M, Ws), fx.reshape(-1, M, Ws), False)


def _tile_mask(tile_ok: torch.Tensor, H: int, Ws: int) -> torch.Tensor:
    """The mask as int32 [ceil(H/8), ceil(Ws/128)]; tiles the caller's mask
    does not cover are off (as the JAX package pads it with zeros)."""
    th, tw = -(-H // 8), -(-Ws // 128)
    tm = tile_ok.to(torch.int32)
    if tm.shape != (th, tw):
        full = torch.zeros((th, tw), dtype=torch.int32, device=tm.device)
        full[:min(th, tm.shape[0]), :min(tw, tm.shape[1])] = tm[:th, :tw]
        tm = full
    return tm.contiguous()


def _check_grid(what: str, src_chw, x_like, rows: int, batch: int):
    if src_chw.shape[1] != rows:
        raise ValueError(f"{what}: sample rows must align with source rows")
    if not (src_chw.is_contiguous() and x_like.is_contiguous()):
        raise ValueError(f"{what}: contiguous inputs required")
    if x_like.device != src_chw.device:
        raise ValueError(f"{what}: inputs on different devices")
    if rows > 65535 or batch > 65535:
        raise ValueError(f"{what}: grid too large ({batch}, {rows})")


def row_gather_nearest_cuda(src_chw: torch.Tensor, x: torch.Tensor,
                            tile_ok: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Launch csrc/rowgather.cu: same contract as the plain version."""
    C, H, W = src_chw.shape
    B, M, Ws = x.shape
    if src_chw.element_size() != 4 or src_chw.is_complex():
        raise TypeError(f"row_gather: 32-bit source words, got {src_chw.dtype}")
    if x.dtype != torch.float32:
        raise TypeError(f"row_gather: float32 positions, got {x.dtype}")
    _check_grid("row_gather", src_chw, x, M, B)
    words = src_chw.view(torch.int32)
    out = torch.empty((B, C, H, Ws), dtype=torch.int32, device=x.device)
    tm = None if tile_ok is None else _tile_mask(tile_ok, H, Ws)
    fn = _cuda_fn("rowgather", "gtt_row_gather_nearest",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                  + [ctypes.c_void_p])
    rc = fn(kernels.ptr(words), kernels.ptr(x), kernels.ptr(tm),
            kernels.ptr(out), B, C, H, W, Ws,
            0 if tm is None else tm.shape[1], kernels.stream_ptr(x.device))
    kernels.check(rc, "row_gather_nearest")
    kernels.counts["row_gather_nearest"] += 1
    return out.view(src_chw.dtype)


def row_gather_lerp_cuda(src_chw: torch.Tensor, x: torch.Tensor,
                         grad_fwd: bool = False, src_dy: int = 0
                         ) -> torch.Tensor:
    """Launch csrc/rowgather_lerp.cu: same contract as the plain version."""
    C, H, W = src_chw.shape
    B, M, Ws = x.shape
    packed = src_chw.dtype == torch.int32
    if not packed and src_chw.dtype != torch.float32:
        raise TypeError(f"row_gather lerp: float32 or packed int32 source, "
                        f"got {src_chw.dtype}")
    if grad_fwd and not (packed and C % 2 == 0):
        raise ValueError("grad_fwd needs a packed [img-taps, gy-taps] source")
    if x.dtype != torch.float32 or W < 2:
        raise ValueError(f"row_gather lerp: float32 positions and W >= 2, "
                         f"got {x.dtype}, W={W}")
    _check_grid("row_gather lerp", src_chw, x, M, B)
    co = C + C // 2 if grad_fwd else C
    out = torch.empty((B, co, H, Ws), dtype=torch.float32, device=x.device)
    fn = _cuda_fn("rowgather_lerp", "gtt_row_gather_lerp",
                  [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                  + [ctypes.c_void_p])
    rc = fn(kernels.ptr(src_chw), kernels.ptr(x), kernels.ptr(out), B, C, H,
            W, Ws, int(src_dy), int(packed), int(grad_fwd),
            kernels.stream_ptr(x.device))
    kernels.check(rc, "row_gather_lerp")
    kernels.counts["row_gather_lerp"] += 1
    return out


# Most column offsets and window rows one affine launch takes (they ride
# in its launch arguments); the rows wrapper splits longer row lists.
MAX_DXS = 64
MAX_ROWS = 64
# gtt_row_gather_affine_rows(src, abc, db, out, dxs, E, dys, src_dys, R, K,
# C, H, W, Ws, stream).
AFFINE_ARGTYPES = ([ctypes.c_void_p] * 5
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _affine_launch(src_chw: torch.Tensor, abc: torch.Tensor, dxs,
                   dys, src_dys, disp_bounds: torch.Tensor) -> torch.Tensor:
    """Launch csrc/rowgather_affine.cu for window rows (dys[r], src_dys[r]):
    [R, K*E, C, H, Ws] f32.  Each launch adds one to the count and the
    bytes it must move (abc and the source read once, the output written
    once) to ``kernels.bytes_moved``."""
    C, H, W = src_chw.shape
    K, three, M, Ws = abc.shape
    E, R = len(dxs), len(dys)
    if (src_chw.dtype != torch.int32 or abc.dtype != torch.float32
            or three != 3 or disp_bounds.dtype != torch.float32
            or disp_bounds.numel() != 2):
        raise ValueError("row_gather_affine: expected src int32 [C,H,W], abc "
                         "f32 [K,3,H,Ws], disp_bounds f32 [2]; got "
                         f"{src_chw.dtype} {tuple(src_chw.shape)}, "
                         f"{abc.dtype} {tuple(abc.shape)}, "
                         f"{disp_bounds.dtype} {tuple(disp_bounds.shape)}")
    if not 1 <= E <= MAX_DXS or W < 2 or R < 1:
        raise ValueError(f"row_gather_affine: 1..{MAX_DXS} column offsets, "
                         f"W >= 2 and a window row, got {E}, W={W}, R={R}")
    _check_grid("row_gather_affine", src_chw, abc, M, K)
    if (disp_bounds.device != abc.device
            or not disp_bounds.is_contiguous()):
        raise ValueError("row_gather_affine: disp_bounds contiguous on the "
                         "inputs' device")
    out = torch.empty((R, K * E, C, H, Ws), dtype=torch.float32,
                      device=abc.device)
    dx_arr = (ctypes.c_int * E)(*(int(d) for d in dxs))
    fn = _cuda_fn("rowgather_affine", "gtt_row_gather_affine_rows",
                  AFFINE_ARGTYPES)
    for r0 in range(0, R, MAX_ROWS):
        n = min(MAX_ROWS, R - r0)
        dy_arr = (ctypes.c_float * n)(*(float(d) for d in dys[r0:r0 + n]))
        sdy_arr = (ctypes.c_int * n)(*(int(d) for d in src_dys[r0:r0 + n]))
        rc = fn(kernels.ptr(src_chw), kernels.ptr(abc),
                kernels.ptr(disp_bounds), kernels.ptr(out[r0:r0 + n]),
                dx_arr, E, dy_arr, sdy_arr, n, K, C, H, W, Ws,
                kernels.stream_ptr(abc.device))
        kernels.check(rc, "row_gather_affine")
        kernels.counts["row_gather_affine"] += 1
        kernels.bytes_moved["row_gather_affine"] += 4 * (
            3 * K * H * Ws + n * K * E * C * H * Ws + C * H * W)
    return out


def row_gather_affine_cuda(src_chw: torch.Tensor, abc: torch.Tensor, dxs,
                           dy: float, disp_bounds: torch.Tensor,
                           src_dy: int = 0) -> torch.Tensor:
    """Launch csrc/rowgather_affine.cu for one window row: same contract as
    the plain version; disp_bounds (float32 [2] on the card) is read
    in-kernel."""
    return _affine_launch(src_chw, abc, dxs, [dy], [src_dy], disp_bounds)[0]


def row_gather_affine_rows_plain(src_chw: torch.Tensor, abc: torch.Tensor,
                                 dxs, dys, disp_bounds: torch.Tensor
                                 ) -> torch.Tensor:
    """Plain torch version of the rows launch: the stack of the one-row
    plain calls at window rows dys (integers; each row's source shift is
    its dy), [R, K*E, C, H, Ws]."""
    return torch.stack([row_gather_affine_plain(src_chw, abc, dxs, float(dy),
                                                disp_bounds, int(dy))
                        for dy in dys])


def row_gather_affine_rows_cuda(src_chw: torch.Tensor, abc: torch.Tensor,
                                dxs, dys, disp_bounds: torch.Tensor
                                ) -> torch.Tensor:
    """Launch csrc/rowgather_affine.cu once for the window rows dys: same
    contract as the plain version."""
    return _affine_launch(src_chw, abc, dxs, [float(d) for d in dys],
                          [int(d) for d in dys], disp_bounds)


def row_gather_affine_staged_rows(R: int, C: int, W: int) -> int:
    """Source rows the affine kernel stages in a block's shared memory for R
    window rows of a [C, H, W] source; 0 when it reads global memory."""
    fn = _cuda_fn("rowgather_affine", "gtt_row_gather_affine_staged_rows",
                  [ctypes.c_int] * 3)
    return fn(R, C, W)


_FNS: dict = {}


def _cuda_fn(lib: str, symbol: str, argtypes):
    fn = _FNS.get(symbol)
    if fn is None:
        fn = getattr(kernels.library(lib), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return fn


def row_gather_batch(src_chw: torch.Tensor, x: torch.Tensor,
                     grad_fwd: bool = False, nearest: bool = False,
                     tile_ok: torch.Tensor | None = None,
                     src_dy: int = 0) -> torch.Tensor:
    """row_gather for B sample grids sharing one source: x [B, H, Ws] ->
    [B, C, H, Ws] ([B, 3C/2, H, Ws] under grad_fwd) in one launch.  Lerp by
    default, NEAREST with ``nearest``; the tile mask is a NEAREST option
    (the permute passes), as the JAX callers use it.  The kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if nearest:
        if grad_fwd or src_dy:
            raise ValueError("row_gather: grad_fwd / src_dy are lerp options")
        if src_chw.device.type == "cpu":
            return row_gather_nearest_plain(src_chw, x)
        return row_gather_nearest_cuda(src_chw, x, tile_ok)
    if tile_ok is not None:
        raise ValueError("row_gather: the tile mask is a NEAREST option")
    if src_chw.device.type == "cpu":
        return row_gather_lerp_plain(src_chw, x, grad_fwd, src_dy)
    return row_gather_lerp_cuda(src_chw, x, grad_fwd, src_dy)


def row_gather(src_chw: torch.Tensor, x: torch.Tensor,
               grad_fwd: bool = False, nearest: bool = False,
               tile_ok: torch.Tensor | None = None,
               src_dy: int = 0) -> torch.Tensor:
    """row_gather_batch for one sample grid: x [H, Ws] -> [C, H, Ws]."""
    return row_gather_batch(src_chw, x[None], grad_fwd=grad_fwd,
                            nearest=nearest, tile_ok=tile_ok,
                            src_dy=src_dy)[0]


def row_gather_affine(src_chw: torch.Tensor, abc: torch.Tensor, dxs,
                      dy: float, disp_lo=None, disp_hi=None,
                      disp_bounds: torch.Tensor | None = None,
                      src_dy: int = 0) -> torch.Tensor:
    """Packed row gather with affine sample positions.

    src_chw: [C, H, W] int32 packed tap words (pack_taps); abc: [K, 3, H, Ws]
    per-candidate affine disparity fields; dxs: E window column offsets;
    dy: the window row offset; disp_lo / disp_hi (floats or 0-d tensors) or
    disp_bounds (float32 [2] on the inputs' device, read in-kernel — no
    host sync): the disparity clamp.  Returns [K*E, C, H, Ws] f32 samples
    at x = (j+dx) - clip(a*(j+dx) + b*(i+dy) + c, lo, hi), edge-clamped."""
    dev = abc.device
    if disp_bounds is None:
        if disp_lo is None or disp_hi is None:
            raise ValueError("row_gather_affine needs the disparity clamp")
        disp_bounds = torch.stack([
            torch.as_tensor(disp_lo, dtype=torch.float32, device=dev),
            torch.as_tensor(disp_hi, dtype=torch.float32, device=dev)])
    if dev.type == "cpu":
        return row_gather_affine_plain(src_chw, abc, dxs, dy, disp_bounds,
                                       src_dy)
    return row_gather_affine_cuda(src_chw, abc, dxs, dy,
                                  disp_bounds.contiguous(), src_dy)


def row_gather_affine_rows(src_chw: torch.Tensor, abc: torch.Tensor, dxs,
                           dys, disp_bounds: torch.Tensor) -> torch.Tensor:
    """row_gather_affine for the window rows dys (integers) in one launch,
    each row's source shifted by its dy (src_dy = dy, as the census and
    unfused costs read their window rows): [R, K*E, C, H, Ws], row r equal
    to row_gather_affine(..., dys[r], disp_bounds=..., src_dy=dys[r])."""
    if abc.device.type == "cpu":
        return row_gather_affine_rows_plain(src_chw, abc, dxs, dys,
                                            disp_bounds)
    return row_gather_affine_rows_cuda(src_chw, abc, dxs, dys,
                                       disp_bounds.contiguous())
