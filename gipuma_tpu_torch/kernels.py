"""Build, bind, check and launch the port's hand-written CUDA kernels;
count launches.

Each source under ``csrc/`` is compiled by ``nvcc`` into its own shared
library with a plain C interface (``-gencode arch=compute_90a,code=sm_90a``)
and loaded with ``ctypes``.  Builds run at first use, all sources in
parallel, into ``build/`` beside this file; a library is rebuilt only when
its source or flags change (the file name carries their hash).  The flags
are ``NVCC_FLAGS`` and the source's own ``SOURCE_FLAGS`` (``nvcc_command``
gives the whole command).  ``ENTRIES`` types every C entry; ``entry``
binds one once, ``check_args`` refuses a wrapper's tensor arguments before
any build, and ``launch`` runs an entry, raises on its error and counts it.

``counts`` holds one plain integer per kernel: ``launch`` adds one
exactly where a wrapper launches its kernel (and one to a route's own
count: ``bilinear_sample_tiled``, the sampler's tiled launches).
``bytes_moved`` sums, per launch, the bytes a launch must move (each
input read once, each output written once) for the kernels whose
wrappers count them (the affine gather).
``reset_counts`` sets both to 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"

# Kernel library name -> source file under csrc/.
SOURCES = {
    "rowgather": "rowgather.cu",
    "sdg_fused": "sdg_fused.cu",
    "sampling": "sampling.cu",
    "rowgather_lerp": "rowgather_lerp.cu",
    "rowgather_affine": "rowgather_affine.cu",
    "permute2d": "permute2d.cu",
    "exact_cost": "exact_cost.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Per-source flags.  The gathers and the sampler are held bit-equal to
# their plain versions, which round every product and sum on its own, so
# they are built without FMA contraction.  The fused cost is held to 1e-3:
# it rounds its sample positions explicitly (__fmul_rn / __fadd_rn) and
# lets the rest of its arithmetic contract.  The exact cost's two kernels
# round every product, sum and quotient as their plain versions do (the
# warp prologue is bit-equal to its plain version; the window epilogue
# differs from its plain version only in the order of the window sum), so
# that library is built without FMA contraction too.
SOURCE_FLAGS = {
    "rowgather": ["-fmad=false"],
    "sdg_fused": ["-fmad=true"],
    "sampling": ["-fmad=false"],
    "rowgather_lerp": ["-fmad=false"],
    "rowgather_affine": ["-fmad=false"],
    "permute2d": ["-fmad=false"],
    "exact_cost": ["-fmad=false"],
}

# C entry -> (library, argument types).  Every entry returns an int: its
# launch's cudaGetLastError() (the staged-rows query: a row count).
_vp, _ci, _cf, _cll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
ENTRIES = {
    "gtt_row_gather_nearest": ("rowgather", [_vp] * 4 + [_ci] * 6 + [_vp]),
    "gtt_row_gather_lerp": ("rowgather_lerp", [_vp] * 3 + [_ci] * 8 + [_vp]),
    # (src, abc, disp_bounds, out, dxs[E], E, dys[R], src_dys[R], R, K, C,
    # H, W, Ws, stream)
    "gtt_row_gather_affine_rows": (
        "rowgather_affine",
        [_vp] * 5 + [_ci, _vp, _vp] + [_ci] * 6 + [_vp]),
    "gtt_row_gather_affine_staged_rows": ("rowgather_affine", [_ci] * 3),
    "gtt_sdg_fused_cost": ("sdg_fused",
                           [_vp] * 7 + [_ci] * 13 + [_cf] * 7 + [_vp]),
    "gtt_bilinear_sample": ("sampling",
                            [_vp] * 4 + [_ci] * 3 + [_cll] * 2 + [_ci, _vp]),
    "gtt_permute2d": ("permute2d", [_vp] * 5 + [_ci] * 6 + [_vp]),
    "gtt_exact_window_cost": ("exact_cost",
                              [_vp] * 7 + [_ci] * 11 + [_cf] * 6 + [_vp]),
    "gtt_exact_warp_coords": ("exact_cost", [_vp] * 10 + [_ci] * 4 + [_vp]),
}

counts = {"row_gather_nearest": 0, "sdg_fused_cost": 0,
          "bilinear_sample": 0, "row_gather_lerp": 0, "row_gather_affine": 0,
          "permute2d": 0, "exact_window_cost": 0, "exact_warp_coords": 0,
          "bilinear_sample_tiled": 0}
bytes_moved = {"row_gather_affine": 0}

_libs: dict[str, ctypes.CDLL] = {}
_entries: dict = {}
_lock = threading.Lock()
build_log: dict[str, str] = {}


def reset_counts() -> None:
    for d in (counts, bytes_moved):
        for k in d:
            d[k] = 0


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def flags(name: str) -> list[str]:
    """The nvcc flags of kernel library `name`."""
    return NVCC_FLAGS + SOURCE_FLAGS[name]


def nvcc_command(name: str, out, nvcc: str = "nvcc") -> list[str]:
    """The whole nvcc command that builds library `name` into `out`."""
    return [nvcc, *flags(name), "-o", str(out), str(CSRC / SOURCES[name])]


def _target(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    h = hashlib.sha1(src + " ".join(flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named kernel libraries (all by default) that are not yet
    built, one nvcc process per source, all started together.  Returns
    {name: seconds} for the libraries compiled by this call."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _target(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = nvcc_command(n, tmp, nvcc)
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    secs = {}
    errors = []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        secs[n] = time.perf_counter() - t0
        build_log[n] = log
        if p.returncode != 0:
            errors.append(f"{n}: nvcc exit {p.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def entry(symbol: str):
    """C entry `symbol` of its library (ENTRIES), typed, bound once."""
    fn = _entries.get(symbol)
    if fn is None:
        lib, argtypes = ENTRIES[symbol]
        fn = getattr(library(lib), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[symbol] = fn
    return fn


def launch(what: str, symbol: str, *args, also: str | None = None) -> None:
    """Run C entry `symbol` on `args`, raise if it returned a non-zero
    cudaGetLastError(), and add one to counts[what] (and to counts[also],
    a route's own count, where given)."""
    rc = entry(symbol)(*args)
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
    counts[what] += 1
    if also is not None:
        counts[also] += 1


def check_args(what: str, named, ints=()) -> None:
    """Refuse a kernel's tensor argument by name: float32 (int32 for the
    names in `ints`; TypeError), contiguous, and on the first argument's
    CUDA device (ValueError)."""
    import torch
    for name, t in named:
        want = torch.int32 if name in ints else torch.float32
        if t.dtype != want:
            raise TypeError(f"{what}: {name} must be {want}, got {t.dtype}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    first, dev = named[0][0], named[0][1].device
    for name, t in named:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: {name} must be on the {first}'s CUDA "
                             f"device, got {t.device}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
