"""Build and load the port's hand-written CUDA kernels; count launches.

Each source under ``csrc/`` is compiled by ``nvcc`` into its own shared
library with a plain C interface (``-gencode arch=compute_90a,code=sm_90a``)
and loaded with ``ctypes``.  Builds run at first use, all sources in
parallel, into ``build/`` beside this file; a library is rebuilt only when
its source or flags change (the file name carries their hash).  The flags
are ``NVCC_FLAGS`` and the source's own ``SOURCE_FLAGS`` (``nvcc_command``
gives the whole command).

``counts`` holds one plain integer per kernel: a wrapper adds one exactly
where it launches its kernel.  ``bytes_moved`` sums, per launch, the bytes
a launch must move (each input read once, each output written once) for
the kernels whose wrappers count them (the affine gather).
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
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Per-source flags.  The gathers and the sampler are held bit-equal to
# their plain versions, which round every product and sum on its own, so
# they are built without FMA contraction.  The fused cost is held to 1e-3:
# it rounds its sample positions explicitly (__fmul_rn / __fadd_rn) and
# lets the rest of its arithmetic contract.
SOURCE_FLAGS = {
    "rowgather": ["-fmad=false"],
    "sdg_fused": ["-fmad=true"],
    "sampling": ["-fmad=false"],
    "rowgather_lerp": ["-fmad=false"],
    "rowgather_affine": ["-fmad=false"],
    "permute2d": ["-fmad=false"],
}

counts = {"row_gather_nearest": 0, "sdg_fused_cost": 0,
          "bilinear_sample": 0, "row_gather_lerp": 0, "row_gather_affine": 0,
          "permute2d": 0}
bytes_moved = {"row_gather_affine": 0}

_libs: dict[str, ctypes.CDLL] = {}
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


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a non-zero cudaGetLastError()."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
