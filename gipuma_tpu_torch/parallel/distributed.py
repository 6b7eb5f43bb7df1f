"""Multi-process orchestration: torch.distributed init + scan distribution.

Counterpart of ``gipuma_tpu/parallel/distributed.py:33-103``.  The
reference distributes a scan by shell loop and filesystem
(scripts/dino.sh:28-51); finished views persist on disk.  Here:

* :func:`init_distributed` — ``torch.distributed.init_process_group`` from
  the variables ``torchrun`` sets (RANK, WORLD_SIZE, LOCAL_RANK,
  MASTER_ADDR, MASTER_PORT) or explicit arguments; reuses a group that is
  already initialised; a no-op for one process.  NCCL on the card (one
  card per rank), gloo on the CPU; several ranks on one card need
  ``backend="gloo"`` from the caller (NCCL refuses a device twice).
* :func:`rank_device` — this rank's device: ``cuda:{LOCAL_RANK % cards}``,
  or the CPU when the caller asks for it.
* :func:`owned_jobs` — the contiguous block of reference views a process
  owns (the job axis across processes).
* :func:`run_batch_distributed` — each process runs its block through
  ``pipeline.run_batch`` with ``skip_existing=True`` on a shared results
  directory, so a restarted process resumes where the files say the scan
  stopped.
"""
from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.distributed as dist


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def init_distributed(backend: str | None = None,
                     init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     device=None) -> tuple[int, int]:
    """Initialise torch.distributed when running multi-process; returns
    (rank, world_size).

    Arguments default to torchrun's variables (RANK, WORLD_SIZE; the
    rendezvous at MASTER_ADDR:MASTER_PORT through ``env://``).  A group
    that is already initialised is reused as it is.  One process (no
    WORLD_SIZE, or 1) initialises nothing.  backend None picks NCCL when
    `device` is the card (the default) and gloo on the CPU; NCCL with more
    ranks on this host (LOCAL_WORLD_SIZE) than cards raises."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world_size = world_size if world_size is not None else _env_int(
        "WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if (world_size or 1) <= 1 and init_method is None:
        return 0, 1
    if rank is None:
        raise ValueError("init_distributed: WORLD_SIZE > 1 but no RANK "
                         "(launch with torchrun or pass rank=)")
    if init_method is None:
        missing = [v for v in ("MASTER_ADDR", "MASTER_PORT")
                   if not os.environ.get(v)]
        if missing:
            raise ValueError(f"init_distributed: {', '.join(missing)} unset "
                             "(launch with torchrun or pass init_method=)")
        init_method = "env://"
    dev_type = torch.device(device).type if device is not None else "cuda"
    if backend is None:
        backend = "nccl" if dev_type == "cuda" else "gloo"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: NCCL needs CUDA, and none "
                               "is available")
        local = _env_int("LOCAL_WORLD_SIZE") or world_size
        if local > torch.cuda.device_count():
            raise RuntimeError(
                f"init_distributed: {local} ranks on this host but "
                f"{torch.cuda.device_count()} card(s); NCCL takes one card "
                "per rank (pass backend='gloo' to share a card)")
        torch.cuda.set_device(rank_device(device, rank=rank))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dist.get_rank(), dist.get_world_size()


def rank_device(device=None, rank: int | None = None) -> torch.device:
    """This rank's device: the CPU when `device` asks for it, else the card
    ``cuda:{local rank % cards}`` (LOCAL_RANK, else the global rank)."""
    from ..pipeline import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is not None:
        return dev
    local = _env_int("LOCAL_RANK")
    if local is None:
        local = rank if rank is not None else (
            dist.get_rank() if dist.is_initialized() else 0)
    return torch.device("cuda", local % torch.cuda.device_count())


def owned_jobs(n_jobs: int, process_index: int | None = None,
               process_count: int | None = None) -> list[int]:
    """The contiguous block of job indices this process owns: balanced to
    within one job, the first n_jobs % P blocks one larger; disjoint and
    complete over all processes."""
    if process_index is None or process_count is None:
        initialised = dist.is_available() and dist.is_initialized()
        if process_index is None:
            process_index = dist.get_rank() if initialised else 0
        if process_count is None:
            process_count = dist.get_world_size() if initialised else 1
    base, extra = divmod(n_jobs, process_count)
    start = process_index * base + min(process_index, extra)
    size = base + (1 if process_index < extra else 0)
    return list(range(start, start + size))


def run_batch_distributed(image_paths: Sequence[str], params,
                          results_root, *,
                          ref_indices: Sequence[int] | None = None,
                          process_index: int | None = None,
                          process_count: int | None = None,
                          **run_batch_kwargs):
    """Run this process's block of a multi-view scan.

    Every process calls this with identical arguments; each runs only its
    :func:`owned_jobs` block and writes to the shared ``results_root``.
    ``skip_existing`` is forced on, so a re-run after any failure (or with
    another process count) completes exactly the missing views.  Returns
    this process's list of RunResults."""
    from ..pipeline import run_batch

    all_refs = list(ref_indices if ref_indices is not None
                    else range(len(image_paths)))
    mine = [all_refs[i] for i in owned_jobs(
        len(all_refs), process_index, process_count)]
    run_batch_kwargs["skip_existing"] = True
    return run_batch(image_paths, params, results_root,
                     ref_indices=mine, **run_batch_kwargs)
