"""The (job, tile, view) mesh over torch.distributed ranks.

Counterpart of ``gipuma_tpu/parallel/mesh.py:22-44``.  The JAX package runs
a ``shard_map`` over the devices of one process; the port runs one process
per rank (SPMD) and gives each mesh axis its own process group:

* ``job``  — independent depth-map jobs (reference views), no
  communication;
* ``tile`` — row bands of one reference image, neighbour exchanges of the
  plane rows at the band edges (parallel/tiled.py, parallel/tiled_rect.py);
* ``view`` — the source-view axis of the multiview cost, one all-gather of
  the per-view costs per evaluation (parallel/sharded.py).

``mesh_shape`` factors a world exactly as the JAX ``make_mesh`` factors its
devices; ``make_mesh`` builds the ``DeviceMesh`` over the initialised world
and ``axis`` gives one axis's handle (its group, size, this rank's index on
it, and the collectives the parallel layer uses).

Transport.  NCCL takes CUDA tensors; gloo (the CPU backend, and the one-card
setting where several ranks share a card) takes host tensors for every
collective this layer runs.  ``Axis._transport`` is the one place that
decides: under gloo a CUDA tensor goes through a host copy, and the copy is
counted in ``stats`` (``host_copies``, ``host_copy_bytes``).  The choice
depends only on the backend and the tensor's device; no collective is
retried on another transport.  The seconds the collectives take are read
from a profiled run (parallel/launch.run_tasks), not timed here.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# Per-process collective statistics since the last reset_stats(): calls,
# bytes sent into collectives, and the host copies gloo needed.
stats = {"calls": 0, "bytes": 0, "host_copies": 0, "host_copy_bytes": 0}


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0


def mesh_shape(n: int, view_shards: int | None = None,
               max_view_shards: int = 4, tile_shards: int = 1
               ) -> tuple[int, int, int]:
    """(job, tile, view) sizes for n ranks: the view axis gets the largest
    divisor of n // tile_shards that is at most `max_view_shards` (unless
    given), the tile axis `tile_shards`, the job axis the rest."""
    if n % tile_shards:
        raise ValueError(f"{n} ranks do not split into {tile_shards} tiles")
    nv_budget = n // tile_shards
    if view_shards is None:
        view_shards = max(d for d in
                          range(1, min(max_view_shards, nv_budget) + 1)
                          if nv_budget % d == 0)
    if nv_budget % view_shards:
        raise ValueError(f"{nv_budget} ranks per tile do not split into "
                         f"{view_shards} view shards")
    return nv_budget // view_shards, tile_shards, view_shards


def make_mesh(n_devices: int | None = None, view_shards: int | None = None,
              max_view_shards: int = 4, tile_shards: int = 1):
    """A DeviceMesh over the initialised world with dims ("job", "tile",
    "view"), factored by `mesh_shape`.  n_devices must equal the world
    size (every rank of the world is one mesh position)."""
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"mesh of {n} ranks asked for in a world of {world}")
    shape = mesh_shape(n, view_shards, max_view_shards, tile_shards)
    # The mesh's device type only names where DTensors would live; the
    # groups take the world's backend either way.
    dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(dev_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=("job", "tile", "view"))


class Axis:
    """One mesh axis as seen from this rank: its process group (None for a
    one-rank axis or no distributed world), its size, this rank's index on
    it and the global ranks of its members, in axis order."""

    def __init__(self, group=None):
        self.group = group
        if group is None:
            self.size, self.index, self.ranks = 1, 0, [0]
            self.backend = None
        else:
            self.ranks = dist.get_process_group_ranks(group)
            self.size = len(self.ranks)
            self.index = self.ranks.index(dist.get_rank())
            self.backend = str(dist.get_backend(group))

    def _transport(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor a collective of this axis's backend takes for `t`:
        `t` itself, or under gloo a host copy of a CUDA tensor (counted)."""
        t = t.contiguous()
        if self.backend == "gloo" and t.is_cuda:
            stats["host_copies"] += 1
            stats["host_copy_bytes"] += t.numel() * t.element_size()
            return t.cpu()
        return t

    def _back(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """A collective's result on `like`'s device (a counted copy back
        from the host under gloo)."""
        if t.device != like.device:
            stats["host_copies"] += 1
            stats["host_copy_bytes"] += t.numel() * t.element_size()
            return t.to(like.device)
        return t

    @staticmethod
    def _count(nbytes: int) -> None:
        stats["calls"] += 1
        stats["bytes"] += nbytes

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Concatenate every member's `t` along dim 0, in axis order (the
        JAX package's ``all_gather(..., axis=0, tiled=True)``)."""
        if self.size == 1:
            return t
        self._count(t.numel() * t.element_size())
        x = self._transport(t)
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return self._back(torch.cat(parts, dim=0), t)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every member's `t` (``psum``), as a new tensor."""
        if self.size == 1:
            return t
        self._count(t.numel() * t.element_size())
        x = self._transport(t)
        x = x.clone() if x is t else x
        dist.all_reduce(x, group=self.group)
        return self._back(x, t)

    def neighbour_exchange(self, to_prev: torch.Tensor,
                           to_next: torch.Tensor):
        """Send `to_prev` to the member before this one and `to_next` to the
        one after; returns (from_prev, from_next), each None at the ends of
        the axis (the ``ppermute`` pairs of the JAX package's halo
        exchanges)."""
        if self.size == 1:
            return None, None
        sends = [(side, self.ranks[peer], t) for side, peer, t in
                 (("prev", self.index - 1, to_prev),
                  ("next", self.index + 1, to_next))
                 if 0 <= peer < self.size]
        self._count(sum(t.numel() * t.element_size() for _, _, t in sends))
        ops, recv = [], {}
        for side, peer, t in sends:
            x = self._transport(t)
            recv[side] = (torch.empty_like(x), t)
            ops.append(dist.P2POp(dist.isend, x, peer, group=self.group))
            ops.append(dist.P2POp(dist.irecv, recv[side][0], peer,
                                  group=self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return tuple(self._back(*recv[side]) if side in recv else None
                     for side in ("prev", "next"))


def axis(mesh, name: str) -> Axis:
    """The handle of mesh axis `name` for this rank (mesh None: a one-rank
    axis with no process group)."""
    if mesh is None or mesh.shape[mesh.mesh_dim_names.index(name)] == 1:
        return Axis(None)
    return Axis(mesh.get_group(name))
