"""Faults the folder driver's tests plant in a run (the driver's ``hook``):
each function is called as fn(rank, argv) in every rank before the scans,
with the command line's flags in `argv`, and plants its fault in every
rank or, where its name says so, in one."""
import os


def num_consistent_2(rank, argv):
    """Fusion asks 2 agreeing views where the configuration states 3."""
    argv += ["--num_consistent", "2"]


def dmb_deleted(rank, argv):
    """One view's disp.dmb is gone after the program wrote it."""
    from gipuma_tpu_torch import pipeline
    orig = pipeline.write_outputs

    def write(result, out_dir, *a, **k):
        orig(result, out_dir, *a, **k)
        if result.ref_name.startswith("view001"):
            os.remove(os.path.join(out_dir, "disp.dmb"))
    pipeline.write_outputs = write


def depths_bf16_before_fusion(rank, argv):
    """Fusion reads depths rounded to bfloat16."""
    import numpy as np
    import torch
    from gipuma_tpu_torch.fusion import sharded
    orig = sharded.fuse_depthmaps_sharded

    def fuse(depths, *a, **k):
        d = torch.as_tensor(np.asarray(depths, np.float32))
        return orig(d.to(torch.bfloat16).to(torch.float32).numpy(), *a, **k)
    sharded.fuse_depthmaps_sharded = fuse


def exchange_left_out(rank, argv):
    """Fusion's all-reduces between the ranks return this rank's part."""
    from gipuma_tpu_torch.parallel import mesh
    mesh.Axis.all_reduce = lambda self, t: t


def state_unchanged(rank, argv):
    """A PatchMatch iteration returns its state unchanged."""
    from gipuma_tpu_torch.models import patchmatch
    patchmatch.iteration = lambda state, *a, **k: state


def depth_altered(rank, argv):
    """Every depth map is 10% off where it is produced."""
    from gipuma_tpu_torch import pipeline
    orig = pipeline.run_prepared_job

    def altered(job):
        res = orig(job)
        res.depth = res.depth * 1.1
        return res
    pipeline.run_prepared_job = altered


def state_unchanged_on_rank_1(rank, argv):
    """Rank 1's PatchMatch iterations return their state unchanged; the
    other ranks' views are sound."""
    if rank == 1:
        state_unchanged(rank, argv)


def depth_altered_on_rank_1(rank, argv):
    """Rank 1's depth maps are 10% off; the other ranks' are sound."""
    if rank == 1:
        depth_altered(rank, argv)


def half_the_views(rank, argv):
    """Each rank runs half of its block of reference views."""
    from gipuma_tpu_torch.parallel import distributed
    orig = distributed.owned_jobs

    def half(*a, **k):
        mine = orig(*a, **k)
        return mine[:max(1, len(mine) // 2)]
    distributed.owned_jobs = half


def rank_dies(rank, argv):
    """Rank 1 exits in the middle of the scan, the others wait for it."""
    if rank != 1:
        return
    from gipuma_tpu_torch import pipeline

    def die(*a, **k):
        os._exit(3)
    pipeline.write_outputs = die


def rank_hangs(rank, argv):
    """Rank 1 never finishes its views."""
    if rank != 1:
        return
    import time
    from gipuma_tpu_torch import pipeline

    def hang(*a, **k):
        time.sleep(3600)
    pipeline.write_outputs = hang
