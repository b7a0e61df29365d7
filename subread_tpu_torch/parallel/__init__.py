"""Parallel layer: device meshes and sharded alignment steps, on torch
devices (port of `subread_tpu/parallel`).

The reference's only parallelism is single-node pthreads (SURVEY.md §1);
this layer maps those axes onto devices: data-parallel read batches
across devices (the thread-pool analog), a replicated or position-sharded
index (the index-block serialization analog), with gathers onto the first
device and torch.distributed collectives doing the merges that the
reference does at thread barriers.
"""

from .mesh import make_mesh, shard_batch, sharded_align_step

__all__ = ["make_mesh", "shard_batch", "sharded_align_step"]
