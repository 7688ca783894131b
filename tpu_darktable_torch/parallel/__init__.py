"""Sharding over several devices: device meshes, batch (camera) sharding,
row-band sharding of one frame, and both on a 2-D mesh (counterpart of
tpu_darktable/parallel/).

A single controller drives every shard (mesh.py says why not
torch.distributed).  The sharded programs run the unsharded program's own
stages and reduce its statistics from the gathered samples of all shards,
so batch sharding is bit-equal to it, and row bands equal it within one
uint8 count.
"""

from .mesh import Mesh, make_grid_mesh, make_mesh, shard_batch, sharded_pipeline
from .spatial import spatial_shard_map_demosaic
from .spatial_pipeline import build_grid_pipeline_fn, build_spatial_pipeline_fn

__all__ = ['build_grid_pipeline_fn', 'build_spatial_pipeline_fn', 'make_grid_mesh',
           'make_mesh', 'shard_batch', 'sharded_pipeline', 'spatial_shard_map_demosaic']
