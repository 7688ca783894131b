"""Device meshes and batch sharding (counterpart of
tpu_darktable/parallel/mesh.py).

The JAX package runs one process that compiles a `shard_map` body for each
device of a `jax.sharding.Mesh`, and XLA inserts the collectives.  PyTorch
has no such layer, and this package does not build one on
`torch.distributed`: NCCL refuses two ranks on one GPU, and spawning a
process a shard inside a test runner's worker processes is slow and
fragile.  It uses a single controller instead:

- a `Mesh` is an array of `torch.device` with axis names;
- a shard's work is a Python function called once a shard, on that shard's
  device.  CUDA launches return at once, so shards on distinct cards run
  at the same time;
- the collectives are explicit functions of the per-shard tensors
  (`gather`, `reduce_sum`, `replicate`), each a copy between devices that
  makes the host wait for no card.

A device may repeat in a mesh: `[torch.device('cpu')] * 8` shards on the
CPU, `[torch.device('cuda')] * k` runs k shards on one card.

Statistics: the fused program reduces the stride-8 sample planes of the
whole batch.  A sharded program gathers every shard's planes in global
order on the first shard's device and reduces them with the same
functions, so batch sharding is bit-equal to the unsharded program.

Compiled stages: where XLA compiles the shard_map body once for every
device, each shard's stage here runs through a `_graph.Graphed` keyed on
its block's shape and device: on a card the first shard of a shape runs
eagerly and captures, every later one (the other shards of that card,
the next batches) replays.  A graph never spans two devices; the
collectives stay eager copies between the graphs.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import to_device
from .._graph import GraphPool, Graphed
from ..pipeline.image_processor import ema_bounds, ema_metrics


def _as_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == 'cuda' and d.index is None:
        d = torch.device('cuda', torch.cuda.current_device())
    return d


class Mesh:
    """Devices on named axes: `.devices` (an object array of torch.device),
    `.axis_names`, `.shape` ({axis: size}) and `.size`."""

    def __init__(self, devices, axis_names):
        flat = [_as_device(d) for d in np.asarray(devices, dtype=object).ravel()]
        shape = np.shape(np.asarray(devices, dtype=object))
        arr = np.empty(len(flat), dtype=object)
        for i, d in enumerate(flat):
            arr[i] = d
        self.devices = arr.reshape(shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f'{len(self.axis_names)} axis names for a {self.devices.ndim}-D '
                             'device array')

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def axis_devices(self, axis_name: str) -> list[torch.device]:
        """The devices along `axis_name`, at index 0 of every other axis."""
        axis = self.axis_names.index(axis_name)
        index = [0] * self.devices.ndim
        index[axis] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self) -> str:
        return f'Mesh({self.shape}, devices={[str(d) for d in self.devices.ravel()]})'


def _cuda_devices() -> list[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError('no CUDA device: pass the devices, e.g. '
                           "[torch.device('cpu')] * 8, to build a mesh on the CPU")
    return [torch.device('cuda', i) for i in range(n)]


def make_mesh(devices=None, axis_name: str = 'batch') -> Mesh:
    """1-D mesh over every CUDA device, or over the given devices."""
    return Mesh(_cuda_devices() if devices is None else list(devices), (axis_name,))


def make_grid_mesh(camera_ways: int, band_ways: int, devices=None,
                   camera_axis: str = 'camera', band_axis: str = 'band') -> Mesh:
    """2-D (camera, band) mesh: frames shard over cameras, each frame's rows
    over bands.  A camera group is `band_ways` adjacent devices."""
    devices = _cuda_devices() if devices is None else list(devices)
    need = camera_ways * band_ways
    if len(devices) < need:
        raise ValueError(f'need {need} devices for a {camera_ways}x{band_ways} '
                         f'mesh, have {len(devices)}')
    grid = np.empty(need, dtype=object)
    for i, d in enumerate(devices[:need]):
        grid[i] = d
    return Mesh(grid.reshape(camera_ways, band_ways), (camera_axis, band_axis))


# ---- the collectives: copies between the shards' devices ----

def put(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`t` on `device`: itself where it is there already, else a copy that
    makes the host wait for no card (host memory goes through pinned
    memory)."""
    if t.device == device:
        return t
    if t.is_cuda and device.type == 'cuda':
        return t.to(device, non_blocking=True)
    return to_device(t, device)


def replicate(t: torch.Tensor, devices) -> dict[torch.device, torch.Tensor]:
    """`t` on each distinct device of `devices`."""
    return {d: put(t, d) for d in dict.fromkeys(devices)}


def gather(tensors, device: torch.device, dim: int = 0) -> torch.Tensor:
    """The shards' tensors concatenated along `dim` on `device`, in order."""
    if len(tensors) == 1:
        return put(tensors[0], device)
    return torch.cat([put(t, device) for t in tensors], dim=dim)


def reduce_sum(tensors, device: torch.device) -> torch.Tensor:
    """The shards' tensors summed in shard order on `device`."""
    total = put(tensors[0], device)
    for t in tensors[1:]:
        total = total + put(t, device)
    return total


def shard_batch(array, mesh: Mesh, axis_name: str = 'batch') -> list[torch.Tensor]:
    """Split a batch-leading array (or tensor) into equal chunks along its
    leading axis, one for each device on `axis_name`, each on its device,
    in mesh order.  A chunk already on its device is a view."""
    devices = mesh.axis_devices(axis_name)
    if isinstance(array, np.ndarray):
        array = torch.from_numpy(np.ascontiguousarray(array))
    if array.shape[0] % len(devices):
        raise ValueError(f'batch of {array.shape[0]} does not split over {len(devices)} '
                         f'shards of axis {axis_name!r}')
    return [put(chunk, d) for chunk, d in zip(torch.chunk(array, len(devices)), devices)]


def sharded_pipeline(fused_fn, mesh: Mesh, axis_name: str = 'batch'):
    """The fused pipeline with its batch split over `axis_name`.

    `fused_fn` is a build_pipeline_fn result: (bytes, wb, bounds, metrics,
    alpha) -> (u8, bounds', metrics').  The returned callable has that
    signature; it takes the batch whole or as shard_batch's chunks.  Each
    shard runs the fused program's stages on its device; the bounds and
    metrics reduce the gathered samples of all shards; the uint8 frames
    and the state come back on the first shard's device.
    """
    return _sharded_pipeline(fused_fn, mesh, axis_name, None)


def _sharded_pipeline(fused_fn, mesh: Mesh, axis_name: str, pool: GraphPool | None):
    """sharded_pipeline with its stages' graphs on `pool` (a new pool if
    None): ImageProcessor(mesh=...) gives its own."""
    stages = getattr(fused_fn, 'stages', None)
    if stages is None:
        raise TypeError('sharded_pipeline takes a build_pipeline_fn result')
    devices = mesh.axis_devices(axis_name)
    first = devices[0]
    pool = GraphPool() if pool is None else pool
    front, back, tonemap = (Graphed(f, pool=pool) for f in (stages.front, stages.back,
                                                            stages.tonemap))

    def run(bytes_batch, wb_gains, bounds_in, metrics_in, alpha):
        shards = (list(bytes_batch) if isinstance(bytes_batch, (list, tuple))
                  else shard_batch(bytes_batch, mesh, axis_name))
        wb = replicate(wb_gains, devices)
        alpha = put(alpha, first)
        fronts = [front(x, wb[d]) for x, d in zip(shards, devices)]
        bounds = ema_bounds(gather([s for _, s in fronts], first), put(bounds_in, first), alpha)
        on = replicate(bounds, devices)
        backs = [back(rgb, s, on[d]) for (rgb, s), d in zip(fronts, devices)]
        del fronts
        metrics = ema_metrics(gather([s for _, s in backs], first), put(metrics_in, first), alpha)
        on = replicate(metrics, devices)
        out = gather([tonemap(rgb, on[d]) for (rgb, _), d in zip(backs, devices)], first)
        return out, bounds, metrics

    run.graphs = (front, back, tonemap)
    return run


__all__ = ['Mesh', 'make_grid_mesh', 'make_mesh', 'shard_batch', 'sharded_pipeline']
