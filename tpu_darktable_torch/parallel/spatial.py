"""Row-band sharding of one frame's demosaic (counterpart of
tpu_darktable/parallel/spatial.py).

One frame is split into row bands over a mesh axis, and each shard
demosaics its band on a clamped halo window of the frame:

    window = clip(band_start - halo, 0, H - block)   block = band + 2*halo

A window clamped at the true image edge coincides with the real border, so
RCD's border ladder runs where it should; everywhere else the window's own
edge effects (the border ladder reaches 32 px, the stencils 8) fall
outside the band.  RCD runs with strict_alias=False, which makes the block
decomposition exact.  The band geometry is a Python int for each shard.

Every window is one block high, so on a card the bands' demosaics share
one CUDA graph a block shape, device, pattern and algorithm
(`_graph.Graphed`): the first band runs eagerly and captures, the others
replay.  The band slices and the gather stay outside the graph.
"""

from __future__ import annotations

import numpy as np
import torch

from .._graph import Graphed
from ..ops import demosaic as _demosaic
from ..ops import rcd as _rcd
from ..ops.bayer import BayerPattern
from .mesh import Mesh, gather, put

# Influence radius: border-green ring (32) + stencil reach, rounded up.
DEFAULT_HALO = 64


def band_windows(height: int, n: int, halo: int) -> tuple[int, int, list[tuple[int, int]]]:
    """(band, block, [(window start, band offset in the block)] for each of
    n shards) of a frame `height` rows high."""
    band = height // n
    block = band + 2 * halo
    windows = []
    for i in range(n):
        win = min(max(i * band - halo, 0), height - block)
        windows.append((win, i * band - win))
    return band, block, windows


def spatial_shard_map_demosaic(bayer, mesh: Mesh, pattern: BayerPattern, algorithm: str = 'rcd',
                               halo: int = DEFAULT_HALO, axis_name: str = 'batch'):
    """Demosaic one (H, W) frame with rows sharded over `axis_name`.

    Returns the (H, W, 3) result on the first shard's device.  Matches the
    unsharded op exactly (RCD compared against strict_alias=False).
    """
    if isinstance(bayer, np.ndarray):
        bayer = torch.from_numpy(np.ascontiguousarray(bayer))
    if bayer.ndim == 3:
        bayer = bayer[..., 0]
    h, w = bayer.shape
    n = mesh.shape[axis_name]
    if h % n:
        raise ValueError(f'height {h} not divisible by {n} shards')
    band = h // n
    if band % 2:
        raise ValueError(f'band height {band} must be even (Bayer alignment)')
    halo = (halo + 1) // 2 * 2  # even halo keeps CFA phase
    devices = mesh.axis_devices(axis_name)
    band, block, windows = band_windows(h, n, halo)
    if block > h:
        # The reference's own rule: a frame too small to shard runs unsharded.
        return _demosaic_block(put(bayer, devices[0]), pattern, algorithm)
    outs = [_demosaic_block(put(bayer[win:win + block], d), pattern, algorithm)[off:off + band]
            for (win, off), d in zip(windows, devices)]
    return gather(outs, devices[0])


def _demosaic_one(bayer, pattern: BayerPattern, algorithm: str):
    if algorithm == 'rcd':
        return _rcd.rcd_demosaic(bayer, pattern, strict_alias=False)
    if algorithm == 'ppg':
        return _demosaic.ppg_demosaic(bayer, pattern)
    if algorithm == 'bilinear':
        return _demosaic.bilinear5x5_demosaic(bayer, pattern)
    raise ValueError(f'unknown algorithm: {algorithm}')


# the band demosaic's captures, keyed on the block, pattern and algorithm
_demosaic_block = Graphed(_demosaic_one)


__all__ = ['DEFAULT_HALO', 'spatial_shard_map_demosaic']
