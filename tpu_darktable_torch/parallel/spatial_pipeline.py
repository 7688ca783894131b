"""The FULL pipeline on row bands of a frame, alone or with camera sharding
on a 2-D mesh (counterpart of tpu_darktable/parallel/spatial_pipeline.py).

Single-frame latency scaling for the whole chain: every local stage
(decode, WB, demosaic, colour smoothing, Wiener, bilateral, tonemap) has an
influence radius of at most ~64 px (RCD's border ladder 32, the Wiener tile
and stride, the bilateral grid's reach), so each shard computes its band on
a clamped halo window of the frame (see spatial.py), with the stages of the
unsharded program (build_pipeline_fn(..., rcd_strict_alias=False).stages).
The global quantities cross the shards explicitly:

- image bounds and metrics: every block's stride-8 samples of its own rows
  are gathered in frame order on the first shard's device and reduced by
  the fused program's own functions.  Band and halo are multiples of 8,
  so the gathered samples are the frame's sample grid, and bounds and
  metrics equal the unsharded program's wherever the blocks' values do;
- the green-equilibration ratio: the sum of the bands' G1 and G2 sums,
  in band order (JAX's psum; it can move isolated outputs by one count);
- the local Laplacian, whose reach spans the frame: the core-band
  luminances are concatenated into the full frame, the full-frame
  Laplacian runs once on each distinct device of the frame's camera
  group, and each block takes its rows of the result.  Exact.

2-D composition (`build_grid_pipeline_fn`): frames shard over the camera
axis, each frame's rows over the band axis; bounds and metrics are
batch-global, the green ratio and the Laplacian per frame.

Compiled stages (JAX compiles the whole band body into one shard_map
program): every step a device runs between the collectives goes through a
`_graph.Graphed` (`run.graphs`), keyed on its inputs' shapes and device:
- 'front': decode + WB + demosaic + colour smoothing, with the green-eq
  sums of the band's rows (its row mask a tensor argument, so the blocks
  of one shape share a capture);
- 'green_eq': the frame's green-eq ratio applied to a block (the summed
  G1 and G2 tensor arguments);
- 'back': normalize + Wiener + bilateral;
- with the local Laplacian, 'lab': a block's LAB and luminance;
  'laplacian': the full-frame Laplacian, once a device; 'lab_modify': a
  block's LAB with its rows of the result (a tensor argument);
- 'tonemap'.
On a card the first block of a shape runs eagerly and captures, the others
replay.  What stays eager is what crosses devices, the counterpart of
JAX's collectives: the gathers of the samples and of the core-band
luminances, the sums of the green-eq sums, the replicas of the state and
the Laplacian, and the bounds and metrics EMA on the first device.  The
sample and band slices are views that those gathers copy.

Alignment (checked, with the JAX package's messages): band and halo
multiples of 8, and an integer bilateral sigma_s dividing both, so the
bilateral grid's cells align with the frame's.  At 4096x3000 that allows
3 or 5 bands (1000 or 600 rows), not 2 or 4.
"""

from __future__ import annotations

import numpy as np
import torch

from .._graph import GraphPool, Graphed
from ..ops import color as _color
from ..ops import postprocess as _postprocess
from ..ops.bayer import BayerPattern, PackedFormat
from ..pipeline.config import ImageProcessingSettings
from ..pipeline.image_processor import build_pipeline_fn, ema_bounds, ema_metrics
from ..pipeline.util import normalize_image
from .mesh import Mesh, gather, put, reduce_sum, replicate
from .spatial import DEFAULT_HALO, band_windows


def _build_banded_pipeline_fn(settings: ImageProcessingSettings, image_size: tuple[int, int],
                              bayer_pattern: BayerPattern, packed_format: PackedFormat,
                              has_white_balance: bool, mesh: Mesh, band_axis: str,
                              camera_axis: str | None, halo: int):
    width, height = image_size
    n = mesh.shape[band_axis]
    if height % n:
        raise ValueError(f'height {height} not divisible by {n} shards')
    band = height // n
    if band % 8 or halo % 8:
        raise ValueError('band and halo must be multiples of 8 (stats alignment)')
    block = band + 2 * halo
    if block > height:
        raise ValueError(f'frame too small to shard {n} ways with halo {halo}')
    if settings.enable_bilateral:
        s_int = int(settings.bil_sigma_spatial)
        if float(settings.bil_sigma_spatial) != s_int or halo % s_int or band % s_int:
            raise ValueError('bilateral sigma_s must be an integer dividing band and halo')
    _, _, windows = band_windows(height, n, halo)
    st = build_pipeline_fn(settings, image_size, bayer_pattern, packed_format,
                           has_white_balance, rcd_strict_alias=False).stages
    row_bytes = (width * 3) // 2

    if camera_axis is None:
        groups = [mesh.axis_devices(band_axis)]
    else:
        axes = (mesh.axis_names.index(camera_axis), mesh.axis_names.index(band_axis))
        groups = [list(g) for g in np.moveaxis(mesh.devices, axes, (0, 1))]
    first = groups[0][0]
    all_devices = [d for g in groups for d in g]

    def front_block(rows, wb, in_band):
        """decode, WB, demosaic of a block; with postprocess also its
        colour smoothing and the green-eq sums of the rows in `in_band`."""
        b = st.demosaic(st.decode(rows, wb))
        if not settings.postprocess:
            return b
        b = _postprocess.color_smoothing(b, settings.color_smoothing_passes)
        return (b, *_postprocess.green_eq_sums(b, bayer_pattern, in_band))

    def green_eq_block(b, s1, s2):
        """the frame's green equilibration of a block."""
        return _postprocess.green_eq_apply(b, bayer_pattern, s1, s2)

    def back_block(b, bounds):
        """normalize, Wiener, bilateral of a block."""
        b = normalize_image(b, bounds)
        if settings.enable_denoise:
            b = st.denoise(b)
        if settings.enable_bilateral:
            b = st.bilateral(b)
        return b

    clipped = settings.enable_denoise or settings.enable_bilateral

    def lab_block(b):
        """a block's LAB and luminance, the Laplacian's input."""
        return st.lab_and_lum(b, input_clipped=clipped)

    pool = GraphPool()
    graphs = {name: Graphed(f, pool=pool) for name, f in (
        ('front', front_block), ('green_eq', green_eq_block), ('back', back_block),
        ('lab', lab_block), ('laplacian', st.laplacian),
        ('lab_modify', _color.lab_modify_luminance), ('tonemap', st.tonemap))}
    in_band = {}   # (band offset, device) -> the block's (block, 1) row mask

    def band_mask(off, d):
        if (off, d) not in in_band:
            r = torch.arange(block, device=d)[:, None]
            in_band[off, d] = (r >= off) & (r < off + band)
        return in_band[off, d]

    def front_frame(rows, group, wb):
        """decode, WB, demosaic, postprocess on the frame's band blocks."""
        fronts = [graphs['front'](put(rows[win:win + block], d), wb[d], band_mask(off, d))
                  for (win, off), d in zip(windows, group)]
        if not settings.postprocess:
            return fronts
        # green equilibration over the frame: sums of the bands' own rows
        s1 = reduce_sum([s for _, s, _ in fronts], group[0])
        s2 = reduce_sum([s for _, _, s in fronts], group[0])
        return [graphs['green_eq'](b, put(s1, d), put(s2, d))
                for (b, _, _), d in zip(fronts, group)]

    def frame_samples(blocks):
        """The frame's stride-8 sample plane from its blocks' own rows."""
        return gather([b[off:off + band:8, ::8] for b, (_, off) in zip(blocks, windows)], first)

    def laplacian_frame(blocks, group):
        split = [graphs['lab'](b) for b in blocks]
        lum = gather([lum[off:off + band] for (_, lum), (_, off) in zip(split, windows)], group[0])
        lap = {d: graphs['laplacian'](full) for d, full in replicate(lum, group).items()}
        return [graphs['lab_modify'](lab, lap[d][win:win + block])
                for (lab, _), (win, _), d in zip(split, windows, group)]

    def back_frame(blocks, group, bounds):
        """normalize, Wiener, bilateral, Laplacian on the frame's blocks."""
        out = [graphs['back'](b, bounds[d]) for b, d in zip(blocks, group)]
        return laplacian_frame(out, group) if settings.enable_laplacian else out

    def run(bytes_batch, wb_gains, bounds_in, metrics_in, alpha):
        if isinstance(bytes_batch, np.ndarray):
            bytes_batch = torch.from_numpy(np.ascontiguousarray(bytes_batch))
        rows = bytes_batch.reshape(-1, height, row_bytes)
        n_frames = rows.shape[0]
        if n_frames % len(groups):
            raise ValueError(f'batch of {n_frames} does not split over {len(groups)} '
                             f'camera groups')
        owner = [groups[f * len(groups) // n_frames] for f in range(n_frames)]
        wb = replicate(wb_gains, all_devices)
        alpha = put(alpha, first)
        blocks = [front_frame(rows[f], owner[f], wb) for f in range(n_frames)]
        bounds = ema_bounds(torch.stack([frame_samples(b) for b in blocks]),
                            put(bounds_in, first), alpha)
        on = replicate(bounds, all_devices)
        blocks = [back_frame(b, owner[f], on) for f, b in enumerate(blocks)]
        metrics = ema_metrics(torch.stack([frame_samples(b) for b in blocks]),
                              put(metrics_in, first), alpha)
        on = replicate(metrics, all_devices)
        out = torch.stack([
            gather([graphs['tonemap'](b, on[d])[off:off + band]
                    for b, (_, off), d in zip(frame, windows, owner[f])], first)
            for f, frame in enumerate(blocks)])
        return out, bounds, metrics

    run.graphs = graphs
    return run


def build_spatial_pipeline_fn(settings: ImageProcessingSettings, image_size: tuple[int, int],
                              bayer_pattern: BayerPattern, packed_format: PackedFormat,
                              has_white_balance: bool, mesh: Mesh, axis_name: str = 'batch',
                              halo: int = DEFAULT_HALO):
    """Single-frame row-band sharding over a 1-D mesh.

    Returns fn(frame_bytes (n_bytes,), wb (3,), bounds (2,), metrics (5,),
    alpha) -> (uint8 (H, W, 3), bounds', metrics'), on the first shard's
    device."""
    run = _build_banded_pipeline_fn(
        settings, image_size, bayer_pattern, packed_format, has_white_balance,
        mesh, band_axis=axis_name, camera_axis=None, halo=halo)

    def spatial(frame_bytes, wb_gains, bounds_in, metrics_in, alpha):
        out, bounds, metrics = run(frame_bytes, wb_gains, bounds_in, metrics_in, alpha)
        return out[0], bounds, metrics

    spatial.graphs = run.graphs
    return spatial


def build_grid_pipeline_fn(settings: ImageProcessingSettings, image_size: tuple[int, int],
                           bayer_pattern: BayerPattern, packed_format: PackedFormat,
                           has_white_balance: bool, mesh: Mesh, camera_axis: str = 'camera',
                           band_axis: str = 'band', halo: int = DEFAULT_HALO):
    """Camera x row-band sharding over a 2-D mesh: frames shard over
    `camera_axis`, each frame's rows over `band_axis` (e.g. a 12-camera rig
    as a (4, 2) mesh, three frames a camera group at half-frame latency).

    Returns fn(bytes_batch (B, n_bytes), wb (3,), bounds (2,), metrics (5,),
    alpha) -> (uint8 (B, H, W, 3), bounds', metrics'), on the first
    shard's device.  B must divide evenly over the camera axis.
    """
    return _build_banded_pipeline_fn(
        settings, image_size, bayer_pattern, packed_format, has_white_balance,
        mesh, band_axis=band_axis, camera_axis=camera_axis, halo=halo)


__all__ = ['DEFAULT_HALO', 'build_grid_pipeline_fn', 'build_spatial_pipeline_fn']
