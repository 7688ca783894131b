"""The pipeline orchestrator (counterpart of
tpu_darktable/pipeline/image_processor.py:55-549).

    decode12 -> WB -> demosaic -> postprocess -> bounds/EMA -> normalize ->
    Wiener(log LAB-L) -> bilateral -> local Laplacian -> metrics/EMA ->
    tonemap -> uint8

The per-frame stages run as two Python loops over the batch, split by the
batch-global bounds EMA, one frame at a time so that live memory stays one
frame deep.  The EMA state (bounds (2,), metrics (5,)) stays on the device
between batches: there is no host sync on the path.  On the card the
batched program is captured as a CUDA graph on its first call for each
input shape and replayed after (_graph.py, where JAX writes
jax.jit(fused)); on the CPU it runs eagerly.  The workspaces' graphs and
the batched program's share one memory pool a processor.

The fused program's stages (PipelineStages, `fn.stages`) are what the
sharded programs of parallel/ run on each shard, so they compute what it
computes; `ImageProcessor(mesh=...)` splits its batches over a mesh.

The piecewise methods (load_bytes / debayer / process_rgb / tonemap) run
the same stages one call at a time through the per-op workspace classes
(each a graph per input shape on the card, as JAX jits them), with the
caller carrying bounds and metrics; the viewer drives them.  A settings
change keeps each workspace whose arguments it leaves as they were, so its
graphs survive the viewer's slider steps.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device, to_device
from .._graph import GraphPool, Graphed
from ..debayer import PPG, RCD, PostProcess
from ..denoise import Wiener
from ..local_contrast import Bilateral
from ..ops import bilateral as _bilateral
from ..ops import color as _color
from ..ops import demosaic as _demosaic
from ..ops import laplacian as _laplacian
from ..ops import packed as _packed
from ..ops import postprocess as _postprocess
from ..ops import rcd as _rcd
from ..ops import tonemap as _tonemap
from ..ops import white_balance as _wb
from ..ops import wiener as _wiener
from ..ops.bayer import BayerPattern, PackedFormat
from ..utils import timing
from .camera_settings import CameraSettings
from .config import Debayer, ImageProcessingSettings, ToneMapper
from .transform import ImageTransform, transform
from .util import lerp, normalize_image, resize_longest_edge


class ImageSizeMismatchError(Exception):
    """Raised when the byte count does not match the camera geometry."""

    def __init__(self, message, image_size, packed_format, padding):
        super().__init__(message)
        self.image_size = image_size
        self.packed_format = packed_format
        self.padding = padding


def _laplacian_params(settings: ImageProcessingSettings) -> _laplacian.LaplacianParams:
    return _laplacian.LaplacianParams(sigma=settings.lap_sigma, shadows=settings.lap_shadows,
                                      highlights=settings.lap_highlights,
                                      clarity=settings.lap_clarity)


def _tonemap_dispatch(settings: ImageProcessingSettings, rgb, metrics):
    params = _tonemap.TonemapParameters(settings.tone_gamma, settings.tone_intensity,
                                        settings.light_adapt, settings.vibrance)
    match settings.tone_mapping:
        case ToneMapper.reinhard:
            return _tonemap.reinhard_tonemap(rgb, metrics, params)
        case ToneMapper.linear:
            return _tonemap.linear_tonemap(rgb, metrics, params)
        case ToneMapper.aces:
            return _tonemap.aces_tonemap(rgb, params)
        case ToneMapper.adaptive_aces:
            return _tonemap.aces_tonemap(rgb, params, metrics)
        case ToneMapper.filmic:
            return _tonemap.filmic_tonemap(rgb, params, metrics)
    raise AssertionError(f'Invalid tone mapping: {settings.tone_mapping}')


@dataclass(frozen=True)
class PipelineStages:
    """The stages of one build_pipeline_fn result, which its fused program
    runs and the sharded programs of parallel/ reuse, so that those cannot
    drift from it.  Per frame: `decode` (packed rows, wb) -> mosaic with
    white balance; `demosaic`; `front` = both, then postprocess, over a
    (B, n_bytes) batch -> (rgb (B, H, W, 3), samples); `sample` = the
    stride-8 planes of a (B, H, W, 3) batch, stacked; `back` (rgb, samples,
    bounds) = normalize, Wiener, bilateral, Laplacian -> (rgb, samples);
    `denoise`, `bilateral` its per-frame luminance stages, `lab_and_lum`
    their LAB split and `laplacian` (L -> L') the local Laplacian's
    luminance map; `tonemap` (rgb, metrics) -> uint8."""

    decode: Callable
    demosaic: Callable
    front: Callable
    sample: Callable
    back: Callable
    denoise: Callable
    bilateral: Callable
    lab_and_lum: Callable
    laplacian: Callable
    tonemap: Callable


def ema_bounds(samples, bounds_in, alpha):
    """The bounds EMA from the stacked sample planes of a batch."""
    return lerp(bounds_in, _tonemap.compute_image_bounds(samples, stride=1), alpha)


def ema_metrics(samples, metrics_in, alpha):
    """The metrics EMA from the stacked sample planes of a batch."""
    return lerp(metrics_in, _tonemap.compute_image_metrics(samples, stride=1), alpha)


def build_pipeline_fn(settings: ImageProcessingSettings, image_size: tuple[int, int],
                      bayer_pattern: BayerPattern, packed_format: PackedFormat,
                      has_white_balance: bool, rcd_strict_alias: bool = True):
    """Build the batched pipeline.

    Returns fn(bytes_batch (B, n_bytes) uint8, wb (3,), bounds (2,),
    metrics (5,), alpha 0-d) -> (uint8 (B, H, W, 3), bounds', metrics'),
    all tensors on one device; its stages are `fn.stages`
    (PipelineStages).  `rcd_strict_alias=False` drops RCD's half-grid stale
    reads, which makes the demosaic exact on row bands (parallel/).
    """
    width, height = image_size
    ids = packed_format is PackedFormat.Packed12_IDS
    has_back = settings.enable_denoise or settings.enable_bilateral or settings.enable_laplacian

    def sample(rgb):
        return torch.stack([rgb[i, ::8, ::8] for i in range(rgb.shape[0])])

    def decode(frame_rows, wb_gains):
        bayer = _packed.decode12_float(frame_rows, ids_format=ids)
        if has_white_balance:
            bayer = _wb.apply_white_balance(bayer, wb_gains, bayer_pattern)
        return bayer

    def demosaic(bayer):
        if settings.debayer == Debayer.bilinear:
            return _demosaic.bilinear5x5_demosaic(bayer, bayer_pattern)
        if settings.debayer == Debayer.rcd:
            return _rcd.rcd_demosaic(bayer, bayer_pattern, strict_alias=rcd_strict_alias)
        if settings.debayer == Debayer.ppg:
            return _demosaic.ppg_demosaic(bayer, bayer_pattern,
                                          median_threshold=settings.ppg_median_threshold)
        raise AssertionError(f'Invalid debayer method: {settings.debayer}')

    def _front_one(frame_rows, wb_gains):
        bayer = decode(frame_rows, wb_gains)
        timing.mark('decode')
        rgb = demosaic(bayer)
        timing.mark('demosaic')
        if settings.postprocess:
            rgb = _postprocess.postprocess(
                rgb, bayer_pattern, color_smoothing_passes=settings.color_smoothing_passes,
                green_eq_local_enabled=False, green_eq_global_enabled=True,
                green_eq_threshold=settings.green_eq_threshold)
            timing.mark('postprocess')
        return rgb

    # Each luminance stage extracts LAB L and writes it back.  When the
    # stage input is known to be clipped (it came out of a preceding
    # lab_modify_luminance, which ends in clip01) the unclipped LAB serves
    # both sides; otherwise the clipped L shares the sRGB decode.
    def lab_and_lum(rgb, input_clipped: bool):
        if input_clipped:
            return _color.rgb_to_lab_with_l(rgb)
        return _color.rgb_to_lab_with_clipped_l(rgb)

    def denoise(rgb):
        eps = 1e-4
        lab, lum = _color.rgb_to_lab_with_clipped_l(rgb)  # normalize output: not clipped
        log_lum = torch.log(torch.clamp(lum, min=eps))
        # as in the JAX package: with denoise_f16 the separable einsums store
        # their intermediates in float16; without, the float32 tile core
        f16 = torch.float16 if settings.denoise_f16 else None
        den = _wiener.wiener_denoise(
            log_lum[..., None], settings.denoise, tile_size=32,
            overlap_factor=settings.denoise_overlap, use_separable=settings.denoise_f16,
            spectral_dtype=f16, storage_dtype=f16,
        )[..., 0]
        return _color.lab_modify_luminance(lab, torch.exp(den + eps))

    def bilateral(rgb):
        lab, lum = lab_and_lum(rgb, input_clipped=settings.enable_denoise)
        out = _bilateral.bilateral_process(lum, settings.bil_sigma_spatial,
                                           settings.bil_sigma_luminance, settings.bilateral)
        return _color.lab_modify_luminance(lab, out)

    def laplacian(lum):
        return _laplacian.local_laplacian(lum, _laplacian_params(settings))

    def _laplacian_one(rgb):
        lab, lum = lab_and_lum(
            rgb, input_clipped=settings.enable_denoise or settings.enable_bilateral)
        return _color.lab_modify_luminance(lab, laplacian(lum))

    def _back_one(rgb, bounds):
        rgb = normalize_image(rgb, bounds)
        timing.mark('normalize')
        if settings.enable_denoise:
            rgb = denoise(rgb)
            timing.mark('denoise')
        if settings.enable_bilateral:
            rgb = bilateral(rgb)
            timing.mark('bilateral')
        if settings.enable_laplacian:
            rgb = _laplacian_one(rgb)
            timing.mark('laplacian')
        return rgb

    def front(bytes_batch, wb_gains):
        rows = bytes_batch.reshape(-1, height, (width * 3) // 2)
        n = rows.shape[0]
        rgb = torch.empty((n, height, width, 3), dtype=torch.float32, device=rows.device)
        for i in range(n):
            rgb[i] = _front_one(rows[i], wb_gains)
        return rgb, sample(rgb)

    def back(rgb, samples, bounds):
        if not has_back:
            # normalize commutes with the strided sampling
            return normalize_image(rgb, bounds), normalize_image(samples, bounds)
        for i in range(rgb.shape[0]):
            rgb[i] = _back_one(rgb[i], bounds)
        return rgb, sample(rgb)

    def tonemap(rgb, metrics):
        return _tonemap_dispatch(settings, rgb, metrics)

    def fused(bytes_batch, wb_gains, bounds_in, metrics_in, alpha):
        # a traced call: its marks time each stage on the device (a stage
        # runs from the mark before it to its own); the stages that the
        # sharded programs run outside it are unmarked
        with timing.call('begin', bytes_batch.device):
            rgb, samples = front(bytes_batch, wb_gains)
            bounds = ema_bounds(samples, bounds_in, alpha)
            timing.mark('bounds')
            rgb, samples = back(rgb, samples, bounds)
            metrics = ema_metrics(samples, metrics_in, alpha)
            timing.mark('metrics')
            out = tonemap(rgb, metrics)
            timing.mark('tonemap')
        return out, bounds, metrics

    fused.stages = PipelineStages(
        decode=decode, demosaic=demosaic, front=front, sample=sample, back=back,
        denoise=denoise, bilateral=bilateral, lab_and_lum=lab_and_lum, laplacian=laplacian,
        tonemap=tonemap)
    return fused


class ImageProcessor:
    """Camera-geometry-bound processor with the EMA state on the device."""

    def __init__(self, image_size: tuple[int, int], bayer_pattern: BayerPattern,
                 packed_format: PackedFormat, settings: ImageProcessingSettings,
                 device=None, white_balance: tuple[float, float, float] | None = None,
                 transforms: ImageTransform | dict[str, ImageTransform] = ImageTransform.none,
                 padding: int = 0, mesh=None):
        """`mesh`: a parallel.Mesh with a 'batch' axis.  Frame batches (the
        12 cameras of the beetroot rig) then split over its devices, and
        the bounds and metrics EMA reduce the gathered samples of every
        shard, so the result equals the unsharded program's.  The batch
        size must be divisible by the mesh size.  Without `device`, a mesh
        puts the processor's state on its first device."""
        if device is None and mesh is not None:
            device = mesh.devices.flat[0]
        self.device = resolve_device(device)
        self.mesh = mesh
        self.settings = settings
        self.image_size = tuple(image_size)
        self.bayer_pattern = bayer_pattern
        self.packed_format = packed_format
        self.transforms = transforms
        self.padding = padding
        self.bounds: torch.Tensor | None = None
        self.metrics: torch.Tensor | None = None
        self.white_balance = (
            None if white_balance is None
            else torch.as_tensor(white_balance, dtype=torch.float32, device=self.device)
        )
        self._graph_pool = GraphPool()
        # the bilinear route's graphs (JAX calls its jitted free function)
        self._bilinear = Graphed(_demosaic.bilinear5x5_demosaic, pool=self._graph_pool)
        self._workspace_args: dict[str, tuple] = {}
        self._rebuild_workspaces()

    def _rebuild_workspaces(self):
        """The per-op workspaces of the piecewise API and the batched
        pipeline, for the current settings."""
        s = self.settings
        fused = build_pipeline_fn(s, self.image_size, self.bayer_pattern,
                                  self.packed_format, self.white_balance is not None)
        if self.mesh is None:
            # as JAX jits it: on the card one CUDA graph per input shape
            self._fused = Graphed(fused, pool=self._graph_pool)
        else:
            from ..parallel.mesh import _sharded_pipeline

            self._fused = _sharded_pipeline(fused, self.mesh, 'batch', self._graph_pool)
        self._workspace('bil_workspace', Bilateral, sigma_s=s.bil_sigma_spatial,
                        sigma_r=s.bil_sigma_luminance)
        self._workspace('rcd_workspace', RCD, self.bayer_pattern)
        self._workspace('ppg_workspace', PPG, self.bayer_pattern,
                        median_threshold=s.ppg_median_threshold)
        self._workspace('postprocess_workspace', PostProcess, self.bayer_pattern,
                        color_smoothing_passes=s.color_smoothing_passes, green_eq_local=False,
                        green_eq_global=True, green_eq_threshold=s.green_eq_threshold)
        f16 = torch.float16 if s.denoise_f16 else None
        self._workspace('wiener_workspace', Wiener, overlap_factor=s.denoise_overlap,
                        spectral_dtype=f16, storage_dtype=f16)

    def _workspace(self, name: str, cls, *args, **kwargs) -> None:
        """Set the workspace `name` to cls(device, image_size, *args,
        **kwargs) on the processor's graph pool, unless it holds one built
        with these arguments: that one stays, with its graphs."""
        key = (cls, args, tuple(sorted(kwargs.items())))
        if self._workspace_args.get(name) != key:
            workspace = cls(self.device, self.image_size, *args, **kwargs)
            workspace._graphs.pool = self._graph_pool
            setattr(self, name, workspace)
            self._workspace_args[name] = key

    def __repr__(self) -> str:
        wb = self.white_balance
        wb_str = 'None' if wb is None else f'({wb[0]:.3f}, {wb[1]:.3f}, {wb[2]:.3f})'
        transform_str = (
            f'{self.transforms.name}' if isinstance(self.transforms, ImageTransform)
            else f'{{{", ".join(f"{k}: {v.name}" for k, v in self.transforms.items())}}}')
        return (
            f'ImageProcessor(size={self.image_size}, bayer={self.bayer_pattern.name}, '
            f'format={self.packed_format.name}, device={self.device}, wb={wb_str}, '
            f'padding={self.padding}, transform={transform_str}, '
            f'debayer={self.settings.debayer.name}, tonemap={self.settings.tone_mapping.name})')

    @staticmethod
    def from_camera_settings(camera_settings: CameraSettings, device=None) -> 'ImageProcessor':
        return ImageProcessor(
            camera_settings.image_size, camera_settings.bayer_pattern,
            camera_settings.packed_format, camera_settings.image_processing, device=device,
            white_balance=camera_settings.white_balance, transforms=camera_settings.transform,
            padding=camera_settings.padding,
        )

    def update_settings(self, settings: ImageProcessingSettings) -> None:
        if settings != self.settings:
            self.settings = settings
            self._rebuild_workspaces()

    @property
    def final_size(self) -> tuple[int, int]:
        return resize_longest_edge(self.image_size, self.settings.resize_width)

    @property
    def expected_bytes(self) -> int:
        width, height = self.image_size
        return (width * height * 3) // 2 + self.padding

    def _mismatch(self, message: str) -> ImageSizeMismatchError:
        return ImageSizeMismatchError(message, image_size=self.image_size,
                                      packed_format=self.packed_format, padding=self.padding)

    def _as_bytes(self, data) -> torch.Tensor:
        if isinstance(data, np.ndarray):
            data = torch.from_numpy(np.ascontiguousarray(data))
        return to_device(data, self.device, torch.uint8)

    # ---- piecewise API ----

    def load_bytes(self, bytes) -> torch.Tensor:
        """Packed bytes of one frame -> the (H, W) float32 mosaic."""
        data = self._as_bytes(bytes)
        if data.numel() != self.expected_bytes:
            raise self._mismatch(
                f'Image size mismatch: expected {self.expected_bytes} bytes for '
                f'{self.image_size} {self.packed_format.name} with {self.padding} padding, '
                f'got {data.numel()} bytes. ')
        if self.padding > 0:
            data = data[: -self.padding]
        decoded = _packed.decode12(data, output_dtype=torch.float32,
                                   format_type=self.packed_format)
        width, height = self.image_size
        if decoded.numel() != width * height:
            raise self._mismatch(
                f'Decoded image size mismatch: expected {width * height} pixels '
                f'({width}x{height}), got {decoded.numel()} pixels.')
        return decoded.reshape(height, width)

    def load_image(self, bytes) -> torch.Tensor:
        return self.debayer(self.load_bytes(bytes))

    def debayer(self, bayer_image: torch.Tensor) -> torch.Tensor:
        """White balance, demosaic and postprocess of an (H, W) mosaic."""
        if bayer_image.ndim != 2:
            raise AssertionError(
                f'Bayer image must have 2 dimensions, got {tuple(bayer_image.shape)}')
        bayer_image = bayer_image.to(self.device)
        if self.white_balance is not None:
            bayer_image = _wb.apply_white_balance(bayer_image, self.white_balance,
                                                  self.bayer_pattern)
        if self.settings.debayer == Debayer.bilinear:
            rgb_raw = self._bilinear(bayer_image[..., None], self.bayer_pattern)
        elif self.settings.debayer == Debayer.rcd:
            rgb_raw = self.rcd_workspace.process(bayer_image[..., None])
        elif self.settings.debayer == Debayer.ppg:
            rgb_raw = self.ppg_workspace.process(bayer_image[..., None])
        else:
            raise AssertionError(f'Invalid debayer method: {self.settings.debayer}')
        if self.settings.postprocess:
            rgb_raw = self.postprocess_workspace.process(rgb_raw)
        return rgb_raw

    def process_rgb(self, rgb_raw: torch.Tensor, bounds=None) -> torch.Tensor:
        """Normalize by `bounds` if given, then the enabled luminance stages."""
        if bounds is not None:
            rgb_raw = normalize_image(rgb_raw, bounds)
        if self.settings.enable_denoise:
            rgb_raw = self.wiener_workspace.process_log_luminance(rgb_raw, self.settings.denoise)
        if self.settings.enable_bilateral:
            rgb_raw = self.bil_workspace.process_rgb(rgb_raw, self.settings.bilateral)
        if self.settings.enable_laplacian:
            lum = _color.compute_luminance(rgb_raw)
            rgb_raw = _color.modify_luminance(
                rgb_raw, _laplacian.local_laplacian(lum, _laplacian_params(self.settings)))
        return rgb_raw

    def tonemap(self, rgb_raw: torch.Tensor, metrics=None) -> torch.Tensor:
        if metrics is None:
            metrics = _tonemap.compute_image_metrics([rgb_raw], stride=4, min_gray=1e-4)
        return _tonemap_dispatch(self.settings, rgb_raw, metrics)

    # ---- batched API ----

    def process_batch(self, bytes_batch) -> torch.Tensor:
        """Run the pipeline on a (B, n_bytes) uint8 batch (numpy or tensor),
        updating the EMA state.  Returns (B, H, W, 3) uint8 on the device.
        The `isp.input` span runs to the call of the program: the checks,
        the batch's copy to the device and the EMA inputs."""
        with timing.span('isp.input'):
            bytes_batch = self._as_bytes(bytes_batch)
            if bytes_batch.ndim == 1:
                bytes_batch = bytes_batch[None]
            if bytes_batch.shape[-1] != self.expected_bytes:
                raise self._mismatch(f'Image size mismatch: expected {self.expected_bytes} '
                                     f'bytes, got {bytes_batch.shape[-1]} bytes.')
            if self.padding > 0:
                bytes_batch = bytes_batch[:, : -self.padding]
            if self.mesh is not None and bytes_batch.shape[0] % self.mesh.size != 0:
                raise ValueError(f'batch size {bytes_batch.shape[0]} must be divisible by the '
                                 f'mesh size {self.mesh.size} for sharded processing')
            first = self.bounds is None
            f32 = dict(dtype=torch.float32, device=self.device)
            alpha = torch.full((), 1.0 if first else self.settings.moving_average, **f32)
            bounds_in = torch.zeros(2, **f32) if first else self.bounds
            metrics_in = torch.zeros(5, **f32) if first else self.metrics
            wb = self.white_balance if self.white_balance is not None else torch.ones(3, **f32)
        out, self.bounds, self.metrics = self._fused(bytes_batch, wb, bounds_in, metrics_in, alpha)
        return out

    def transform(self, image: torch.Tensor, image_name: str) -> torch.Tensor:
        if isinstance(self.transforms, dict):
            return transform(image, self.transforms[image_name])
        return transform(image, self.transforms)

    def process_image_set(self, image_set_bytes: dict) -> dict:
        """Process a named set of same-geometry frames as one batch."""
        names = list(image_set_bytes)
        batch = torch.stack([self._as_bytes(b) for b in image_set_bytes.values()])
        out = self.process_batch(batch)
        return {name: self.transform(out[i], name) for i, name in enumerate(names)}

    def process(self, bytes, image_name: str) -> torch.Tensor:
        return self.process_image_set({image_name: bytes})[image_name]


__all__ = ['ImageProcessor', 'ImageSizeMismatchError', 'PipelineStages', 'build_pipeline_fn']
