"""Public denoise module (counterpart of tpu_darktable/denoise.py): the
Wiener class over ops/wiener.py, and the wavelet, NLM and noise-estimate
functions.

Each `Wiener.process*` method runs whole (the LAB or log round trip and the
Wiener core) through the instance's `_graph.Graphed`: on the card one CUDA
graph a method, input shape and `eps`, replayed after.  The noise sigmas
are a tensor argument, as JAX traces them, so a new `noise` replays the
same graph; the checks stay outside it.
"""

from __future__ import annotations

import torch

from ._device import resolve_device, to_device
from ._graph import Graphed
from ._validate import check_channels_last
from .ops import color as _color
from .ops.nlm import nlm_denoise, wavelet_denoise
from .ops.wiener import estimate_channel_noise
from .ops.wiener import wiener_denoise as _wiener_denoise


def _wiener_program(method: str, image, sigmas, eps, tile_size, overlap_factor, use_separable,
                    spectral_dtype, storage_dtype):
    """One Wiener method on a checked image and its (C,) sigmas: 'process'
    (the core), 'luminance', 'log_luminance' (the LAB-L plane, linear or
    log) or 'log' (every channel in log space)."""
    def core(x):
        return _wiener_denoise(x, sigmas, tile_size=tile_size, overlap_factor=overlap_factor,
                               use_separable=use_separable, spectral_dtype=spectral_dtype,
                               storage_dtype=storage_dtype)

    if method == 'process':
        return core(image)
    if method == 'luminance':
        return _color.modify_luminance(image, core(_color.compute_luminance(image)[..., None])[..., 0])
    if method == 'log_luminance':
        log_luminance = _color.compute_log_luminance(image, eps=eps)
        return _color.modify_log_luminance(image, core(log_luminance[..., None])[..., 0], eps=eps)
    if method == 'log':
        return torch.exp(core(torch.log(image + eps)))
    raise AssertionError(f'unknown Wiener method {method!r}')


def check_overlap_factor(overlap_factor: int):
    if overlap_factor not in {2, 4, 8}:
        raise ValueError('overlap_factor must be 2, 4, or 8')


class Wiener:
    """Wiener denoiser bound to one image size, on one device (the card
    unless `device='cpu'`)."""

    def __init__(self, device=None, image_size: tuple[int, int] | None = None,
                 overlap_factor: int = 4, tile_size: int = 32, *,
                 spectral_dtype=None, storage_dtype=None):
        """spectral_dtype/storage_dtype: optional float16 STORAGE of the
        spectral intermediates of the separable einsum route (ops/wiener.py);
        the math stays float32.  Without either, `process` takes the
        tile-core route (kernels/wiener_core.py), which stores nothing."""
        if image_size is None and isinstance(device, (tuple, list)):
            device, image_size = None, tuple(device)
        if image_size is None:
            raise TypeError('image_size is required')
        width, height = image_size
        if width <= 0 or height <= 0:
            raise ValueError(f'Image dimensions must be positive, got {width}x{height}')
        check_overlap_factor(overlap_factor)
        if tile_size not in {16, 32}:
            raise ValueError(f'tile_size must be 16 or 32, got {tile_size}')
        self.device = resolve_device(device)
        self._width, self._height = width, height
        self._overlap_factor = overlap_factor
        self._tile_size = tile_size
        self._spectral_dtype = spectral_dtype
        self._storage_dtype = storage_dtype
        self._graphs = Graphed(_wiener_program)

    def __repr__(self):
        return (f'Wiener({self._width}x{self._height},'
                f'overlap_factor={self._overlap_factor}, tile_size={self._tile_size})')

    @property
    def overlap_factor(self) -> int:
        return self._overlap_factor

    def _on_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _sigmas(self, shape, noise) -> torch.Tensor:
        """Check an (H, W, C) input shape of the Wiener core; the (C,)
        sigmas of `noise` (a float or a (C,) tensor) on the device."""
        if len(shape) != 3:
            raise ValueError(f'image must have 3 dimensions, got {tuple(shape)}')
        channels = shape[2]
        expected = (self._height, self._width, channels)
        if tuple(shape) != expected:
            raise RuntimeError(f'Wiener input shape {tuple(shape)} != expected {expected}')
        if channels not in {1, 3}:
            raise ValueError(f'image channels must be 1 or 3, got {channels}')
        if isinstance(noise, float):
            return torch.full((channels,), noise, dtype=torch.float32, device=self.device)
        sigmas = to_device(noise, self.device, torch.float32)
        if tuple(sigmas.shape) != (channels,):
            raise ValueError(
                f'noise tensor must have {channels} elements for {channels}-channel image')
        return sigmas

    def _run(self, method, image, sigmas, eps=None):
        stores = self._spectral_dtype is not None or self._storage_dtype is not None
        return self._graphs(method, image, sigmas, eps, self._tile_size, self._overlap_factor,
                            stores, self._spectral_dtype, self._storage_dtype)

    def process(self, image, noise):
        """Wiener-filter an (H, W, C) image, C in {1, 3}; noise is a float or
        a (C,) tensor."""
        image = self._on_device(image)
        return self._run('process', image, self._sigmas(image.shape, noise))

    def process_luminance(self, image, noise):
        """Denoise the LAB-L plane only."""
        image = check_channels_last(self._on_device(image), 'rgb')
        return self._run('luminance', image, self._sigmas((*image.shape[:-1], 1), noise))

    def process_log_luminance(self, image, noise, eps: float = 1e-4):
        """Denoise the log luminance (the pipeline's choice)."""
        image = check_channels_last(self._on_device(image), 'rgb')
        return self._run('log_luminance', image, self._sigmas((*image.shape[:-1], 1), noise),
                         float(eps))

    def process_log(self, image, noise, eps: float = 1e-4):
        """Denoise all channels in log space."""
        image = self._on_device(image)
        return self._run('log', image, self._sigmas(image.shape, noise), float(eps))


def create_wiener(device=None, image_size=None, *, overlap: int = 4,
                  tile_size: int = 32) -> Wiener:
    return Wiener(device, image_size, overlap_factor=overlap, tile_size=tile_size)


__all__ = ['Wiener', 'check_overlap_factor', 'create_wiener', 'estimate_channel_noise',
           'nlm_denoise', 'wavelet_denoise']
