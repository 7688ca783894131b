"""Public denoise module (counterpart of tpu_darktable/denoise.py): the
Wiener class over ops/wiener.py, and the wavelet, NLM and noise-estimate
functions."""

from __future__ import annotations

import torch

from ._device import resolve_device
from .ops import color as _color
from .ops.nlm import nlm_denoise, wavelet_denoise
from .ops.wiener import estimate_channel_noise
from .ops.wiener import wiener_denoise as _wiener_denoise


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

    def __repr__(self):
        return (f'Wiener({self._width}x{self._height},'
                f'overlap_factor={self._overlap_factor}, tile_size={self._tile_size})')

    @property
    def overlap_factor(self) -> int:
        return self._overlap_factor

    def _on_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def process(self, image, noise):
        """Wiener-filter an (H, W, C) image, C in {1, 3}; noise is a float or
        a (C,) tensor."""
        image = self._on_device(image)
        if image.ndim != 3:
            raise ValueError(f'image must have 3 dimensions, got {tuple(image.shape)}')
        channels = image.shape[2]
        expected = (self._height, self._width, channels)
        if tuple(image.shape) != expected:
            raise RuntimeError(f'Wiener input shape {tuple(image.shape)} != expected {expected}')
        if channels not in {1, 3}:
            raise ValueError(f'image channels must be 1 or 3, got {channels}')
        if isinstance(noise, float):
            sigmas = torch.full((channels,), noise, dtype=torch.float32, device=self.device)
        else:
            sigmas = torch.as_tensor(noise, dtype=torch.float32, device=self.device)
            if tuple(sigmas.shape) != (channels,):
                raise ValueError(
                    f'noise tensor must have {channels} elements for {channels}-channel image')
        stores = self._spectral_dtype is not None or self._storage_dtype is not None
        return _wiener_denoise(image, sigmas, tile_size=self._tile_size,
                               overlap_factor=self._overlap_factor, use_separable=stores,
                               spectral_dtype=self._spectral_dtype,
                               storage_dtype=self._storage_dtype)

    def process_luminance(self, image, noise):
        """Denoise the LAB-L plane only."""
        image = self._on_device(image)
        luminance = _color.compute_luminance(image)
        modified = self.process(luminance[..., None], noise)[..., 0]
        return _color.modify_luminance(image, modified)

    def process_log_luminance(self, image, noise, eps: float = 1e-4):
        """Denoise the log luminance (the pipeline's choice)."""
        image = self._on_device(image)
        log_luminance = _color.compute_log_luminance(image, eps=eps)
        modified = self.process(log_luminance[..., None], noise)[..., 0]
        return _color.modify_log_luminance(image, modified, eps=eps)

    def process_log(self, image, noise, eps: float = 1e-4):
        """Denoise all channels in log space."""
        log_rgb = torch.log(self._on_device(image) + eps)
        return torch.exp(self.process(log_rgb, noise))


def create_wiener(device=None, image_size=None, *, overlap: int = 4,
                  tile_size: int = 32) -> Wiener:
    return Wiener(device, image_size, overlap_factor=overlap, tile_size=tile_size)


__all__ = ['Wiener', 'check_overlap_factor', 'create_wiener', 'estimate_channel_noise',
           'nlm_denoise', 'wavelet_denoise']
