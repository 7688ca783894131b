"""Public local contrast module (counterpart of
tpu_darktable/local_contrast.py): the local Laplacian and the
bilateral-grid detail boost, each bound to one image size."""

from __future__ import annotations

import torch

from ._device import resolve_device
from .ops import color as _color
from .ops.bilateral import bilateral_process as _bilateral_process
from .ops.laplacian import LaplacianParams, local_laplacian as _local_laplacian


class Laplacian:
    """Local-Laplacian workspace, on one device (the card unless
    `device='cpu'`).  Takes (device, image_size, params) or (image_size,
    params)."""

    def __init__(self, device=None, image_size=None, params: LaplacianParams | None = None):
        if params is None and isinstance(device, (tuple, list)):
            device, image_size, params = None, tuple(device), image_size
        if params is None:
            params = LaplacianParams()
        if image_size is None:
            raise TypeError('image_size is required')
        self.device = resolve_device(device)
        self._width, self._height = tuple(image_size)
        self._params = params

    def process(self, input_tensor):
        input_tensor = torch.as_tensor(input_tensor, device=self.device)
        expected = (self._height, self._width)
        if tuple(input_tensor.shape) != expected:
            raise RuntimeError(
                f'Laplacian input shape {tuple(input_tensor.shape)} != expected {expected}')
        return _local_laplacian(input_tensor, self._params)

    def process_rgb(self, input_image):
        """Luminance round trip."""
        input_image = torch.as_tensor(input_image, device=self.device)
        luminance = _color.compute_luminance(input_image)
        return _color.modify_luminance(input_image, self.process(luminance))

    @property
    def image_size(self) -> tuple[int, int]:
        return (self._width, self._height)

    @property
    def sigma(self) -> float:
        return self._params.sigma

    @property
    def shadows(self) -> float:
        return self._params.shadows

    @property
    def highlights(self) -> float:
        return self._params.highlights

    @property
    def clarity(self) -> float:
        return self._params.clarity


class Bilateral:
    """Bilateral grid workspace, on one device (the card unless
    `device='cpu'`)."""

    def __init__(self, device=None, image_size=None, *, sigma_s: float, sigma_r: float):
        if image_size is None and isinstance(device, (tuple, list)):
            device, image_size = None, tuple(device)
        if image_size is None:
            raise TypeError('image_size is required')
        self.device = resolve_device(device)
        self._width, self._height = tuple(image_size)
        self._sigma_s = float(sigma_s)
        self._sigma_r = float(sigma_r)

    def process(self, luminance, detail: float):
        luminance = torch.as_tensor(luminance, device=self.device)
        expected = (self._height, self._width)
        if tuple(luminance.shape) != expected:
            raise RuntimeError(
                f'Bilateral input shape {tuple(luminance.shape)} != expected {expected}')
        return _bilateral_process(luminance, self._sigma_s, self._sigma_r, float(detail))

    def process_rgb(self, input_image, detail: float):
        """Luminance round trip."""
        input_image = torch.as_tensor(input_image, device=self.device)
        luminance = _color.compute_luminance(input_image)
        return _color.modify_luminance(input_image, self.process(luminance, float(detail)))

    def process_log_rgb(self, input_image, detail: float, eps: float = 1e-6):
        """Log-luminance round trip."""
        input_image = torch.as_tensor(input_image, device=self.device)
        log_luminance = _color.compute_log_luminance(input_image, eps)
        return _color.modify_log_luminance(
            input_image, self.process(log_luminance, float(detail)), eps)

    @property
    def image_size(self) -> tuple[int, int]:
        return (self._width, self._height)

    @property
    def sigma_s(self) -> float:
        return self._sigma_s

    @property
    def sigma_r(self) -> float:
        return self._sigma_r


__all__ = ['Bilateral', 'Laplacian', 'LaplacianParams']
