"""Public local contrast module (counterpart of
tpu_darktable/local_contrast.py): the local Laplacian and the
bilateral-grid detail boost, each bound to one image size.

Each `process*` method runs whole (the luminance round trip included)
through the instance's `_graph.Graphed`, keyed on the method, the input
shape and the values JAX makes static (the Laplacian's parameters,
`detail`, `eps`): on the card one CUDA graph each, replayed after.  The
shape check and the move to the device stay outside the graph.
"""

from __future__ import annotations

import torch

from ._device import resolve_device
from ._graph import Graphed
from ._validate import check_channels_last
from .ops import color as _color
from .ops.bilateral import bilateral_process as _bilateral_process
from .ops.laplacian import LaplacianParams, local_laplacian as _local_laplacian


def _laplacian_program(method: str, image, params: LaplacianParams):
    """'process' (an (H, W) plane) or 'rgb' (its luminance round trip)."""
    if method == 'process':
        return _local_laplacian(image, params)
    luminance = _color.compute_luminance(image)
    return _color.modify_luminance(image, _local_laplacian(luminance, params))


def _bilateral_program(method: str, image, sigma_s: float, sigma_r: float, detail: float, eps):
    """'process' (an (H, W) plane), 'rgb' or 'log_rgb' (the luminance or
    log-luminance round trip)."""
    if method == 'process':
        return _bilateral_process(image, sigma_s, sigma_r, detail)
    if method == 'rgb':
        luminance = _color.compute_luminance(image)
        return _color.modify_luminance(image, _bilateral_process(luminance, sigma_s, sigma_r,
                                                                 detail))
    log_luminance = _color.compute_log_luminance(image, eps)
    return _color.modify_log_luminance(
        image, _bilateral_process(log_luminance, sigma_s, sigma_r, detail), eps)


def _check_plane(cls: str, shape, expected):
    if tuple(shape) != expected:
        raise RuntimeError(f'{cls} input shape {tuple(shape)} != expected {expected}')


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
        self._graphs = Graphed(_laplacian_program)

    def process(self, input_tensor):
        input_tensor = torch.as_tensor(input_tensor, device=self.device)
        _check_plane('Laplacian', input_tensor.shape, (self._height, self._width))
        return self._graphs('process', input_tensor, self._params)

    def process_rgb(self, input_image):
        """Luminance round trip."""
        input_image = check_channels_last(torch.as_tensor(input_image, device=self.device), 'rgb')
        _check_plane('Laplacian', input_image.shape[:-1], (self._height, self._width))
        return self._graphs('rgb', input_image, self._params)

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
        self._graphs = Graphed(_bilateral_program)

    def _run(self, method, image, detail, eps=None):
        image = torch.as_tensor(image, device=self.device)
        shape = image.shape if method == 'process' else check_channels_last(image, 'rgb').shape[:-1]
        _check_plane('Bilateral', shape, (self._height, self._width))
        return self._graphs(method, image, self._sigma_s, self._sigma_r, float(detail), eps)

    def process(self, luminance, detail: float):
        return self._run('process', luminance, detail)

    def process_rgb(self, input_image, detail: float):
        """Luminance round trip."""
        return self._run('rgb', input_image, detail)

    def process_log_rgb(self, input_image, detail: float, eps: float = 1e-6):
        """Log-luminance round trip."""
        return self._run('log_rgb', input_image, detail, float(eps))

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
