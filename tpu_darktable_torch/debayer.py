"""Public debayer module (counterpart of tpu_darktable/debayer.py).

The workspace classes (PPG / RCD / PostProcess) keep the reference's
constructor signatures (device, image_size, pattern, ...) and check the
input shape against the geometry they were built for.  Each runs on one
device: the card unless `device='cpu'`.  Where the JAX package jits a
workspace's function with its constructor arguments static, the port runs
it through a `_graph.Graphed` keyed on those arguments: on the card each
input shape is captured once as a CUDA graph and replayed; the shape check
and the move to the device stay outside the graph.
"""

from __future__ import annotations

import torch

from ._device import resolve_device
from ._graph import Graphed
from .ops import demosaic as _demosaic
from .ops import postprocess as _postprocess
from .ops import rcd as _rcd
from .ops.bayer import BayerPattern, PackedFormat
from .ops.packed import (
    decode12,
    decode12_float,
    decode12_half,
    decode12_u16,
    encode,
    encode12_float,
    encode12_u16,
)


# bilinear5x5_demosaic's captures, keyed on the pattern and the input shape
_bilinear = Graphed(_demosaic.bilinear5x5_demosaic)


def bilinear5x5_demosaic(image: torch.Tensor, bayer_pattern: BayerPattern) -> torch.Tensor:
    """5x5 bilinear demosaic of an (H, W, 1) Bayer image -> (H, W, 3), on
    the image's device."""
    return _bilinear(image, bayer_pattern)


class Bilinear5x5:
    """Stateless wrapper.  A tensor is processed on its own device; any
    other array goes to the card, like the workspace classes' inputs."""

    def __init__(self, bayer_pattern: BayerPattern):
        self.bayer_pattern = bayer_pattern
        self._graphs = Graphed(_demosaic.bilinear5x5_demosaic)

    def process(self, image):
        if not isinstance(image, torch.Tensor):
            image = torch.as_tensor(image, device=resolve_device(None))
        return self._graphs(image, self.bayer_pattern)


def _norm_workspace_args(device, image_size):
    """Accept both reference-style (device, image_size, ...) and the shorter
    (image_size, ...) call patterns."""
    if image_size is None and isinstance(device, (tuple, list)):
        return None, tuple(device)
    if image_size is None:
        raise TypeError('image_size is required')
    return device, tuple(image_size)


class _Workspace:
    """One image geometry on one device; `process` checks the input shape
    and runs `_program(image, *static arguments)` through its graphs."""

    _channels = 1
    _program = None

    def __init__(self, device, image_size):
        device, image_size = _norm_workspace_args(device, image_size)
        self.device = resolve_device(device)
        self._width, self._height = image_size
        self._graphs = Graphed(self._program)

    def _checked(self, input_tensor) -> torch.Tensor:
        expected = (self._height, self._width, self._channels)
        if tuple(input_tensor.shape) != expected:
            raise RuntimeError(f'{type(self).__name__} input shape {tuple(input_tensor.shape)} '
                               f'!= expected {expected}')
        return torch.as_tensor(input_tensor, device=self.device)

    @property
    def image_size(self) -> tuple[int, int]:
        return (self._width, self._height)


class PPG(_Workspace):
    """PPG demosaic workspace."""

    _program = staticmethod(_demosaic.ppg_demosaic)

    def __init__(self, device=None, image_size: tuple[int, int] | None = None,
                 bayer_pattern: BayerPattern = BayerPattern.RGGB, *,
                 median_threshold: float = 0.0):
        super().__init__(device, image_size)
        self._pattern = bayer_pattern
        self._median_threshold = float(median_threshold)

    def process(self, input_tensor):
        return self._graphs(self._checked(input_tensor), self._pattern, self._median_threshold)

    @property
    def median_threshold(self) -> float:
        return self._median_threshold


class RCD(_Workspace):
    """RCD demosaic workspace."""

    _program = staticmethod(_rcd.rcd_demosaic)

    def __init__(self, device=None, image_size: tuple[int, int] | None = None,
                 bayer_pattern: BayerPattern = BayerPattern.RGGB):
        super().__init__(device, image_size)
        self._pattern = bayer_pattern

    def process(self, input_tensor):
        return self._graphs(self._checked(input_tensor), self._pattern)


class PostProcess(_Workspace):
    """Colour-smoothing / green-equilibration workspace."""

    _channels = 3
    _program = staticmethod(_postprocess.postprocess)

    def __init__(self, device=None, image_size: tuple[int, int] | None = None,
                 bayer_pattern: BayerPattern = BayerPattern.RGGB, *,
                 color_smoothing_passes: int = 0, green_eq_local: bool = False,
                 green_eq_global: bool = False, green_eq_threshold: float = 0.04):
        super().__init__(device, image_size)
        self._pattern = bayer_pattern
        self._color_smoothing_passes = int(color_smoothing_passes)
        self._green_eq_local = bool(green_eq_local)
        self._green_eq_global = bool(green_eq_global)
        self._green_eq_threshold = float(green_eq_threshold)

    def process(self, input_tensor):
        return self._graphs(self._checked(input_tensor), self._pattern,
                            self._color_smoothing_passes, self._green_eq_local,
                            self._green_eq_global, self._green_eq_threshold)

    @property
    def color_smoothing_passes(self) -> int:
        return self._color_smoothing_passes

    @property
    def green_eq_threshold(self) -> float:
        return self._green_eq_threshold


__all__ = [
    'PPG',
    'RCD',
    'BayerPattern',
    'Bilinear5x5',
    'PackedFormat',
    'PostProcess',
    'bilinear5x5_demosaic',
    'decode12',
    'decode12_float',
    'decode12_half',
    'decode12_u16',
    'encode',
    'encode12_float',
    'encode12_u16',
]
