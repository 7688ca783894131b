# Frozen copy of tpu_darktable_torch/ops/tonemap.py (plain PyTorch paths only), kept
# as the benchmark's reference; it imports nothing of the measured package.
"""Tone mapping and image statistics (counterpart of
tpu_darktable/ops/tonemap.py): bounds and metrics over strided samples,
the adaptation value, the linear, Reinhard, ACES (plain and adaptive) and
filmic curves, the shared gamma + vibrance + uint8 tail, and the metrics'
dict helpers.  Everything keeps its results on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import scalar_on
from .._validate import check_channels_last
from .color import color_transform_3x3, modify_vibrance, rgb_to_gray


@dataclass(frozen=True)
class TonemapParameters:
    gamma: float = 1.0
    intensity: float = 0.0
    light_adapt: float = 0.8
    vibrance: float = 0.0


def _as_batch(images) -> torch.Tensor:
    """list of (H, W, 3) or (..., H, W, 3) tensor -> (B, H, W, 3)."""
    if isinstance(images, (list, tuple)):
        arr = torch.stack([check_channels_last(torch.as_tensor(im), 'images[i]') for im in images])
    else:
        arr = check_channels_last(torch.as_tensor(images), 'images')
    if arr.ndim == 3:
        arr = arr[None]
    elif arr.ndim < 3:
        raise RuntimeError(f'images must be (H, W, 3) or batched, got shape {tuple(arr.shape)}')
    return arr.reshape((-1,) + tuple(arr.shape[-3:]))


def compute_image_bounds(images, stride: int = 8) -> torch.Tensor:
    """(2,) float32 [min, max] over strided pixels of an image set."""
    sampled = _as_batch(images)[:, ::stride, ::stride]
    return torch.stack((sampled.min(), sampled.max())).to(torch.float32)


def compute_image_metrics(images, stride: int = 8, min_gray: float = 1e-4,
                          rescale: bool = False) -> torch.Tensor:
    """(5,) [log_mean, linear_mean, rgb_mean r, g, b] over strided pixels,
    masking pixels with any channel >= 0.99 (after rescaling by the set's
    bounds if `rescale`), normalized by the valid count on the device."""
    sampled = _as_batch(images)[:, ::stride, ::stride].to(torch.float32)
    if rescale:
        b0, b1 = compute_image_bounds(images, stride)
    else:
        b0, b1 = 0.0, 1.0
    scaled = (sampled - b0) / (b1 - b0 + 1e-6)
    mask = torch.where(torch.any(scaled >= 0.99, dim=-1), 0.0, 1.0)
    gray = rgb_to_gray(scaled)
    log_gray = torch.log(torch.clamp(gray, min=min_gray))
    sums = torch.stack((
        torch.sum(log_gray * mask),
        torch.sum(gray * mask),
        torch.sum(scaled[..., 0] * mask),
        torch.sum(scaled[..., 1] * mask),
        torch.sum(scaled[..., 2] * mask),
    ))
    valid = torch.clamp(torch.sum(mask), min=1.0)
    return (sums / valid).to(torch.float32)


def _compute_map_key(log_mean: torch.Tensor) -> torch.Tensor:
    """log_mean -> tone map key in [0.3, 1.0]."""
    normalized = torch.clamp((-log_mean) / 9.21034, 0.0, 1.0)
    return 0.3 + 0.7 * torch.pow(normalized, 1.4)


def _compute_adaptation(metrics: torch.Tensor, pixel_rgb: torch.Tensor,
                        light_adapt: float, intensity: float) -> torch.Tensor:
    """Per-pixel adaptation value."""
    metrics = metrics.to(torch.float32)
    map_key = _compute_map_key(metrics[0])
    global_mean = metrics[2:5]
    exposure = torch.exp(scalar_on(intensity, metrics.device))
    adapt_mean = global_mean + light_adapt * (pixel_rgb - global_mean)
    return torch.pow(adapt_mean / exposure, map_key)


def _to_uint8(x: torch.Tensor) -> torch.Tensor:
    """round(x * 255) (half to even), clamped, as uint8."""
    return torch.clamp(torch.round(x * 255.0), 0.0, 255.0).to(torch.uint8)


def _finish(tonemapped: torch.Tensor, gamma: float, vibrance: float) -> torch.Tensor:
    """Shared gamma + vibrance + uint8 tail."""
    gamma_corrected = torch.pow(torch.clamp(tonemapped, min=0.0), 1.0 / gamma)
    return _to_uint8(modify_vibrance(gamma_corrected, vibrance))


# ACES fitted RRT+ODT matrices
_ACES_INPUT = np.array(
    [[0.59719, 0.35458, 0.04823], [0.07600, 0.90834, 0.01566], [0.02840, 0.13383, 0.83777]],
    dtype=np.float32,
)
_ACES_OUTPUT = np.array(
    [[1.60475, -0.53108, -0.07367], [-0.10208, 1.10813, -0.00605], [-0.00327, -0.07276, 1.07602]],
    dtype=np.float32,
)


def _rrt_and_odt_fit(v: torch.Tensor) -> torch.Tensor:
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return a / b


def _aces_curve(rgb: torch.Tensor) -> torch.Tensor:
    return color_transform_3x3(_rrt_and_odt_fit(color_transform_3x3(rgb, _ACES_INPUT)),
                               _ACES_OUTPUT)


def _exposed(rgb: torch.Tensor, params: TonemapParameters, metrics) -> torch.Tensor:
    """The curve's input: rgb * 2^intensity, or rgb over the per-pixel
    adaptation value when metrics are given."""
    if metrics is None:
        # constants through pinned memory: a tensor made on the card from a
        # Python number makes the host wait for it
        exposure = torch.pow(scalar_on(2.0, rgb.device), scalar_on(params.intensity, rgb.device))
        return rgb * exposure
    return rgb / _compute_adaptation(metrics, rgb, params.light_adapt, params.intensity)


def aces_tonemap(image: torch.Tensor, params: TonemapParameters,
                 metrics: torch.Tensor | None = None) -> torch.Tensor:
    """ACES: plain (exposure 2^intensity) or adaptive when metrics given."""
    rgb = check_channels_last(image.to(torch.float32), 'image')
    return _finish(_aces_curve(_exposed(rgb, params, metrics)), params.gamma, params.vibrance)


__all__ = ['TonemapParameters', 'aces_tonemap', 'compute_image_bounds', 'compute_image_metrics']
