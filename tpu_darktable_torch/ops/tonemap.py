"""Tone mapping and image statistics (counterpart of
tpu_darktable/ops/tonemap.py): bounds and metrics over strided samples,
the adaptation value, ACES (plain and adaptive), Reinhard, and the shared
gamma + vibrance + uint8 tail.  Everything keeps its results on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._validate import check_channels_last
from .color import color_transform_3x3, modify_vibrance, rgb_to_gray


@dataclass(frozen=True)
class TonemapParameters:
    gamma: float = 1.0
    intensity: float = 0.0
    light_adapt: float = 0.8
    vibrance: float = 0.0


def _as_batch(images: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) or (..., H, W, 3) tensor -> (B, H, W, 3)."""
    arr = check_channels_last(images, 'images')
    if arr.ndim == 3:
        arr = arr[None]
    elif arr.ndim < 3:
        raise RuntimeError(f'images must be (H, W, 3) or batched, got shape {tuple(arr.shape)}')
    return arr.reshape((-1,) + tuple(arr.shape[-3:]))


def compute_image_bounds(images: torch.Tensor, stride: int = 8) -> torch.Tensor:
    """(2,) float32 [min, max] over strided pixels of an image set."""
    sampled = _as_batch(images)[:, ::stride, ::stride]
    return torch.stack((sampled.min(), sampled.max())).to(torch.float32)


def compute_image_metrics(images: torch.Tensor, stride: int = 8, min_gray: float = 1e-4) -> torch.Tensor:
    """(5,) [log_mean, linear_mean, rgb_mean r, g, b] over strided pixels,
    masking pixels with any channel >= 0.99, normalized by the valid count
    on the device."""
    sampled = _as_batch(images)[:, ::stride, ::stride].to(torch.float32)
    scaled = (sampled - 0.0) / (1.0 - 0.0 + 1e-6)
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
    exposure = torch.exp(torch.tensor(intensity, dtype=torch.float32, device=metrics.device))
    adapt_mean = global_mean + light_adapt * (pixel_rgb - global_mean)
    return torch.pow(adapt_mean / exposure, map_key)


def _to_uint8(x: torch.Tensor) -> torch.Tensor:
    """round(x * 255) (half to even), clamped, as uint8."""
    return torch.clamp(torch.round(x * 255.0), 0.0, 255.0).to(torch.uint8)


def _finish(tonemapped: torch.Tensor, gamma: float, vibrance: float) -> torch.Tensor:
    """Shared gamma + vibrance + uint8 tail."""
    gamma_corrected = torch.pow(torch.clamp(tonemapped, min=0.0), 1.0 / gamma)
    return _to_uint8(modify_vibrance(gamma_corrected, vibrance))


def reinhard_tonemap(image: torch.Tensor, metrics: torch.Tensor,
                     params: TonemapParameters) -> torch.Tensor:
    """Adaptive Reinhard rgb / (adapt + rgb)."""
    rgb = check_channels_last(image.to(torch.float32), 'image')
    adapt = _compute_adaptation(metrics, rgb, params.light_adapt, params.intensity)
    return _finish(rgb / (adapt + rgb), params.gamma, params.vibrance)


# ACES fitted RRT+ODT matrices
_ACES_INPUT = np.array(
    [[0.59719, 0.35458, 0.04823], [0.07600, 0.90834, 0.01566], [0.02840, 0.13383, 0.83777]],
    dtype=np.float32,
)
_ACES_OUTPUT = np.array(
    [[1.60475, -0.53108, -0.07367], [-0.10208, 1.10813, -0.00605], [-0.00327, -0.07276, 1.07602]],
    dtype=np.float32,
)


def _aces_curve(rgb: torch.Tensor) -> torch.Tensor:
    v = color_transform_3x3(rgb, _ACES_INPUT)
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return color_transform_3x3(a / b, _ACES_OUTPUT)


def aces_tonemap(image: torch.Tensor, params: TonemapParameters,
                 metrics: torch.Tensor | None = None) -> torch.Tensor:
    """ACES: plain (exposure 2^intensity) or adaptive when metrics given."""
    rgb = check_channels_last(image.to(torch.float32), 'image')
    if metrics is None:
        exposure = torch.pow(torch.tensor(2.0, device=rgb.device),
                             torch.tensor(params.intensity, dtype=torch.float32, device=rgb.device))
        tonemapped = _aces_curve(rgb * exposure)
    else:
        tonemapped = _aces_curve(rgb / _compute_adaptation(
            metrics, rgb, params.light_adapt, params.intensity))
    return _finish(tonemapped, params.gamma, params.vibrance)


__all__ = [
    'TonemapParameters',
    'aces_tonemap',
    'compute_image_bounds',
    'compute_image_metrics',
    'reinhard_tonemap',
]
