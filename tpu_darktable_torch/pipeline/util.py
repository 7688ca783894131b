"""Small pipeline utilities (counterpart of tpu_darktable/pipeline/util.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def lerp(a, b, t):
    """a + (b - a) * t."""
    return a + (b - a) * t


def normalize_image(rgb_raw, bounds):
    """(x - lo) / (hi - lo)."""
    return (rgb_raw - bounds[0]) / (bounds[1] - bounds[0])


def resize(image: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an (H, W, C) image to size=(h, w) with half-pixel
    centres, as the JAX package's jax.image.resize(method='linear'): an
    axis that shrinks widens the triangle filter by its scale (antialias),
    an axis that grows interpolates.  One axis at a time, each taking
    PyTorch's antialiased filter only where it shrinks: that filter's
    upscale weights round otherwise (7e-6 from JAX at 1.25x)."""
    h, w = size
    x = image.permute(2, 0, 1)[None]
    for size_hw, shrinks in (((h, x.shape[-1]), h < x.shape[-2]), ((h, w), w < x.shape[-1])):
        x = F.interpolate(x, size=size_hw, mode='bilinear', align_corners=False,
                          antialias=shrinks)
    return x[0].permute(1, 2, 0)


def resize_longest_edge(size: tuple[int, int], longest: int) -> tuple[int, int]:
    """(w, h) scaled so the longest edge is `longest`; 0 keeps the size."""
    if longest == 0:
        return size
    if size[0] > size[1]:
        return (longest, size[1] * longest // size[0])
    return (size[0] * longest // size[1], longest)


def resize_image(image: torch.Tensor, longest: int) -> torch.Tensor:
    """Resize an (H, W, C) image so its longest edge is `longest`."""
    h, w = image.shape[:2]
    tw, th = resize_longest_edge((w, h), longest)
    return resize(image, (th, tw))


__all__ = ['lerp', 'normalize_image', 'resize', 'resize_image', 'resize_longest_edge']
