# Frozen copy of tpu_darktable_torch/pipeline/transform.py (plain PyTorch paths only), kept
# as the benchmark's reference; it imports nothing of the measured package.
"""Per-camera orientation transforms (counterpart of
tpu_darktable/pipeline/transform.py)."""

from __future__ import annotations

from enum import Enum

import torch


class ImageTransform(Enum):
    none = 0
    rotate_90 = 1
    rotate_180 = 2
    rotate_270 = 3
    transpose = 4
    flip_horiz = 5
    flip_vert = 6
    transverse = 7


def transform(image, tf: ImageTransform, xp=torch):
    """Apply an orientation transform over the leading (H, W) axes.

    ``xp`` selects the array module: torch (default, a tensor on its device)
    or numpy (host-side, e.g. the streaming executor's host-entropy path).
    One dispatch table serves every caller, so a new enum member raises here
    instead of diverging between copies.
    """
    match tf:
        case ImageTransform.none:
            return image
        case ImageTransform.rotate_90:
            return xp.rot90(image, 1, (0, 1))
        case ImageTransform.rotate_180:
            return xp.rot90(image, 2, (0, 1))
        case ImageTransform.rotate_270:
            return xp.rot90(image, 3, (0, 1))
        case ImageTransform.flip_horiz:
            return xp.flip(image, (1,))
        case ImageTransform.flip_vert:
            return xp.flip(image, (0,))
        case ImageTransform.transverse:
            return xp.flip(image, (0, 1))
        case ImageTransform.transpose:
            return xp.swapaxes(image, 0, 1)
    raise ValueError(f'Invalid transform: {tf}')


__all__ = ['ImageTransform', 'transform']
