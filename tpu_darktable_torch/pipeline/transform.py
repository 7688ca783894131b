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

    def next_rotation(self) -> 'ImageTransform':
        """The next transform in the viewer's cycle: the four rotations, then
        the four reflections."""
        rotation_map = {
            ImageTransform.none: ImageTransform.rotate_90,
            ImageTransform.rotate_90: ImageTransform.rotate_180,
            ImageTransform.rotate_180: ImageTransform.rotate_270,
            ImageTransform.rotate_270: ImageTransform.none,
            ImageTransform.transpose: ImageTransform.flip_horiz,
            ImageTransform.flip_horiz: ImageTransform.flip_vert,
            ImageTransform.flip_vert: ImageTransform.transverse,
            ImageTransform.transverse: ImageTransform.transpose,
        }
        return rotation_map.get(self, ImageTransform.rotate_90)


def transformed_size(original_size: tuple[int, int], transform: ImageTransform) -> tuple[int, int]:
    """(w, h) of an image of `original_size` after `transform`."""
    if transform in {ImageTransform.rotate_90, ImageTransform.rotate_270, ImageTransform.transpose}:
        return (original_size[1], original_size[0])
    return original_size


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


__all__ = ['ImageTransform', 'transform', 'transformed_size']
