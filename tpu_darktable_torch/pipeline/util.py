"""Small pipeline utilities (counterpart of tpu_darktable/pipeline/util.py)."""

from __future__ import annotations


def lerp(a, b, t):
    """a + (b - a) * t."""
    return a + (b - a) * t


def normalize_image(rgb_raw, bounds):
    """(x - lo) / (hi - lo)."""
    return (rgb_raw - bounds[0]) / (bounds[1] - bounds[0])


def resize_longest_edge(size: tuple[int, int], longest: int) -> tuple[int, int]:
    """(w, h) scaled so the longest edge is `longest`; 0 keeps the size."""
    if longest == 0:
        return size
    if size[0] > size[1]:
        return (longest, size[1] * longest // size[0])
    return (size[0] * longest // size[1], longest)


__all__ = ['lerp', 'normalize_image', 'resize_longest_edge']
