# Frozen copy of tpu_darktable_torch/pipeline/util.py (plain PyTorch paths only), kept
# as the benchmark's reference; it imports nothing of the measured package.
"""Small pipeline utilities (counterpart of tpu_darktable/pipeline/util.py)."""

from __future__ import annotations


def lerp(a, b, t):
    """a + (b - a) * t."""
    return a + (b - a) * t


def normalize_image(rgb_raw, bounds):
    """(x - lo) / (hi - lo)."""
    return (rgb_raw - bounds[0]) / (bounds[1] - bounds[0])


__all__ = ['lerp', 'normalize_image']
