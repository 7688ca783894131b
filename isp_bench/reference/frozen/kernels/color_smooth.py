# Frozen copy of tpu_darktable_torch/kernels/color_smooth.py (plain PyTorch paths only), kept
# as the benchmark's reference; it imports nothing of the measured package.
"""Colour-smoothing median cascade: wrapper of csrc/color_smooth.cu and its
plain version.

Replaces the TPU kernel tpu_darktable/kernels/color_smooth.py:color_smooth_diffs
(N sequential 3x3 median passes over the two (C - G) difference planes,
zero fill outside the image renewed every pass).

On the H100 the cascade is bound by bytes: one read of the two diff planes
and g and one write of the two planes (20 bytes a pixel) outweigh the ~21
operations a pixel, plane and pass of a median taken as a selection over
sorted columns.  The kernel runs all N passes of a tile (+ N px halo) in
shared memory, both planes in one block, so the N-1 intermediate passes
never reach HBM and g is read once.  It only compares and adds like the
plain version, so the two agree bit for bit.
"""

from __future__ import annotations

import torch

from ..ops._stencil import Shifter, median9




def color_smooth_diffs_plain(diffs: torch.Tensor, g: torch.Tensor, *, n_passes: int) -> torch.Tensor:
    """Plain PyTorch version: the recurrence pass by pass, each pass reading
    its 3x3 neighbourhood with zero fill outside the image."""
    gc = torch.clamp(g, min=0.0)
    d = diffs
    for p in range(n_passes):
        s = Shifter(d, 1)
        med = median9([s(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
        d = torch.clamp(med + (g if p == 0 else gc), min=0.0) - gc
    return d


__all__ = ['color_smooth_diffs', 'color_smooth_diffs_plain']


# the reference runs the plain version on every device
color_smooth_diffs = color_smooth_diffs_plain  # noqa: F811
