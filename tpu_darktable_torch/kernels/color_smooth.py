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

from . import launch
from ..ops._stencil import Shifter, median9


def color_smooth_diffs(diffs: torch.Tensor, g: torch.Tensor, *, n_passes: int) -> torch.Tensor:
    """(2, H, W) float32 (R-G, B-G) planes and the (H, W) raw green plane ->
    the (2, H, W) planes after `n_passes` passes; the caller rebuilds each
    channel as d + max(g, 0)."""
    if diffs.dtype != torch.float32 or diffs.ndim != 3 or diffs.shape[0] != 2:
        raise RuntimeError(f'diffs must be (2, H, W) float32, got {diffs.dtype} {tuple(diffs.shape)}')
    if g.dtype != torch.float32 or tuple(g.shape) != tuple(diffs.shape[1:]):
        raise RuntimeError(f'g must be (H, W) float32 matching diffs, got {g.dtype} {tuple(g.shape)}')
    if g.device != diffs.device:
        raise RuntimeError(f'diffs on {diffs.device} but g on {g.device}')
    if not 1 <= n_passes <= 32:
        raise ValueError(f'n_passes must be in [1, 32], got {n_passes}')
    if diffs.device.type == 'cpu':
        return color_smooth_diffs_plain(diffs, g, n_passes=n_passes)
    d = diffs.contiguous()
    _, h, w = d.shape
    out = torch.empty_like(d)
    launch('color_smooth_diffs', d.device, d, g.contiguous(), out, h, w, n_passes)
    return out


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
