"""Bilateral-grid blur: wrapper of csrc/grid_blur.cu and its plain version.

Replaces the TPU kernel tpu_darktable/kernels/grid_blur.py:grid_blur_xyz:
5-tap gaussian along x, then y, then a 5-tap z blur (derivative or
gaussian) of a (gz, gy, gx) grid, zero outside the grid on every axis.

On the H100 the blur is bound by bytes: one read and one write of the
grid (8 bytes a cell) against ~25 float ops a cell.  The kernel walks z
over an x/y tile, staging each slab with its 2-cell halo in shared memory
while the previous one is blurred and keeping the z sums in registers, so
the grid crosses HBM once each way instead of three times; it takes any
grid size.
"""

from __future__ import annotations

import torch

from . import launch

W_GAUSS = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
W_DERIV = (-2.0 / 16.0, -4.0 / 16.0, 0.0, 4.0 / 16.0, 2.0 / 16.0)
Z_MODES = ('derivative', 'gaussian')


def grid_blur_xyz(grid: torch.Tensor, *, z_mode: str = 'derivative') -> torch.Tensor:
    """(gz, gy, gx) float32 contiguous grid -> the blurred grid, same shape."""
    if grid.dtype != torch.float32 or grid.ndim != 3:
        raise RuntimeError(f'grid must be a 3-D float32 tensor, got {grid.dtype} {tuple(grid.shape)}')
    if not grid.is_contiguous():
        raise RuntimeError('grid must be contiguous')
    if z_mode not in Z_MODES:
        raise ValueError(f'z_mode must be one of {Z_MODES}, got {z_mode!r}')
    if grid.device.type == 'cpu':
        return grid_blur_xyz_plain(grid, z_mode=z_mode)
    out = torch.empty_like(grid)
    launch('grid_blur_xyz', grid.device, grid, out, *grid.shape, int(z_mode == 'gaussian'))
    return out


def _blur5(grid: torch.Tensor, axis: int, weights) -> torch.Tensor:
    """5-tap correlation along `axis` with zero boundary (truncated taps)."""
    pads = [0, 0] * grid.ndim
    pads[2 * (grid.ndim - 1 - axis)] = 2
    pads[2 * (grid.ndim - 1 - axis) + 1] = 2
    p = torch.nn.functional.pad(grid, pads)
    n = grid.shape[axis]
    out = 0.0
    for t, wt in enumerate(weights):
        if wt == 0.0:
            continue
        out = out + wt * p.narrow(axis, t, n)
    return out


def grid_blur_xyz_plain(grid: torch.Tensor, *, z_mode: str = 'derivative') -> torch.Tensor:
    """Plain PyTorch version: three passes, x, y, then z."""
    grid = _blur5(grid, 2, W_GAUSS)
    grid = _blur5(grid, 1, W_GAUSS)
    return _blur5(grid, 0, W_DERIV if z_mode == 'derivative' else W_GAUSS)


__all__ = ['grid_blur_xyz', 'grid_blur_xyz_plain']
