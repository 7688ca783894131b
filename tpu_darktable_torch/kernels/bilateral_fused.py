"""Fused bilateral-grid detail term: wrapper of csrc/bilateral_fused.cu and
its plain version.

Replaces the TPU kernel tpu_darktable/kernels/bilateral_fused.py:bilateral_fused:
for an integer sigma_s = s dividing the frame, z-tent splat -> 5-tap
gaussian x, gaussian y, derivative or gaussian z (zero truncation after
every pass) -> trilinear slice, giving l_diff at (H, W).  With the
derivative z blur it is the function of kernels/bilateral_band.py, which
launches the same source; this wrapper alone takes `z_mode`.

On the H100 the function's floor is its ~94 float ops a pixel (s=2, gz=6),
just above its 8 bytes a pixel.  The kernel is one launch: each block
builds the grid cells its pixel tile slices, plus a 2-cell blur halo, for
every z slab in shared memory, so the grid never crosses HBM; the price is
the halo's recompute.  The TPU kernel's s^2 phase planes are not needed:
the kernel reads lum and writes l_diff at (H, W).
"""

from __future__ import annotations

import torch

from .bilateral_band import bilateral_band_plain, check_plane, launch_detail_term
from .grid_blur import Z_MODES


def bilateral_fused(lum: torch.Tensor, *, s: int, gz: int, sigma_r: float,
                    z_mode: str = 'derivative') -> torch.Tensor:
    """(H, W) float32 luminance -> (H, W) float32 l_diff on the
    (gz, H/s + 1, W/s + 1) grid; H and W must divide by s."""
    check_plane(lum, s, gz)
    if z_mode not in Z_MODES:
        raise ValueError(f'z_mode must be one of {Z_MODES}, got {z_mode!r}')
    if lum.device.type == 'cpu':
        return bilateral_fused_plain(lum, s=s, gz=gz, sigma_r=sigma_r, z_mode=z_mode)
    return launch_detail_term('bilateral_fused', lum, s, gz, sigma_r,
                              z_gauss=z_mode == 'gaussian')


def bilateral_fused_plain(lum: torch.Tensor, *, s: int, gz: int, sigma_r: float,
                          z_mode: str = 'derivative') -> torch.Tensor:
    """Plain PyTorch version.  The kernel sums in the order of
    bilateral_band's plain chain (x splat then y splat by phase, taps
    ascending, the slice's y then x then z), so this IS that chain with the
    z taps of `z_mode`: one plain version serves both wrappers, and holding
    one name against the other checks nothing."""
    return bilateral_band_plain(lum, s=s, gz=gz, sigma_r=sigma_r, z_mode=z_mode)


__all__ = ['bilateral_fused', 'bilateral_fused_plain']
