"""Bilateral-grid local contrast boost on luminance (counterpart of
tpu_darktable/ops/bilateral.py:58-76 and 193-375).

Only the integer-sigma_s fast path is ported: sigma_s an integer that
divides the frame, with the grid (gz, H/s + 1, W/s + 1).  There the detail
term l_diff comes from kernels/bilateral_band.py (the hand kernel on the
card, its plain version on the CPU).
"""

from __future__ import annotations

import math

import torch

from ..kernels.bilateral_band import bilateral_band


def compute_grid_size(width: int, height: int, sigma_s: float, sigma_r: float):
    """(X, Y, Z) grid dims, as the reference sizes them."""
    ss = max(sigma_s, 0.5)
    l_range = 1.0

    def _clamp(v, lo, hi):
        return min(max(v, lo), hi)

    gx = _clamp(round(width / ss), 4.0, 3000.0)
    gy = _clamp(round(height / ss), 4.0, 3000.0)
    gz = _clamp(round(l_range / sigma_r), 4.0, 50.0)
    eff_sigma_s = max(height / gy, width / gx)
    eff_sigma_r = l_range / gz
    return (
        int(math.ceil(width / eff_sigma_s)) + 1,
        int(math.ceil(height / eff_sigma_s)) + 1,
        int(math.ceil(l_range / eff_sigma_r)) + 1,
    )


def bilateral_process(luminance: torch.Tensor, sigma_s: float, sigma_r: float,
                      detail: float) -> torch.Tensor:
    """Detail boost on an (H, W) luminance plane; returns the processed plane."""
    lum = luminance.to(torch.float32)
    if lum.ndim != 2:
        raise RuntimeError(f'luminance must be a 2-D (H, W) plane, got shape {tuple(lum.shape)}')
    h, w = lum.shape
    gx, gy, gz = compute_grid_size(w, h, sigma_s, sigma_r)
    s_int = int(sigma_s)
    fast = (
        float(sigma_s) == s_int and s_int >= 1 and w % s_int == 0 and h % s_int == 0
        and gx == w // s_int + 1 and gy == h // s_int + 1
    )
    if not fast:
        raise NotImplementedError(
            'bilateral_process: only the integer-sigma_s fast path is ported; the general '
            'windowed path and grid_blur_xyz are ROADMAP Queue 2 #4 (tpu_darktable_torch)')
    l_diff = bilateral_band(lum, s=s_int, gz=gz, sigma_r=float(sigma_r))
    norm = -detail * sigma_r * 4.0
    return torch.clamp(lum + norm * l_diff, min=0.0)


__all__ = ['bilateral_process', 'compute_grid_size']
