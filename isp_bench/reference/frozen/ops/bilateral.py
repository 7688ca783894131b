# Frozen copy of tpu_darktable_torch/ops/bilateral.py (plain PyTorch paths only), kept
# as the benchmark's reference; it imports nothing of the measured package.
"""Bilateral-grid local contrast boost and denoise on luminance
(counterpart of tpu_darktable/ops/bilateral.py).

The x/y grid coordinates are data-independent (pos / sigma_s), so the
spatial splat is a fixed banded operator per axis, applied as a windowed
gather (`index_select`) with the clamped tail added as a plain sum; only
the z coordinate depends on the data, and the grid is built one z slab at
a time.  Two paths compute the detail boost:

- the integer fast path (sigma_s an integer dividing the frame): the
  whole detail term in one launch of kernels/bilateral_band.py;
- the general path (any other sigma_s or frame): windowed splat, the grid
  blur of kernels/grid_blur.py, and a gathered trilinear slice.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import device_cache
from ..kernels.bilateral_band import bilateral_band
from ..kernels.grid_blur import grid_blur_xyz

_F32 = torch.float32


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


def _axis_splat_operator(n_pixels: int, n_cells: int, sigma: float):
    """Static windowed splat weights for one spatial axis.

    Pixel p lands at g = clamp(p/sigma, 0, n_cells-1), contributing
    (1-frac) to cell ib = min(floor(g), n_cells-2) and frac to ib+1.
    Returns (idx, wgt, tail_start) with (idx, wgt) of shape (n_cells, M):
    cell c accumulates sum_m wgt[c, m] * value[idx[c, m]].  Pixels from
    tail_start on clamp onto the last cell with weight 1.0; they are left
    out of the window and the caller adds their plain sum to that cell.
    """
    p = np.arange(n_pixels, dtype=np.float64)
    g = np.clip(p / sigma, 0.0, n_cells - 1)
    ib = np.minimum(g.astype(np.int64), n_cells - 2)
    frac = (g - ib).astype(np.float32)
    # g is nondecreasing: everything from the first g == n_cells-1 on is tail
    tail_start = int(np.searchsorted(g, n_cells - 1, side='left'))
    in_window = np.arange(n_pixels) < tail_start

    m_width = int(np.ceil(sigma)) + 2
    idx = np.zeros((n_cells, m_width), dtype=np.int32)
    wgt = np.zeros((n_cells, m_width), dtype=np.float32)
    for c in range(n_cells):
        members = np.nonzero(((ib == c - 1) | (ib == c)) & in_window)[0]
        if len(members) > m_width:  # widen if needed (fractional-sigma jitter)
            extra = len(members) - m_width
            idx = np.pad(idx, ((0, 0), (0, extra)))
            wgt = np.pad(wgt, ((0, 0), (0, extra)))
            m_width = len(members)
        for m, px in enumerate(members):
            idx[c, m] = px
            wgt[c, m] = frac[px] if ib[px] == c - 1 else 1.0 - frac[px]
    return idx, wgt, tail_start


def _axis_slice_weights(n_pixels: int, n_cells: int, sigma: float):
    """Static gather weights for slicing: pixel p reads cells ib, ib+1."""
    p = np.arange(n_pixels, dtype=np.float64)
    g = np.clip(p / sigma, 0.0, n_cells - 1)
    ib = np.minimum(g.astype(np.int64), n_cells - 2).astype(np.int32)
    frac = (g - ib).astype(np.float32)
    return ib, frac


class _Windowed:
    """The general path's splat and slice operators for one frame geometry,
    as tensors on one device."""

    def __init__(self, h: int, w: int, gx: int, gy: int, sigma_s: float, dev: torch.device):
        self.h, self.w, self.gx, self.gy = h, w, gx, gy
        idx_x, wgt_x, self.tail_x = _axis_splat_operator(w, gx, sigma_s)
        idx_y, wgt_y, self.tail_y = _axis_splat_operator(h, gy, sigma_s)
        t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=dev)
        self.idx_x, self.wgt_x = t(idx_x.reshape(-1), torch.int64), t(wgt_x)
        self.idx_y, self.wgt_y = t(idx_y.reshape(-1), torch.int64), t(wgt_y)
        ib_x, frac_x = _axis_slice_weights(w, gx, sigma_s)
        ib_y, frac_y = _axis_slice_weights(h, gy, sigma_s)
        self.ib_x, self.frac_x = t(ib_x, torch.int64), t(frac_x)
        self.ib_y, self.frac_y = t(ib_y, torch.int64), t(frac_y)

    def splat(self, img: torch.Tensor) -> torch.Tensor:
        """Separable spatial splat of an (H, W) map -> (gy, gx), with the
        clamped tails added to the last cell as plain sums."""
        h, gx, gy = self.h, self.gx, self.gy
        gathered = img.index_select(1, self.idx_x).reshape(h, gx, -1)
        sx = torch.sum(gathered * self.wgt_x[None], dim=-1)
        if self.tail_x < self.w:
            sx = torch.cat([sx[:, :-1],
                            sx[:, -1:] + img[:, self.tail_x:].sum(dim=1, keepdim=True)], dim=1)
        gathered = sx.index_select(0, self.idx_y).reshape(gy, -1, gx)
        out = torch.sum(gathered * self.wgt_y[:, :, None], dim=1)
        if self.tail_y < h:
            out = torch.cat([out[:-1],
                             out[-1:] + sx[self.tail_y:].sum(dim=0, keepdim=True)], dim=0)
        return out

    def slice(self, slab: torch.Tensor) -> torch.Tensor:
        """Bilinear sample of a (gy, gx) slab at every pixel -> (H, W)."""
        fy, fx = self.frac_y[:, None], self.frac_x[None, :]
        r0 = slab.index_select(0, self.ib_y)
        r1 = slab.index_select(0, self.ib_y + 1)
        ry = r0 * (1.0 - fy) + r1 * fy
        c0 = ry.index_select(1, self.ib_x)
        c1 = ry.index_select(1, self.ib_x + 1)
        return c0 * (1.0 - fx) + c1 * fx


@device_cache(maxsize=16)
def _windowed(h: int, w: int, gx: int, gy: int, sigma_s: float, dev: torch.device) -> _Windowed:
    """The operators of one geometry, built once (the pipeline calls the
    bilateral stage every frame)."""
    return _Windowed(h, w, gx, gy, sigma_s, dev)


def _z_coords(lum: torch.Tensor, sigma_r: float, gz: int):
    """Per-pixel grid z, and the lower cell and fraction of the slice."""
    g_z = torch.clamp(lum / sigma_r, 0.0, gz - 1)
    ib_z = torch.clamp(g_z.to(torch.int32), max=gz - 2)
    return g_z, ib_z, g_z - ib_z.to(_F32)


def _slice_weight(ib_z: torch.Tensor, frac_z: torch.Tensor, z: int) -> torch.Tensor:
    return torch.where(ib_z == z, 1.0 - frac_z, torch.where(ib_z + 1 == z, frac_z, 0.0))


def _as_plane(luminance) -> torch.Tensor:
    lum = torch.as_tensor(luminance).to(_F32)
    if lum.ndim != 2:
        raise RuntimeError(f'luminance must be a 2-D (H, W) plane, got shape {tuple(lum.shape)}')
    return lum


def bilateral_process(luminance: torch.Tensor, sigma_s: float, sigma_r: float,
                      detail: float) -> torch.Tensor:
    """Detail boost on an (H, W) luminance plane; returns the processed plane.

    The JAX package's fast path has a switch between two TPU generations of
    its kernel; the port has one kernel there and no switch."""
    lum = _as_plane(luminance)
    h, w = lum.shape
    gx, gy, gz = compute_grid_size(w, h, sigma_s, sigma_r)
    norm = -detail * sigma_r * 4.0
    s_int = int(sigma_s)
    fast = (
        float(sigma_s) == s_int and s_int >= 1 and w % s_int == 0 and h % s_int == 0
        and gx == w // s_int + 1 and gy == h // s_int + 1
    )
    if fast:
        l_diff = bilateral_band(lum, s=s_int, gz=gz, sigma_r=float(sigma_r))
        return torch.clamp(lum + norm * l_diff, min=0.0)

    op = _windowed(h, w, gx, gy, float(sigma_s), lum.device)
    g_z, ib_z, frac_z = _z_coords(lum, sigma_r, gz)
    contrib = 1.0 / (sigma_s * sigma_s)
    grid = torch.stack([op.splat(torch.clamp(1.0 - torch.abs(g_z - z), min=0.0) * contrib)
                        for z in range(gz)])
    grid = grid_blur_xyz(grid, z_mode='derivative')
    l_diff = torch.zeros_like(lum)
    for z in range(gz):
        l_diff = l_diff + _slice_weight(ib_z, frac_z, z) * op.slice(grid[z])
    return torch.clamp(lum + norm * l_diff, min=0.0)


__all__ = ['bilateral_process', 'compute_grid_size']
