"""Bilateral-grid detail term: wrapper of the one-launch kernel in
csrc/bilateral_fused.cu (with the derivative z blur) and the plain version.

Replaces the TPU kernel tpu_darktable/kernels/bilateral_band.py:bilateral_band
(+ riffle_phases): for an integer sigma_s = s dividing the frame, z-tent
splat -> 5-tap gaussian x, gaussian y, derivative z (zero truncation) ->
trilinear slice, giving l_diff at (H, W).

In the JAX package bilateral_band and bilateral_fused are two generations
of one band-resident fusion that differ in their TPU lane layout.  On the
H100 the function has one good design, so both wrappers launch the same
source: a block builds the grid cells its pixel tile slices, plus the blur
halo, in shared memory, and the grid never crosses HBM.  The function's
floor is its ~94 float ops a pixel (s=2, gz=6), just above its 8 bytes a
pixel (lum read once, l_diff written once).  This module keeps the plain
version both wrappers are held against.
"""

from __future__ import annotations

import torch

from . import launch
from .grid_blur import grid_blur_xyz_plain


def check_plane(lum: torch.Tensor, s: int, gz: int) -> None:
    if lum.dtype != torch.float32 or lum.ndim != 2:
        raise RuntimeError(f'lum must be a 2-D float32 tensor, got {lum.dtype} {tuple(lum.shape)}')
    h, w = lum.shape
    if s < 1 or h % s or w % s:
        raise ValueError(f'sigma_s {s} must divide the frame {h}x{w}')
    if gz < 2:
        raise ValueError(f'gz must be >= 2, got {gz}')


def launch_detail_term(name: str, lum: torch.Tensor, s: int, gz: int, sigma_r: float,
                       z_gauss: bool) -> torch.Tensor:
    """One launch of csrc/bilateral_fused.cu on a plane, counted under
    `name`."""
    x = lum.contiguous()
    out = torch.empty_like(x)
    launch(name, x.device, x, out, *x.shape, s, gz, float(sigma_r), int(z_gauss))
    return out


def bilateral_band(lum: torch.Tensor, *, s: int, gz: int, sigma_r: float) -> torch.Tensor:
    """(H, W) float32 luminance -> (H, W) float32 l_diff on the
    (gz, H/s + 1, W/s + 1) grid; H and W must divide by s."""
    check_plane(lum, s, gz)
    if lum.device.type == 'cpu':
        return bilateral_band_plain(lum, s=s, gz=gz, sigma_r=sigma_r)
    return launch_detail_term('bilateral_band', lum, s, gz, sigma_r, z_gauss=False)


def _splat_axis(img: torch.Tensor, axis: int, n_cells: int, s: int) -> torch.Tensor:
    """Tent splat along `axis` by s strided slices: phase m of cell c gets
    weight 1 - m/s, phase m of cell c - 1 gets m/s."""
    img = img.movedim(axis, -1)
    out = 0.0
    for m in range(s):
        sl = img[..., m::s]
        k = sl.shape[-1]
        f = m / s
        out = out + torch.nn.functional.pad(sl * (1.0 - f), (0, n_cells - k))
        if f > 0.0:
            out = out + torch.nn.functional.pad(sl * f, (1, n_cells - k - 1))
    return out.movedim(-1, axis)


def bilateral_band_plain(lum: torch.Tensor, *, s: int, gz: int, sigma_r: float,
                         z_mode: str = 'derivative') -> torch.Tensor:
    """Plain PyTorch version: the JAX package's XLA chain on the integer
    fast path (ops/bilateral.py), slab by slab."""
    h, w = lum.shape
    gy, gx = h // s + 1, w // s + 1
    g_z = torch.clamp(lum / sigma_r, 0.0, gz - 1)
    contrib = 1.0 / (s * s)
    slabs = []
    for z in range(gz):
        wz = torch.clamp(1.0 - torch.abs(g_z - z), min=0.0)
        slabs.append(_splat_axis(_splat_axis(wz * contrib, 1, gx, s), 0, gy, s))
    grid = torch.stack(slabs)
    grid = grid_blur_xyz_plain(grid, z_mode=z_mode)

    ib_z = torch.clamp(g_z.to(torch.int32), max=gz - 2)
    frac_z = g_z - ib_z.to(torch.float32)
    frac = torch.arange(s, dtype=torch.float32, device=lum.device) / s
    frac_row = frac.repeat(h // s)[:, None]
    frac_col = frac.repeat(w // s)[None, :]

    def xy_slice(slab):
        r0 = torch.repeat_interleave(slab[:-1], s, dim=0)
        r1 = torch.repeat_interleave(slab[1:], s, dim=0)
        ry = r0 * (1.0 - frac_row) + r1 * frac_row
        c0 = torch.repeat_interleave(ry[:, :-1], s, dim=1)
        c1 = torch.repeat_interleave(ry[:, 1:], s, dim=1)
        return c0 * (1.0 - frac_col) + c1 * frac_col

    l_diff = torch.zeros_like(lum)
    for z in range(gz):
        wz = torch.where(ib_z == z, 1.0 - frac_z, torch.where(ib_z + 1 == z, frac_z, 0.0))
        l_diff = l_diff + wz * xy_slice(grid[z])
    return l_diff


__all__ = ['bilateral_band', 'bilateral_band_plain']
