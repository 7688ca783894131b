# Frozen copy of tpu_darktable_torch/kernels/bilateral_band.py (plain PyTorch paths only), kept
# as the benchmark's reference; it imports nothing of the measured package.
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

from .grid_blur import grid_blur_xyz_plain


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


# the reference runs the plain version on every device
bilateral_band = bilateral_band_plain  # noqa: F811
