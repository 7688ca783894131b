# Frozen copy of tpu_darktable_torch/ops/postprocess.py (plain PyTorch paths only), kept
# as the benchmark's reference; it imports nothing of the measured package.
"""Demosaic postprocess: colour smoothing + global green equilibration
(counterpart of tpu_darktable/ops/postprocess.py:26-171).

Colour smoothing runs on the two (C - G) difference planes through
kernels/color_smooth.py (the hand kernel on the card, its plain version on
the CPU).  The global green ratio stays a device tensor: no host sync.
"""

from __future__ import annotations

import torch

from ..kernels.color_smooth import color_smooth_diffs
from .bayer import BayerPattern
from ._stencil import row_col_iota, site_masks

_F32 = torch.float32


def color_smoothing(rgb: torch.Tensor, n_passes: int) -> torch.Tensor:
    """N 3x3 median passes on R-G and B-G, G preserved (clamped >= 0).

    Uses the diff-plane recurrence of kernels/color_smooth.py: with
    gc = max(g, 0) the result is C = d_N + gc, bit-identical to N
    passes of the reference's per-pass smoothing."""
    rgb = rgb.to(_F32)
    if n_passes <= 0:
        return rgb
    g_raw = rgb[..., 1].contiguous()
    diffs = torch.stack((rgb[..., 0] - g_raw, rgb[..., 2] - g_raw))
    d_out = color_smooth_diffs(diffs, g_raw, n_passes=n_passes)
    gc = torch.clamp(g_raw, min=0.0)
    return torch.stack((d_out[0] + gc, gc, d_out[1] + gc), dim=-1)


def green_eq_sums(rgb: torch.Tensor, pattern: BayerPattern, rows_in=None):
    """(sum of G at green1 sites, sum at green2 sites) over the even-cropped
    image, or over the rows where the (H, 1) bool `rows_in` holds."""
    h, w = rgb.shape[:2]
    g = rgb[..., 1]
    masks = site_masks(h, w, pattern, rgb.device)
    rows, cols = row_col_iota(h, w, rgb.device)
    inimage = (cols < 2 * (w // 2)) & (rows < 2 * (h // 2)) if rows_in is None else rows_in
    g1 = masks['g'] & ((rows & 1) == 0) & inimage
    g2 = masks['g'] & ((rows & 1) == 1) & inimage
    return torch.sum(torch.where(g1, g, 0.0)), torch.sum(torch.where(g2, g, 0.0))


def green_eq_apply(rgb: torch.Tensor, pattern: BayerPattern, sum1, sum2) -> torch.Tensor:
    """Scale G at green1 sites by sum2 / sum1 (1 where either is 0)."""
    h, w = rgb.shape[:2]
    g = rgb[..., 1]
    masks = site_masks(h, w, pattern, rgb.device)
    rows, _ = row_col_iota(h, w, rgb.device)
    ratio = torch.where((sum1 > 0.0) & (sum2 > 0.0), sum2 / torch.clamp(sum1, min=1e-30),
                        torch.ones((), dtype=_F32, device=rgb.device))
    is_green1 = masks['g'] & ((rows & 1) == 0)
    new_g = torch.where(is_green1, g * ratio, g)
    return torch.clamp(torch.stack((rgb[..., 0], new_g, rgb[..., 2]), dim=-1), min=0.0)


def green_eq_global(rgb: torch.Tensor, pattern: BayerPattern) -> torch.Tensor:
    """Scale G at green1 (even-row) sites by sum(G2)/sum(G1), sums over the
    even-cropped image."""
    rgb = rgb.to(_F32)
    return green_eq_apply(rgb, pattern, *green_eq_sums(rgb, pattern))


def postprocess(rgb: torch.Tensor, pattern: BayerPattern, color_smoothing_passes: int = 0,
                green_eq_global_enabled: bool = False) -> torch.Tensor:
    """N smoothing passes -> global green equilibration (the pipeline runs
    no local green equilibration, whose copy is left out)."""
    out = color_smoothing(rgb.to(_F32), color_smoothing_passes)
    if green_eq_global_enabled:
        out = green_eq_global(out, pattern)
    return out


__all__ = ['color_smoothing', 'green_eq_global', 'postprocess']
