# Frozen copy of tpu_darktable_torch/ops/demosaic.py (plain PyTorch paths only), kept
# as the benchmark's reference; it imports nothing of the measured package.
"""Demosaic: PPG's green and red/blue steps and the border ladder that RCD
runs on its edge strips (counterpart of tpu_darktable/ops/demosaic.py).  Each
algorithm is a function of an (H, W) Bayer mosaic built from shifted views
(ops/_stencil.py); the boundary rules (zero-filled reads, border rings, the
pass-through edge) are the reference's.
"""

from __future__ import annotations

import torch

from .._device import constant_on
from .._validate import as_mosaic
from .bayer import BayerPattern, fc, fc_tile
from ._stencil import Shifter, row_col_iota, site_masks

_F32 = torch.float32


def _tile2x2_map(h: int, w: int, tile, device) -> torch.Tensor:
    """Expand a (2, 2) table into an (h, w) map by row/column parity."""
    t = constant_on(tile, device)
    return t.repeat((h + 1) // 2, (w + 1) // 2)[:h, :w]


def _code_masks(h: int, w: int, pattern: BayerPattern, device) -> dict[int, torch.Tensor]:
    """fc-code -> boolean map; codes 0..3 with 3 = the green site on odd
    rows (the reference splits greens by row parity)."""
    tile = fc_tile(pattern)
    rows, cols = row_col_iota(h, w, device)
    rp, cp = rows & 1, cols & 1
    masks = {}
    for code in range(4):
        m = torch.zeros((h, w), dtype=torch.bool, device=device)
        for pr in range(2):
            for pc in range(2):
                eff = 3 if (tile[pr, pc] == 1 and pr == 1) else tile[pr, pc]
                if eff == code:
                    m = m | ((rp == pr) & (cp == pc))
        masks[code] = m
    return masks


def border_interpolate(image: torch.Tensor, pattern: BayerPattern, border: int) -> torch.Tensor:
    """3x3 per-channel averaging; returns a full (H, W, 3) image and the
    caller selects the `border`-wide ring."""
    x = as_mosaic(image, 'image', dtype=_F32)
    h, w = x.shape
    pos = torch.clamp(x, min=0.0)
    masks = _code_masks(h, w, pattern, x.device)

    sums, counts = {}, {}
    for code in range(4):
        m = masks[code].to(_F32)
        sm = Shifter(pos * m, 1)
        cm = Shifter(m, 1)
        ssum = 0.0
        csum = 0.0
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ssum = ssum + sm(dy, dx)
                csum = csum + cm(dy, dx)
        sums[code] = ssum
        counts[code] = csum

    i = pos
    o_r = torch.where(counts[0] > 0, sums[0] / torch.clamp(counts[0], min=1.0), i)
    cg = counts[1] + counts[3]
    o_g = torch.where(cg > 0, (sums[1] + sums[3]) / torch.clamp(cg, min=1.0), i)
    o_b = torch.where(counts[2] > 0, sums[2] / torch.clamp(counts[2], min=1.0), i)

    o_r = torch.where(masks[0], i, o_r)
    o_g = torch.where(masks[1] | masks[3], i, o_g)
    o_b = torch.where(masks[2], i, o_b)
    return torch.stack((o_r, o_g, o_b), dim=-1)


def ppg_green(image: torch.Tensor, pattern: BayerPattern, clamp_input: bool = False) -> torch.Tensor:
    """Gradient-weighted green at R/B sites; (H, W, 3) with sparse R/B.
    Only pixels in the [3, size-4] interior are meaningful."""
    x = as_mosaic(image, 'image', dtype=_F32)
    if clamp_input:
        x = torch.clamp(x, min=0.0)
    h, w = x.shape
    s = Shifter(x, 3)
    pc = s(0, 0)

    pym, pym2, pym3 = s(-1, 0), s(-2, 0), s(-3, 0)
    pyM, pyM2, pyM3 = s(1, 0), s(2, 0), s(3, 0)
    pxm, pxm2, pxm3 = s(0, -1), s(0, -2), s(0, -3)
    pxM, pxM2, pxM3 = s(0, 1), s(0, 2), s(0, 3)

    guessx = (pxm + pc + pxM) * 2.0 - pxM2 - pxm2
    diffx = (
        (torch.abs(pxm2 - pc) + torch.abs(pxM2 - pc) + torch.abs(pxm - pxM)) * 3.0
        + (torch.abs(pxM3 - pxM) + torch.abs(pxm3 - pxm)) * 2.0
    )
    guessy = (pym + pc + pyM) * 2.0 - pyM2 - pym2
    diffy = (
        (torch.abs(pym2 - pc) + torch.abs(pyM2 - pc) + torch.abs(pym - pyM)) * 3.0
        + (torch.abs(pyM3 - pyM) + torch.abs(pym3 - pym)) * 2.0
    )

    gy = torch.clamp(guessy * 0.25, torch.minimum(pym, pyM), torch.maximum(pym, pyM))
    gx = torch.clamp(guessx * 0.25, torch.minimum(pxm, pxM), torch.maximum(pxm, pxM))
    green_guess = torch.where(diffx > diffy, gy, gx)

    masks = site_masks(h, w, pattern, x.device)
    green = torch.where(masks['g'], pc, green_guess)
    r = torch.where(masks['r'], pc, 0.0)
    b = torch.where(masks['b'], pc, 0.0)
    return torch.clamp(torch.stack((r, green, b), dim=-1), min=0.0)


def ppg_redblue(rgb: torch.Tensor, pattern: BayerPattern, clamp_input: bool = False) -> torch.Tensor:
    """R/B completion from green-filled sparse RGB; the 1-px image edge
    passes through unchanged (clamped >= 0)."""
    rgb = rgb.to(_F32)
    h, w = rgb.shape[:2]
    src = torch.clamp(rgb, min=0.0) if clamp_input else rgb
    s = Shifter(src.permute(2, 0, 1), 1)

    c0 = s(0, 0)
    nt, nb, nl, nr = s(-1, 0), s(1, 0), s(0, -1), s(0, 1)
    ntl, ntr, nbl, nbr = s(-1, -1), s(-1, 1), s(1, -1), s(1, 1)
    g = c0[1]

    masks = site_masks(h, w, pattern, rgb.device)
    rows, cols = row_col_iota(h, w, rgb.device)
    red_in_row = _tile2x2_map(h, w, [
        [1 if fc(r, c + 1, pattern) == 0 else 0 for c in range(2)] for r in range(2)
    ], rgb.device) == 1

    b_v = (nt[2] + nb[2] + 2.0 * g - nt[1] - nb[1]) * 0.5
    r_h = (nl[0] + nr[0] + 2.0 * g - nl[1] - nr[1]) * 0.5
    r_v = (nt[0] + nb[0] + 2.0 * g - nt[1] - nb[1]) * 0.5
    b_h = (nl[2] + nr[2] + 2.0 * g - nl[1] - nr[1]) * 0.5
    green_r = torch.where(red_in_row, r_h, r_v)
    green_b = torch.where(red_in_row, b_v, b_h)

    def _diag_fill(chan):
        diff1 = torch.abs(ntl[chan] - nbr[chan]) + torch.abs(ntl[1] - g) + torch.abs(nbr[1] - g)
        guess1 = ntl[chan] + nbr[chan] + 2.0 * g - ntl[1] - nbr[1]
        diff2 = torch.abs(ntr[chan] - nbl[chan]) + torch.abs(ntr[1] - g) + torch.abs(nbl[1] - g)
        guess2 = ntr[chan] + nbl[chan] + 2.0 * g - ntr[1] - nbl[1]
        return torch.where(
            diff1 > diff2,
            guess2 * 0.5,
            torch.where(diff1 < diff2, guess1 * 0.5, (guess1 + guess2) * 0.25),
        )

    out_r = torch.where(masks['g'], green_r, torch.where(masks['b'], _diag_fill(0), c0[0]))
    out_b = torch.where(masks['g'], green_b, torch.where(masks['r'], _diag_fill(2), c0[2]))
    edge = (rows == 0) | (cols == 0) | (rows == h - 1) | (cols == w - 1)
    out_r = torch.where(edge, c0[0], out_r)
    out_b = torch.where(edge, c0[2], out_b)
    return torch.clamp(torch.stack((out_r, g, out_b), dim=-1), min=0.0)


__all__ = ['border_interpolate', 'ppg_green', 'ppg_redblue']
