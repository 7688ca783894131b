"""Demosaic: bilinear 5x5 and PPG, plus the border ladder that RCD runs on
its edge strips (counterpart of tpu_darktable/ops/demosaic.py).  Each
algorithm is a function of an (H, W) Bayer mosaic built from shifted views
(ops/_stencil.py); the boundary rules (zero-filled reads, border rings, the
pass-through edge) are the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import constant_on
from .._validate import as_mosaic
from .bayer import BayerPattern, fc, fc_tile, pixel_order
from ._stencil import Shifter, interior_mask, row_col_iota, site_masks, sort9

_F32 = torch.float32


def _tile2x2_map(h: int, w: int, tile, device) -> torch.Tensor:
    """Expand a (2, 2) table into an (h, w) map by row/column parity."""
    t = constant_on(tile, device)
    return t.repeat((h + 1) // 2, (w + 1) // 2)[:h, :w]


# Diamond 5x5 offsets, 13 taps, as (dx, dy) pairs.
_DIAMOND_OFFSETS = [
    (-2, 0),
    (-1, -1), (-1, 0), (-1, 1),
    (0, -2), (0, -1), (0, 0), (0, 1), (0, 2),
    (1, -1), (1, 0), (1, 1),
    (2, 0),
]

# Per-pixel-type kernels (R, G1, G2, B) x 13 taps x RGB.
_DIAMOND_KERNELS = np.array(
    [
        [
            [0, -2, -3],
            [0, 0, 4], [0, 4, 0], [0, 0, 4],
            [0, -2, -3], [0, 4, 0], [16, 8, 12], [0, 4, 0], [0, -2, -3],
            [0, 0, 4], [0, 4, 0], [0, 0, 4],
            [0, -2, -3],
        ],
        [
            [-2, 0, 1],
            [-2, 0, -2], [8, 0, 0], [-2, 0, -2],
            [1, 0, -2], [0, 0, 8], [10, 16, 10], [0, 0, 8], [1, 0, -2],
            [-2, 0, -2], [8, 0, 0], [-2, 0, -2],
            [-2, 0, 1],
        ],
        [
            [1, 0, -2],
            [-2, 0, -2], [0, 0, 8], [-2, 0, -2],
            [-2, 0, 1], [8, 0, 0], [10, 16, 10], [8, 0, 0], [-2, 0, 1],
            [-2, 0, -2], [0, 0, 8], [-2, 0, -2],
            [1, 0, -2],
        ],
        [
            [-3, -2, 0],
            [4, 0, 0], [0, 4, 0], [4, 0, 0],
            [-3, -2, 0], [0, 4, 0], [12, 8, 16], [0, 4, 0], [-3, -2, 0],
            [4, 0, 0], [0, 4, 0], [4, 0, 0],
            [-3, -2, 0],
        ],
    ],
    dtype=np.float32,
)


def bilinear5x5_demosaic(image: torch.Tensor, pattern: BayerPattern) -> torch.Tensor:
    """13-tap diamond bilinear demosaic of an (H, W) or (H, W, 1) mosaic,
    clamp-to-edge sampling -> (H, W, 3).  The pixel type of each cell site
    comes from `pixel_order`, whose BGGR and GBRG rows are the reference's."""
    x = as_mosaic(image, 'image', dtype=_F32)
    h, w = x.shape
    s = Shifter(x, 2, mode='edge')
    order = pixel_order(pattern)
    type_tile = np.array([[order[0], order[1]], [order[2], order[3]]], dtype=np.int32)
    accs = [torch.zeros((h, w), dtype=_F32, device=x.device) for _ in range(3)]
    for k, (dx, dy) in enumerate(_DIAMOND_OFFSETS):
        v = s(dy, dx)
        for c in range(3):
            accs[c] = accs[c] + v * _tile2x2_map(h, w, _DIAMOND_KERNELS[type_tile, k, c], x.device)
    norm_tiles = _DIAMOND_KERNELS[type_tile].sum(axis=2)  # (2, 2, 3) sums by site
    return torch.stack([accs[c] / _tile2x2_map(h, w, norm_tiles[..., c], x.device)
                        for c in range(3)], dim=-1)


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


_MEDIAN_OFFSETS = [
    (-2, 0),
    (-1, -1), (-1, 1),
    (0, -2), (0, 0), (0, 2),
    (1, -1), (1, 1),
    (2, 0),
]


def pre_median(image: torch.Tensor, pattern: BayerPattern, threshold: float) -> torch.Tensor:
    """Thresholded 9-point same-colour diamond median on green sites.
    `threshold` is the already-scaled value (the caller divides by 100)."""
    x = as_mosaic(image, 'image', dtype=_F32)
    h, w = x.shape
    s = Shifter(x, 2)
    center = s(0, 0)

    meds = []
    cnt = torch.zeros((h, w), dtype=torch.int32, device=x.device)
    for dy, dx in _MEDIAN_OFFSETS:
        v = s(dy, dx)
        passes = torch.abs(v - center) < threshold
        meds.append(torch.where(passes, v, 64.0 + v))
        cnt = cnt + passes.to(torch.int32)
    med = sort9(meds)

    target_single = med[4] - 64.0
    # med[(cnt - 1) // 2]: cnt is in [1, 9], so only ranks 0..4 are reachable
    idx = torch.clamp((cnt - 1) // 2, 0, 4)
    target_multi = med[0]
    for r in range(1, 5):
        target_multi = torch.where(idx == r, med[r], target_multi)
    target = torch.where(cnt == 1, target_single, target_multi)

    delta = torch.clamp(target - center, -threshold, threshold)
    masks = _code_masks(h, w, pattern, x.device)
    color = torch.where(masks[1] | masks[3], center + delta, center)
    return torch.clamp(color, min=0.0)


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


def ppg_demosaic(image: torch.Tensor, pattern: BayerPattern,
                 median_threshold: float = 0.0) -> torch.Tensor:
    """Full PPG: border fill -> optional pre-median -> green -> red/blue.
    `median_threshold` is the raw knob, scaled by 1/100 here."""
    x = as_mosaic(image, 'image', dtype=_F32)
    h, w = x.shape
    src = pre_median(x, pattern, median_threshold / 100.0) if median_threshold > 0.0 else x
    green = ppg_green(src, pattern)

    # border_interpolate survives only in the 3-px ring, so it runs on 8-px
    # edge strips and the result is assembled by concatenation.
    strip = 8
    if h <= 2 * strip + 2 or w <= 2 * strip + 2:
        border = border_interpolate(x, pattern, 3)
        inner = interior_mask(h, w, 3, x.device)
        temp = torch.where(inner[..., None], green, border)
    else:
        top = border_interpolate(x[:strip], pattern, 3)[:3]
        bottom = border_interpolate(x[-strip:], pattern, 3)[-3:]
        left = border_interpolate(x[:, :strip], pattern, 3)[3 : h - 3, :3]
        right = border_interpolate(x[:, -strip:], pattern, 3)[3 : h - 3, -3:]
        mid = torch.cat([left, green[3 : h - 3, 3 : w - 3], right], dim=1)
        temp = torch.cat([top, mid, bottom], dim=0)
    return ppg_redblue(temp, pattern)


__all__ = ['bilinear5x5_demosaic', 'border_interpolate', 'ppg_demosaic', 'ppg_green',
           'ppg_redblue', 'pre_median']
