# Frozen copy of tpu_darktable_torch/ops/_stencil.py (plain PyTorch paths only), kept
# as the benchmark's reference; it imports nothing of the measured package.
"""Shared stencil helpers (counterpart of tpu_darktable/ops/_stencil.py).

A stencil is written as integer-shifted views of a padded tensor; masks
come from row/column index parities.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .bayer import BayerPattern, site_parities


class Shifter:
    """`s(dy, dx)[..., r, c] == x[..., r + dy, c + dx]`; reads outside the
    image give zero (mode 'constant', the reference's zero-filled tile
    loads) or the nearest edge pixel (mode 'edge')."""

    def __init__(self, x: torch.Tensor, radius: int, mode: str = 'constant'):
        self.h = x.shape[-2]
        self.w = x.shape[-1]
        self.r = radius
        pads = (radius, radius, radius, radius)
        if mode == 'constant':
            self.p = F.pad(x, pads)
        elif mode == 'edge':
            lead = x.shape[:-2]
            self.p = F.pad(x.reshape((1, -1) + x.shape[-2:]), pads, mode='replicate').reshape(
                lead + (self.h + 2 * radius, self.w + 2 * radius))
        else:
            raise ValueError(f"mode must be 'constant' or 'edge', got {mode!r}")

    def __call__(self, dy: int, dx: int) -> torch.Tensor:
        r = self.r
        return self.p[..., r + dy : r + dy + self.h, r + dx : r + dx + self.w]


def row_col_iota(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(h, 1) row and (1, w) column index tensors (broadcast to (h, w))."""
    rows = torch.arange(h, device=device, dtype=torch.int32)[:, None]
    cols = torch.arange(w, device=device, dtype=torch.int32)[None, :]
    return rows, cols


def interior_mask(h: int, w: int, border: int, device) -> torch.Tensor:
    """True for pixels with border <= x < w-border and likewise in y."""
    rows, cols = row_col_iota(h, w, device)
    return (rows >= border) & (rows < h - border) & (cols >= border) & (cols < w - border)


def parity_mask(h: int, w: int, row_par: int, col_par: int, device) -> torch.Tensor:
    """True at pixels with (row % 2, col % 2) == (row_par, col_par)."""
    rows, cols = row_col_iota(h, w, device)
    return ((rows & 1) == row_par) & ((cols & 1) == col_par)


def site_masks(h: int, w: int, pattern: BayerPattern, device) -> dict[str, torch.Tensor]:
    """(h, w) boolean maps for R / G (either) / B sites."""
    (rr, rc), (br, bc) = site_parities(pattern)
    masks = {
        'r': parity_mask(h, w, rr, rc, device),
        'b': parity_mask(h, w, br, bc, device),
    }
    masks['g'] = ~(masks['r'] | masks['b'])
    return masks


# The 25-compare-exchange sorting network for 9 elements, the same pairs in
# the same order as the JAX package (and csrc/*.cu of the port).
SORT9_NETWORK = (
    (0, 3), (1, 7), (2, 5), (4, 8),
    (0, 7), (2, 4), (3, 8), (5, 6),
    (0, 2), (1, 3), (4, 5), (7, 8),
    (1, 4), (3, 6), (5, 7),
    (0, 1), (2, 4), (3, 5), (6, 8),
    (2, 3), (4, 5), (6, 7),
    (1, 2), (3, 4), (5, 6),
)


def sort9(values) -> list[torch.Tensor]:
    """Sort 9 same-shape tensors elementwise; returns the 9 sorted tensors."""
    v = list(values)
    assert len(v) == 9
    for a, b in SORT9_NETWORK:
        v[a], v[b] = torch.minimum(v[a], v[b]), torch.maximum(v[a], v[b])
    return v


def median9(values) -> torch.Tensor:
    """Elementwise median of 9 tensors via the compare-exchange network."""
    return sort9(values)[4]


__all__ = [
    'SORT9_NETWORK',
    'Shifter',
    'interior_mask',
    'median9',
    'parity_mask',
    'row_col_iota',
    'site_masks',
    'sort9',
]
