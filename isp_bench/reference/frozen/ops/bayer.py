# Frozen copy of tpu_darktable_torch/ops/bayer.py (plain PyTorch paths only), kept
# as the benchmark's reference; it imports nothing of the measured package.
"""Bayer CFA pattern types and mosaic utilities (counterpart of
tpu_darktable/ops/bayer.py).

The pattern is darktable's 32-bit "filters" word; `fc` decodes the channel
code at a pixel with the reference's bit-twiddle, and `fc_tile` turns it
into a static 2x2 tile that the stencils select on by row/column parity.
"""

from __future__ import annotations

from enum import Enum

import numpy as np


class BayerPattern(Enum):
    """darktable 32-bit CFA "filters" words."""

    RGGB = 0x94949494
    BGGR = 0x16161616
    GRBG = 0x61616161
    GBRG = 0x49494949


def fc(row, col, pattern: BayerPattern) -> int:
    """Channel code (0=R, 1=G, 2=B, 3=G2) at (row, col)."""
    return (pattern.value >> ((((row << 1) & 14) + (col & 1)) << 1)) & 3


def fc_tile(pattern: BayerPattern) -> np.ndarray:
    """Static 2x2 tile of channel codes for the pattern."""
    return np.array(
        [[fc(r, c, pattern) for c in range(2)] for r in range(2)], dtype=np.int32
    )


def site_parities(pattern: BayerPattern) -> tuple[tuple[int, int], tuple[int, int]]:
    """((row, col) parity of the R site, (row, col) parity of the B site)."""
    tile = fc_tile(pattern)
    (rr, rc) = np.argwhere(tile == 0)[0]
    (br, bc) = np.argwhere(tile == 2)[0]
    return (int(rr), int(rc)), (int(br), int(bc))


__all__ = ['BayerPattern', 'fc', 'fc_tile', 'site_parities']
