"""Bayer CFA pattern types and mosaic utilities (counterpart of
tpu_darktable/ops/bayer.py).

The pattern is darktable's 32-bit "filters" word; `fc` decodes the channel
code at a pixel with the reference's bit-twiddle, and `fc_tile` turns it
into a static 2x2 tile that the stencils select on by row/column parity.
"""

from __future__ import annotations

from enum import Enum
from pathlib import Path

import numpy as np
import torch


class BayerPattern(Enum):
    """darktable 32-bit CFA "filters" words."""

    RGGB = 0x94949494
    BGGR = 0x16161616
    GRBG = 0x61616161
    GBRG = 0x49494949


class PackedFormat(Enum):
    """12-bit packed RAW byte layouts."""

    Packed12 = 0
    Packed12_IDS = 1


def fc(row, col, pattern: BayerPattern) -> int:
    """Channel code (0=R, 1=G, 2=B, 3=G2) at (row, col)."""
    return (pattern.value >> ((((row << 1) & 14) + (col & 1)) << 1)) & 3


def fc_tile(pattern: BayerPattern) -> np.ndarray:
    """Static 2x2 tile of channel codes for the pattern."""
    return np.array(
        [[fc(r, c, pattern) for c in range(2)] for r in range(2)], dtype=np.int32
    )


def fc_map(height: int, width: int, pattern: BayerPattern) -> np.ndarray:
    """(H, W) numpy int32 map of channel codes."""
    reps = ((height + 1) // 2, (width + 1) // 2)
    return np.tile(fc_tile(pattern), reps)[:height, :width]


def channel_masks(height: int, width: int, pattern: BayerPattern):
    """(is_red, is_green, is_blue) boolean numpy maps (green covers both sites)."""
    codes = fc_map(height, width, pattern)
    return codes == 0, (codes == 1) | (codes == 3), codes == 2


def pixel_order(pattern: BayerPattern) -> tuple[int, int, int, int]:
    """Pixel type (0=R, 1=G1, 2=G2, 3=B) of the four 2x2 cell sites."""
    match pattern:
        case BayerPattern.RGGB:
            return (0, 1, 2, 3)
        case BayerPattern.BGGR:
            return (3, 1, 2, 0)
        case BayerPattern.GRBG:
            return (1, 0, 3, 2)
        case BayerPattern.GBRG:
            return (1, 3, 0, 2)
    raise ValueError(f'Invalid bayer pattern: {pattern}')


def channels(pattern: BayerPattern) -> tuple[int, int, int, int]:
    """RGB channel index sampled at each 2x2 cell site."""
    match pattern:
        case BayerPattern.RGGB:
            return (0, 1, 1, 2)
        case BayerPattern.BGGR:
            return (2, 1, 1, 0)
        case BayerPattern.GRBG:
            return (1, 0, 1, 2)
        case BayerPattern.GBRG:
            return (1, 2, 1, 0)
    raise ValueError(f'Invalid bayer pattern: {pattern}')


def rgb_to_bayer(rgb: torch.Tensor, pattern: BayerPattern = BayerPattern.RGGB) -> torch.Tensor:
    """Mosaic an (H, W, 3) RGB image into an (H, W, 1) Bayer image."""
    rgb = torch.as_tensor(rgb)
    c1, c2, c3, c4 = channels(pattern)
    return expand_bayer(torch.stack((rgb[0::2, 0::2, c1], rgb[0::2, 1::2, c2],
                                     rgb[1::2, 0::2, c3], rgb[1::2, 1::2, c4]), dim=-1))


def stack_bayer(bayer_image: torch.Tensor) -> torch.Tensor:
    """(H, W) Bayer -> (H/2, W/2, 4) planes in cell order."""
    x = torch.as_tensor(bayer_image)
    return torch.stack((x[0::2, 0::2], x[0::2, 1::2], x[1::2, 0::2], x[1::2, 1::2]), dim=-1)


def expand_bayer(x: torch.Tensor) -> torch.Tensor:
    """(H/2, W/2, 4) planes -> (H, W, 1) Bayer."""
    x = torch.as_tensor(x)
    h, w = x.shape[0], x.shape[1]
    result = torch.zeros((h * 2, w * 2), dtype=x.dtype, device=x.device)
    result[0::2, 0::2] = x[..., 0]
    result[0::2, 1::2] = x[..., 1]
    result[1::2, 0::2] = x[..., 2]
    result[1::2, 1::2] = x[..., 3]
    return result[..., None]


def load_as_bayer(image_path: Path, pattern: BayerPattern = BayerPattern.RGGB) -> torch.Tensor:
    """Load an RGB image file and mosaic it to (H, W, 1) Bayer in [0, 1]."""
    image_path = Path(image_path)
    if not image_path.exists():
        raise FileNotFoundError(f'Image not found: {image_path}')
    from PIL import Image

    image = np.asarray(Image.open(image_path).convert('RGB'), dtype=np.float32) / 255.0
    return rgb_to_bayer(torch.from_numpy(image), pattern)


def site_parities(pattern: BayerPattern) -> tuple[tuple[int, int], tuple[int, int]]:
    """((row, col) parity of the R site, (row, col) parity of the B site)."""
    tile = fc_tile(pattern)
    (rr, rc) = np.argwhere(tile == 0)[0]
    (br, bc) = np.argwhere(tile == 2)[0]
    return (int(rr), int(rc)), (int(br), int(bc))


__all__ = [
    'BayerPattern',
    'PackedFormat',
    'channel_masks',
    'channels',
    'expand_bayer',
    'fc',
    'fc_map',
    'fc_tile',
    'load_as_bayer',
    'pixel_order',
    'rgb_to_bayer',
    'site_parities',
    'stack_bayer',
]
