"""White balance application and estimation on Bayer mosaics (counterpart
of tpu_darktable/ops/white_balance.py).  The estimate is masked reductions
and one sort on the device: no boolean indexing, no host sync."""

from __future__ import annotations

import numpy as np
import torch

from .._device import constant_on
from .bayer import BayerPattern, fc_tile


def _gain_tile(pattern: BayerPattern) -> np.ndarray:
    """(2, 2) index map into the gains vector: code 0 -> R, 2 -> B, else G."""
    codes = fc_tile(pattern)
    return np.where(codes == 0, 0, np.where(codes == 2, 2, 1)).astype(np.int64)


def apply_white_balance(bayer_image: torch.Tensor, gains: torch.Tensor,
                        pattern: BayerPattern) -> torch.Tensor:
    """Per-CFA-site gains, clamped to [0, 1].

    Args:
        bayer_image: (..., H, W) float32 mosaic.
        gains: (3,) [R, G, B] gains on the same device.
        pattern: CFA pattern.
    """
    if bayer_image.ndim < 2:
        raise RuntimeError(
            f'bayer_image must have at least 2 dimensions (..., H, W), '
            f'got shape {tuple(bayer_image.shape)}'
        )
    gains = torch.as_tensor(gains, dtype=bayer_image.dtype, device=bayer_image.device)
    if tuple(gains.shape) != (3,):
        raise RuntimeError(f'gains must have shape (3,), got {tuple(gains.shape)}')
    h, w = bayer_image.shape[-2:]
    tile = gains[constant_on(_gain_tile(pattern), gains.device)]  # (2, 2)
    gain_map = tile.repeat((h + 1) // 2, (w + 1) // 2)[:h, :w]
    return torch.clamp(bayer_image * gain_map, 0.0, 1.0)


def _bayer_2x2_to_rgb(p00, p01, p10, p11, pattern: BayerPattern):
    """RGB from one 2x2 Bayer cell."""
    match pattern:
        case BayerPattern.RGGB:
            return p00, (p01 + p10) * 0.5, p11
        case BayerPattern.BGGR:
            return p11, (p01 + p10) * 0.5, p00
        case BayerPattern.GRBG:
            return p01, (p00 + p11) * 0.5, p10
        case BayerPattern.GBRG:
            return p10, (p00 + p11) * 0.5, p01
    raise ValueError(f'Invalid bayer pattern: {pattern}')


def estimate_white_balance(bayer_images, pattern: BayerPattern, quantile: float = 0.98,
                           stride: int = 8) -> torch.Tensor:
    """Estimate gains from bright unsaturated 2x2 cells; returns (3,) with
    G = 1.  As in the reference, the returned R and B entries are the mean
    chroma ratios r/g and b/g of the bright cells (not their inverses), and
    the stride only limits the sample grid's extent: cells sit at (2y, 2x)
    for x < W/stride - 1, y < H/stride - 1.

    Args:
        bayer_images: list of (H, W) mosaics, or a (B, H, W) batch.
    """
    if isinstance(bayer_images, (list, tuple)):
        batch = torch.stack([torch.as_tensor(im) for im in bayer_images])
    else:
        batch = torch.as_tensor(bayer_images)
        if batch.ndim == 2:
            batch = batch[None]
    f32 = dict(dtype=torch.float32, device=batch.device)
    _, h, w = batch.shape
    nx, ny = max(w // stride - 1, 0), max(h // stride - 1, 0)
    if nx == 0 or ny == 0:
        return torch.ones(3, **f32)

    cells = batch[:, : 2 * ny, : 2 * nx]
    p00 = cells[:, 0::2, 0::2]
    p01 = cells[:, 0::2, 1::2]
    p10 = cells[:, 1::2, 0::2]
    p11 = cells[:, 1::2, 1::2]
    r, g, b = _bayer_2x2_to_rgb(p00, p01, p10, p11, pattern)

    intensity = r + g + b
    max_bayer = torch.maximum(torch.maximum(p00, p01), torch.maximum(p10, p11))
    valid = max_bayer < 1.0
    chroma_r = r / intensity
    chroma_g = g / intensity

    # The quantile over the valid samples without dynamic shapes: invalid
    # intensities sort to the bottom as -inf, and the position is taken
    # among the valid count at the top.
    flat_i = intensity.reshape(-1)
    flat_valid = valid.reshape(-1)
    n_valid = torch.sum(flat_valid)
    sorted_i = torch.sort(torch.where(flat_valid, flat_i, -torch.inf)).values
    total = flat_i.shape[0]
    pos_in_valid = torch.tensor(quantile, **f32) * (n_valid.to(torch.float32) - 1.0)
    lo = torch.floor(pos_in_valid).to(torch.int64)
    frac = pos_in_valid - lo.to(torch.float32)
    base = total - n_valid
    v_lo = sorted_i[torch.clamp(base + lo, 0, total - 1)]
    v_hi = sorted_i[torch.clamp(base + lo + 1, 0, total - 1)]
    threshold = v_lo + frac * (v_hi - v_lo)

    bright = flat_valid & (flat_i >= threshold)
    n_bright = torch.clamp(torch.sum(bright), min=1)
    mean_r = torch.sum(torch.where(bright, chroma_r.reshape(-1), 0.0)) / n_bright
    mean_g = torch.sum(torch.where(bright, chroma_g.reshape(-1), 0.0)) / n_bright
    gains = torch.stack((mean_r / mean_g, torch.ones((), **f32),
                         (1.0 - mean_r - mean_g) / mean_g))
    return torch.where(n_valid > 0, gains, torch.ones(3, **f32))


__all__ = ['apply_white_balance', 'estimate_white_balance']
