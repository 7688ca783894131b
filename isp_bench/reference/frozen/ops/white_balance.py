# Frozen copy of tpu_darktable_torch/ops/white_balance.py (plain PyTorch paths only), kept
# as the benchmark's reference; it imports nothing of the measured package.
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


__all__ = ['apply_white_balance']
