"""Bayer channel extraction and statistics for histogram displays
(counterpart of tpu_darktable/scripts/bayer_utils.py).  They run on the
host: the mosaic (a tensor on any device, or an array) is copied there."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bayer import BayerPattern, fc_map


def extract_bayer_channels(bayer_image, pattern: BayerPattern) -> dict[str, np.ndarray]:
    """Split an (H, W) or (H, W, 1) mosaic into R / G1 / G2 / B samples."""
    if isinstance(bayer_image, torch.Tensor):
        bayer_image = bayer_image.detach().cpu().numpy()
    arr = np.asarray(bayer_image)
    if arr.ndim == 3:
        arr = arr[..., 0]
    h, w = arr.shape
    codes = fc_map(h, w, pattern)
    rows = np.arange(h)[:, None] * np.ones((1, w), dtype=int)
    return {
        'R': arr[codes == 0],
        'G1': arr[(codes == 1) & (rows % 2 == 0)],
        'G2': arr[(codes == 1) & (rows % 2 == 1)],
        'B': arr[codes == 2],
    }


def channel_statistics(bayer_image, pattern: BayerPattern,
                       saturation: float = 0.99) -> dict[str, dict[str, float]]:
    """Per-channel mean / std / saturated fraction."""
    channels = extract_bayer_channels(bayer_image, pattern)
    stats = {}
    for name, vals in channels.items():
        stats[name] = {
            'mean': float(vals.mean()) if vals.size else 0.0,
            'std': float(vals.std()) if vals.size else 0.0,
            'saturated': float((vals >= saturation).mean()) if vals.size else 0.0,
        }
    return stats


__all__ = ['channel_statistics', 'extract_bayer_channels']
