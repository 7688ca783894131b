# Frozen copy of tpu_darktable_torch/_validate.py (plain PyTorch paths only), kept
# as the benchmark's reference; it imports nothing of the measured package.
"""Argument guards for the port's public ops (counterpart of
tpu_darktable/_validate.py): ValueError for domain violations,
RuntimeError for shape mismatches."""

from __future__ import annotations

import torch


def check_channels_last(x: torch.Tensor, name: str, channels: int = 3) -> torch.Tensor:
    """Require a trailing axis of exactly `channels` (any leading dims)."""
    if x.ndim < 1 or x.shape[-1] != channels:
        raise RuntimeError(
            f'{name} must have a trailing axis of {channels} channels, '
            f'got shape {tuple(x.shape)}'
        )
    return x


def as_mosaic(x: torch.Tensor, name: str, dtype=None) -> torch.Tensor:
    """Validate a Bayer mosaic: (H, W) or (H, W, 1) -> (H, W) tensor."""
    if dtype is not None:
        x = x.to(dtype)
    if x.ndim == 3:
        if x.shape[-1] != 1:
            raise RuntimeError(
                f'{name} must be a single-channel mosaic (H, W) or (H, W, 1), '
                f'got shape {tuple(x.shape)}'
            )
        x = x[..., 0]
    if x.ndim != 2:
        raise RuntimeError(
            f'{name} must be a single-channel mosaic (H, W) or (H, W, 1), '
            f'got shape {tuple(x.shape)}'
        )
    return x


__all__ = ['as_mosaic', 'check_channels_last']
