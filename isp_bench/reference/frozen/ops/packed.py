# Frozen copy of tpu_darktable_torch/ops/packed.py (plain PyTorch paths only), kept
# as the benchmark's reference; it imports nothing of the measured package.
"""Packed 12-bit RAW codec (counterpart of tpu_darktable/ops/packed.py).

Two 12-bit pixels pack into three bytes:

  standard:  b0 = p0 & 0xff;  b1 = (p1 & 0xf) << 4 | p0 >> 8;  b2 = p1 >> 4
  IDS:       b0 = p0 >> 4;    b1 = p1 >> 4;  b2 = (p0 & 0xf) << 4 | (p1 & 0xf)

The unpack runs as integer ops on the uint8 tensor (widened to int32),
then scales to float32.
"""

from __future__ import annotations

import torch

_INV_4095 = 1.0 / 4095.0


def _decode12_pairs(packed: torch.Tensor, ids_format: bool):
    """uint8 (..., 3N) -> two int32 tensors (..., N) of 12-bit values."""
    if packed.dtype != torch.uint8:
        raise RuntimeError(f'packed must be uint8, got {packed.dtype}')
    if packed.shape[-1] % 3 != 0:
        raise ValueError(f'packed length must be multiple of 3, got {packed.shape[-1]}')
    b0 = packed[..., 0::3].to(torch.int32)
    b1 = packed[..., 1::3].to(torch.int32)
    b2 = packed[..., 2::3].to(torch.int32)
    if ids_format:
        # IDS quirk: the low nibbles of BOTH pixels share the third byte.
        p0 = (b0 << 4) | (b2 & 0xF)
        p1 = (b1 << 4) | (b2 >> 4)
    else:
        p0 = ((b1 & 0xF) << 8) | b0
        p1 = (b2 << 4) | (b1 >> 4)
    return p0, p1


def _interleave_pairs(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """(..., N), (..., N) -> (..., 2N) interleaved."""
    return torch.stack((p0, p1), dim=-1).reshape(p0.shape[:-1] + (2 * p0.shape[-1],))


def decode12_float(packed: torch.Tensor, ids_format: bool = False,
                   scaled: bool = True) -> torch.Tensor:
    """uint8 packed -> float32 values, scaled by 1/4095 when `scaled`.
    Operates on the trailing axis."""
    p0, p1 = _decode12_pairs(packed, ids_format)
    out = _interleave_pairs(p0, p1).to(torch.float32)
    if scaled:
        out = out * _INV_4095
    return out


__all__ = ['decode12_float']
