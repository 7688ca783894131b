"""Packed 12-bit RAW codec (counterpart of tpu_darktable/ops/packed.py).

Two 12-bit pixels pack into three bytes:

  standard:  b0 = p0 & 0xff;  b1 = (p1 & 0xf) << 4 | p0 >> 8;  b2 = p1 >> 4
  IDS:       b0 = p0 >> 4;    b1 = p1 >> 4;  b2 = (p0 & 0xf) << 4 | (p1 & 0xf)

The unpack runs as integer ops on the uint8 tensor (widened to int32),
then scales to float32.
"""

from __future__ import annotations

import torch

from .bayer import PackedFormat

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


def decode12_half(packed: torch.Tensor, ids_format: bool = False,
                  scaled: bool = True) -> torch.Tensor:
    """uint8 packed -> float16 values."""
    return decode12_float(packed, ids_format, scaled).to(torch.float16)


def decode12_u16(packed: torch.Tensor, ids_format: bool = False) -> torch.Tensor:
    """uint8 packed -> uint16 12-bit values."""
    p0, p1 = _decode12_pairs(packed, ids_format)
    return _interleave_pairs(p0, p1).to(torch.uint16)


def _encode12_values(v: torch.Tensor, ids_format: bool) -> torch.Tensor:
    """int32 (..., 2N) of 12-bit values -> uint8 (..., 3N)."""
    if v.shape[-1] % 2 != 0:
        raise ValueError(f'input length must be even, got {v.shape[-1]}')
    pairs = v.reshape(v.shape[:-1] + (-1, 2))
    p0, p1 = pairs[..., 0], pairs[..., 1]
    if ids_format:
        b0 = p0 >> 4
        b1 = p1 >> 4
        b2 = ((p0 & 0xF) << 4) | (p1 & 0xF)
    else:
        b0 = p0 & 0xFF
        b1 = ((p1 & 0xF) << 4) | (p0 >> 8)
        b2 = p1 >> 4
    triples = torch.stack((b0, b1, b2), dim=-1)
    return triples.reshape(v.shape[:-1] + (3 * (v.shape[-1] // 2),)).to(torch.uint8)


def encode12_u16(values: torch.Tensor, ids_format: bool = False) -> torch.Tensor:
    """Integer 12-bit values -> packed uint8; clamps to 12 bits."""
    v = torch.clamp(values.to(torch.int32), max=4095)
    return _encode12_values(v, ids_format)


def encode12_float(values: torch.Tensor, ids_format: bool = False,
                   scaled: bool = True) -> torch.Tensor:
    """float32 values -> packed uint8; scale by 4095, round half to even,
    clamp to [0, 4095]."""
    v = values.to(torch.float32)
    q = torch.round(v * (4095.0 if scaled else 1.0)).to(torch.int32)
    return _encode12_values(torch.clamp(q, 0, 4095), ids_format)


def encode(image: torch.Tensor, format_type: PackedFormat = PackedFormat.Packed12,
           dtype=None) -> torch.Tensor:
    """Dtype-dispatching encode: uint16 values or float32 in [0, 1].
    `dtype` is accepted and ignored, as in the JAX package."""
    ids = format_type is PackedFormat.Packed12_IDS
    if image.dtype == torch.uint16:
        return encode12_u16(image, ids_format=ids)
    if image.dtype == torch.float32:
        return encode12_float(image, ids_format=ids)
    raise ValueError(f'Unsupported input dtype: {image.dtype}')


def decode12(packed: torch.Tensor, output_dtype=torch.float32,
             format_type: PackedFormat = PackedFormat.Packed12) -> torch.Tensor:
    """Dtype-dispatching decode: float32, float16 or uint16."""
    ids = format_type is PackedFormat.Packed12_IDS
    if output_dtype == torch.float32:
        return decode12_float(packed, ids_format=ids)
    if output_dtype == torch.float16:
        return decode12_half(packed, ids_format=ids)
    if output_dtype == torch.uint16:
        return decode12_u16(packed, ids_format=ids)
    raise ValueError(f'Unsupported output dtype: {output_dtype}')


__all__ = ['decode12', 'decode12_float', 'decode12_half', 'decode12_u16', 'encode',
           'encode12_float', 'encode12_u16']
