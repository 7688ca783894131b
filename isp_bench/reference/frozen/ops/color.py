# Frozen copy of tpu_darktable_torch/ops/color.py (plain PyTorch paths only), kept
# as the benchmark's reference; it imports nothing of the measured package.
"""Colour conversions on a trailing channel axis (counterpart of
tpu_darktable/ops/color.py): sRGB <-> linear, LAB, luminance write-back,
vibrance in LAB f-space, and Rec.601 gray.  Constants are the reference's
float32 values."""

from __future__ import annotations

import numpy as np
import torch

from .._device import constant_on
from .._validate import check_channels_last

_RGB_TO_XYZ = np.array(
    [
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ],
    dtype=np.float32,
)
_XYZ_TO_RGB = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    dtype=np.float32,
)
_D65_WHITE = np.array([0.95047, 1.0, 1.08883], dtype=np.float32)
# White-folded matrices of the vibrance fast path.
_RGB_TO_XYZ_D65N = _RGB_TO_XYZ / _D65_WHITE[:, None]
_XYZ_TO_RGB_D65N = _XYZ_TO_RGB * _D65_WHITE[None, :]


def _clip01(x):
    return torch.clamp(x, 0.0, 1.0)


def linear_to_srgb(linear: torch.Tensor) -> torch.Tensor:
    return torch.where(
        linear <= 0.0031308,
        12.92 * linear,
        1.055 * torch.pow(torch.clamp(linear, min=1e-38), 1.0 / 2.4) - 0.055,
    )


def srgb_to_linear(srgb: torch.Tensor) -> torch.Tensor:
    return torch.where(
        srgb <= 0.04045,
        srgb / 12.92,
        torch.pow(torch.clamp((srgb + 0.055) / 1.055, min=1e-38), 2.4),
    )


def color_transform_3x3(color: torch.Tensor, matrix) -> torch.Tensor:
    """Apply a 3x3 matrix over the trailing channel axis, as unrolled
    multiply-adds in float32 (no matmul, so no TF32 and a fixed order)."""
    check_channels_last(color, 'color')
    m = np.asarray(matrix, dtype=np.float32)
    if m.shape != (3, 3):
        raise RuntimeError(f'matrix must have shape (3, 3), got {m.shape}')
    c0, c1, c2 = color[..., 0], color[..., 1], color[..., 2]
    f = lambda v: float(v)
    return torch.stack(
        (
            f(m[0, 0]) * c0 + f(m[0, 1]) * c1 + f(m[0, 2]) * c2,
            f(m[1, 0]) * c0 + f(m[1, 1]) * c1 + f(m[1, 2]) * c2,
            f(m[2, 0]) * c0 + f(m[2, 1]) * c1 + f(m[2, 2]) * c2,
        ),
        dim=-1,
    )


def rgb_to_xyz(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB (gamma) -> XYZ, with the linearization."""
    return color_transform_3x3(srgb_to_linear(rgb), _RGB_TO_XYZ)


def xyz_to_rgb(xyz: torch.Tensor) -> torch.Tensor:
    """XYZ -> sRGB (gamma), with the gamma encode."""
    return linear_to_srgb(color_transform_3x3(xyz, _XYZ_TO_RGB))


def _lab_f(t):
    delta = 6.0 / 29.0
    factor = 1.0 / (3.0 * delta * delta)
    # cube root of a positive value (the branch only takes t > delta^3)
    return torch.where(t > delta ** 3, torch.pow(torch.clamp(t, min=0.0), 1.0 / 3.0),
                       factor * t + 4.0 / 29.0)


def _lab_f_inv(t):
    delta = 6.0 / 29.0
    return torch.where(t > delta, t * t * t, (3.0 * delta * delta) * (t - 4.0 / 29.0))


def _white(like: torch.Tensor) -> torch.Tensor:
    return constant_on(_D65_WHITE, like.device)


def xyz_to_lab(xyz: torch.Tensor) -> torch.Tensor:
    """XYZ -> LAB normalized to L/100, a/128, b/128."""
    n = xyz / _white(xyz)
    fx, fy, fz = _lab_f(n[..., 0]), _lab_f(n[..., 1]), _lab_f(n[..., 2])
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return torch.stack((L / 100.0, a / 128.0, b / 128.0), dim=-1)


def lab_to_xyz(lab: torch.Tensor) -> torch.Tensor:
    L = lab[..., 0] * 100.0
    a = lab[..., 1] * 128.0
    b = lab[..., 2] * 128.0
    fy = (L + 16.0) / 116.0
    fx = a / 500.0 + fy
    fz = fy - b / 200.0
    xyz = torch.stack((_lab_f_inv(fx), _lab_f_inv(fy), _lab_f_inv(fz)), dim=-1)
    return xyz * _white(xyz)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    return xyz_to_lab(rgb_to_xyz(rgb))


def lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    return xyz_to_rgb(lab_to_xyz(lab))


def modify_vibrance(rgb: torch.Tensor, amount: float = 0.0) -> torch.Tensor:
    """darktable vibrance, computed in LAB f-space: L/a/b are affine in
    (fx, fy, fz), so the chroma-dependent scales apply to the f values and
    the D65 white point folds into the two 3x3 matrices."""
    lin = srgb_to_linear(rgb)
    n = color_transform_3x3(lin, _RGB_TO_XYZ_D65N)
    fx, fy, fz = _lab_f(n[..., 0]), _lab_f(n[..., 1]), _lab_f(n[..., 2])
    a = (500.0 / 128.0) * (fx - fy)
    b = (200.0 / 128.0) * (fy - fz)
    chroma = torch.sqrt(a * a + b * b)
    ls = 1.0 - amount * chroma * 0.25
    ss = 1.0 + amount * chroma
    fy2 = ls * fy + (16.0 / 116.0) * (1.0 - ls)
    fx2 = ss * (fx - fy) + fy2
    fz2 = fy2 - ss * (fy - fz)
    f_inv = torch.stack((_lab_f_inv(fx2), _lab_f_inv(fy2), _lab_f_inv(fz2)), dim=-1)
    return _clip01(linear_to_srgb(color_transform_3x3(f_inv, _XYZ_TO_RGB_D65N)))


def lab_modify_luminance(lab: torch.Tensor, new_luminance: torch.Tensor) -> torch.Tensor:
    """Replace LAB L and convert back to clipped sRGB."""
    lab = torch.cat((new_luminance[..., None], lab[..., 1:]), dim=-1)
    return _clip01(lab_to_rgb(lab))


def rgb_to_lab_with_clipped_l(rgb: torch.Tensor):
    """(rgb_to_lab(rgb), L of clip01(rgb)) sharing the sRGB decode: the
    decode commutes with clip01, so the linear values are clipped instead."""
    check_channels_last(rgb, 'rgb')
    lin = srgb_to_linear(rgb)
    lab = xyz_to_lab(color_transform_3x3(lin, _RGB_TO_XYZ))
    l_clipped = xyz_to_lab(color_transform_3x3(_clip01(lin), _RGB_TO_XYZ))[..., 0]
    return lab, l_clipped


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.601 luma used by the metrics."""
    return rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114


__all__ = ['color_transform_3x3', 'lab_modify_luminance', 'lab_to_rgb', 'lab_to_xyz', 'linear_to_srgb', 'modify_vibrance', 'rgb_to_gray', 'rgb_to_lab', 'rgb_to_lab_with_clipped_l', 'rgb_to_xyz', 'srgb_to_linear', 'xyz_to_lab', 'xyz_to_rgb']
