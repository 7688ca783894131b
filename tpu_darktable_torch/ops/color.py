"""Colour conversions on a trailing channel axis (counterpart of
tpu_darktable/ops/color.py): sRGB <-> linear, LAB, luminance write-back,
vibrance in LAB f-space, and Rec.601 gray.  Constants are the reference's
float32 values.  The LAB round trip of the luminance stages (sRGB -> LAB
and a luminance plane, and back) is kernels/lab.py's: on the card its two
kernels, on the CPU this module's chain."""

from __future__ import annotations

import numpy as np
import torch

from .._device import constant_on, scalar_on
from .._validate import check_channels_last
# kernels.lab's plain versions call this module's chain back (module
# attributes, read when called)
from ..kernels import lab as _lab

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


def xyz_to_linear_rgb(xyz: torch.Tensor) -> torch.Tensor:
    return color_transform_3x3(xyz, _XYZ_TO_RGB)


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
    return rgb_to_lab_with_l(rgb)[0]


def rgb_to_lab_with_l(rgb: torch.Tensor):
    """(rgb_to_lab(rgb), its L as a contiguous plane)."""
    return _lab.lab_split(rgb, clipped_l=False)


def lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    return xyz_to_rgb(lab_to_xyz(lab))


def rgb_to_hsl(rgb: torch.Tensor) -> torch.Tensor:
    """RGB -> HSL, each in [0, 1] for RGB in [0, 1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    max_val = torch.maximum(torch.maximum(r, g), b)
    min_val = torch.minimum(torch.minimum(r, g), b)
    delta = max_val - min_val
    L = (max_val + min_val) * 0.5

    chromatic = delta > 1e-6
    safe_delta = torch.where(chromatic, delta, 1.0)
    s = torch.where(
        chromatic,
        torch.where(L < 0.5, delta / (max_val + min_val), delta / (2.0 - max_val - min_val)),
        0.0,
    )
    h_r = (g - b) / safe_delta + torch.where(g < b, 6.0, 0.0)
    h_g = (b - r) / safe_delta + 2.0
    h_b = (r - g) / safe_delta + 4.0
    h = torch.where(max_val == r, h_r, torch.where(max_val == g, h_g, h_b))
    h = torch.where(chromatic, h / scalar_on(6.0, rgb.device), 0.0)
    return torch.stack((h, s, L), dim=-1)


def _hsl_hue_to_rgb(p, q, t):
    t = torch.where(t < 0.0, t + 1.0, t)
    t = torch.where(t > 1.0, t - 1.0, t)
    return torch.where(
        t < 1.0 / 6.0,
        p + (q - p) * 6.0 * t,
        torch.where(t < 0.5, q,
                    torch.where(t < 2.0 / 3.0, p + (q - p) * (2.0 / 3.0 - t) * 6.0, p)),
    )


def hsl_to_rgb(hsl: torch.Tensor) -> torch.Tensor:
    """HSL -> RGB."""
    h, s, L = hsl[..., 0], hsl[..., 1], hsl[..., 2]
    q = torch.where(L < 0.5, L * (1.0 + s), L + s - L * s)
    p = 2.0 * L - q
    rgb = torch.stack((_hsl_hue_to_rgb(p, q, h + 1.0 / 3.0), _hsl_hue_to_rgb(p, q, h),
                       _hsl_hue_to_rgb(p, q, h - 1.0 / 3.0)), dim=-1)
    return torch.where(s[..., None] == 0.0, L[..., None], rgb)


def modify_hsl(rgb: torch.Tensor, hue_adjust: float = 0.0, sat_adjust: float = 0.0,
               lum_adjust: float = 0.0) -> torch.Tensor:
    """Shift hue (wrapping), saturation and lightness (clipped) in HSL."""
    hsl = rgb_to_hsl(rgb)
    new_hsl = torch.stack((
        torch.remainder(hsl[..., 0] + hue_adjust + 1.0, 1.0),
        torch.clamp(hsl[..., 1] + sat_adjust, 0.0, 1.0),
        torch.clamp(hsl[..., 2] + lum_adjust, 0.0, 1.0),
    ), dim=-1)
    return _clip01(hsl_to_rgb(new_hsl))


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


def rgb_to_lab_l(rgb: torch.Tensor) -> torch.Tensor:
    """LAB L (normalized /100) of an RGB value."""
    return rgb_to_lab_with_l(rgb)[1]


def compute_luminance(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...) luminance: LAB L of the clipped RGB."""
    return rgb_to_lab_l(_clip01(check_channels_last(rgb, 'rgb')))


def compute_log_luminance(rgb: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(..., 3) -> (...) log of the luminance, floored at eps."""
    return torch.log(torch.clamp(compute_luminance(rgb), min=eps))


def modify_luminance(rgb: torch.Tensor, new_luminance: torch.Tensor) -> torch.Tensor:
    """Replace LAB L with `new_luminance` by a LAB round trip."""
    check_channels_last(rgb, 'rgb')
    if tuple(new_luminance.shape) != tuple(rgb.shape[:-1]):
        raise RuntimeError(
            f'new_luminance shape {tuple(new_luminance.shape)} must match '
            f'rgb leading dims {tuple(rgb.shape[:-1])}')
    return lab_modify_luminance(rgb_to_lab(rgb), new_luminance)


def modify_log_luminance(rgb: torch.Tensor, log_luminance: torch.Tensor,
                         eps: float = 1e-4) -> torch.Tensor:
    """Replace LAB L with exp(log_luminance + eps); the reference adds eps
    inside the exp."""
    return lab_modify_luminance(rgb_to_lab(rgb), torch.exp(log_luminance + eps))


def lab_modify_luminance(lab: torch.Tensor, new_luminance: torch.Tensor) -> torch.Tensor:
    """Replace LAB L and convert back to clipped sRGB."""
    return _lab.lab_merge(lab, new_luminance)


def rgb_to_lab_with_clipped_l(rgb: torch.Tensor):
    """(rgb_to_lab(rgb), L of clip01(rgb) as a contiguous plane) sharing the
    sRGB decode: the decode commutes with clip01, so the linear values are
    clipped instead."""
    return _lab.lab_split(rgb, clipped_l=True)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.601 luma used by the metrics."""
    return rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114


__all__ = [
    'color_transform_3x3',
    'compute_log_luminance',
    'compute_luminance',
    'hsl_to_rgb',
    'lab_modify_luminance',
    'lab_to_rgb',
    'lab_to_xyz',
    'linear_to_srgb',
    'modify_hsl',
    'modify_log_luminance',
    'modify_luminance',
    'modify_vibrance',
    'rgb_to_gray',
    'rgb_to_hsl',
    'rgb_to_lab',
    'rgb_to_lab_l',
    'rgb_to_lab_with_clipped_l',
    'rgb_to_lab_with_l',
    'rgb_to_xyz',
    'srgb_to_linear',
    'xyz_to_lab',
    'xyz_to_linear_rgb',
    'xyz_to_rgb',
]
