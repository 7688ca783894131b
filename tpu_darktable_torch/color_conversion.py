"""Public colour conversion module (counterpart of
tpu_darktable/color_conversion.py); the HSL functions are not ported yet."""

from .ops.color import (
    color_transform_3x3,
    compute_log_luminance,
    compute_luminance,
    lab_to_rgb,
    lab_to_xyz,
    linear_to_srgb,
    modify_log_luminance,
    modify_luminance,
    modify_vibrance,
    rgb_to_lab,
    rgb_to_xyz,
    srgb_to_linear,
    xyz_to_lab,
    xyz_to_linear_rgb,
    xyz_to_rgb,
)

__all__ = [
    'color_transform_3x3',
    'compute_log_luminance',
    'compute_luminance',
    'lab_to_rgb',
    'lab_to_xyz',
    'linear_to_srgb',
    'modify_log_luminance',
    'modify_luminance',
    'modify_vibrance',
    'rgb_to_lab',
    'rgb_to_xyz',
    'srgb_to_linear',
    'xyz_to_lab',
    'xyz_to_linear_rgb',
    'xyz_to_rgb',
]
