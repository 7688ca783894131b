"""Public bayer module (counterpart of tpu_darktable/bayer.py)."""

from .ops.bayer import (
    BayerPattern,
    PackedFormat,
    channels,
    expand_bayer,
    fc,
    fc_map,
    load_as_bayer,
    pixel_order,
    rgb_to_bayer,
    stack_bayer,
)

__all__ = [
    'BayerPattern',
    'PackedFormat',
    'channels',
    'expand_bayer',
    'fc',
    'fc_map',
    'load_as_bayer',
    'pixel_order',
    'rgb_to_bayer',
    'stack_bayer',
]
