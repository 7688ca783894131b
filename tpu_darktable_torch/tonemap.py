"""Public tonemap module (counterpart of tpu_darktable/tonemap.py)."""

from .ops.tonemap import (
    TonemapParameters,
    aces_tonemap,
    adaptive_aces_tonemap,
    compute_image_bounds,
    compute_image_metrics,
    filmic_tonemap,
    linear_tonemap,
    metrics_from_dict,
    metrics_to_dict,
    print_metrics,
    reinhard_tonemap,
)

__all__ = [
    'TonemapParameters',
    'aces_tonemap',
    'adaptive_aces_tonemap',
    'compute_image_bounds',
    'compute_image_metrics',
    'filmic_tonemap',
    'linear_tonemap',
    'metrics_from_dict',
    'metrics_to_dict',
    'print_metrics',
    'reinhard_tonemap',
]
