"""Carry state from the JAX package into the port.

The system has no weights: what it carries is the settings, the white
balance and the EMA statistics (`bounds` (2,), `metrics` (5,)).  The
functions take plain Python / numpy values, so nothing of JAX is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.tonemap import metrics_from_dict
from .pipeline.config import ImageProcessingSettings
from .pipeline.image_processor import ImageProcessor


def settings_from_dict(d: dict) -> ImageProcessingSettings:
    """Settings from the JAX package's `settings.model_dump()` (a plain dict
    with enum members or names); `get_preset(name).model_dump()` gives the
    port's preset of the same name."""
    return ImageProcessingSettings.from_dict(dict(d))


def processor_state_from_numpy(processor: ImageProcessor, bounds, metrics,
                               white_balance=None) -> ImageProcessor:
    """Load EMA state (and optionally the white balance) taken from a JAX
    ImageProcessor as numpy arrays into a port ImageProcessor, on its device.
    `metrics` may also be the JAX package's `metrics_to_dict(...)` dict.
    Returns the processor."""
    f32 = dict(dtype=torch.float32, device=processor.device)
    b = np.asarray(bounds, dtype=np.float32).reshape(-1)
    if isinstance(metrics, dict):
        metrics = metrics_from_dict(metrics).numpy()
    m = np.asarray(metrics, dtype=np.float32).reshape(-1)
    if b.shape != (2,) or m.shape != (5,):
        raise RuntimeError(f'bounds must be (2,) and metrics (5,), got {b.shape} {m.shape}')
    processor.bounds = torch.tensor(b, **f32)
    processor.metrics = torch.tensor(m, **f32)
    if white_balance is not None:
        wb = np.asarray(white_balance, dtype=np.float32).reshape(-1)
        if wb.shape != (3,):
            raise RuntimeError(f'white_balance must be (3,), got {wb.shape}')
        rebuild = processor.white_balance is None
        processor.white_balance = torch.tensor(wb, **f32)
        if rebuild:  # the pipeline is built with or without the WB stage
            processor._rebuild_workspaces()
    return processor


__all__ = ['processor_state_from_numpy', 'settings_from_dict']
