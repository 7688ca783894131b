"""Pipeline controller: settings state and live reprocessing (counterpart
of tpu_darktable/scripts/view_raw/pipeline_ui.py).

Owns the camera settings, the ImageProcessor, the current raw file, and
rebuilds the processed image whenever a setting changes.  Widget ranges
come from the validators (config.get_validator), the reference's
auto-slider pattern.  Everything runs on the processor's device (the card
unless the caller asks for the CPU); `current_bayer()` and
`process_current()` copy their result to the host once, as numpy, for
the windows.  Neither matplotlib nor Pillow is imported here.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from ... import tonemap as _tonemap
from ..._device import resolve_device
from ...pipeline import ImageProcessor
from ...pipeline.camera_settings import CameraSettings, get_camera_settings_dir, load_raw_bytes
from ...pipeline.config import Bool, EnumValidator, Float, ImageProcessingSettings, Int, get_validator
from ...pipeline.presets import presets
from ...pipeline.transform import ImageTransform, transform

# Settings fields surfaced as widgets, in display order (the reference
# derives these from the validator metadata; we list the annotated fields).
SLIDER_FIELDS = [
    'tone_gamma',
    'tone_intensity',
    'light_adapt',
    'vibrance',
    'denoise',
    'bilateral',
]
CHECKBOX_FIELDS = ['postprocess', 'enable_denoise', 'enable_bilateral']
RADIO_FIELDS = ['debayer', 'tone_mapping']


def widget_spec(field: str):
    """(kind, metadata) for a settings field, from its validator."""
    v = get_validator(ImageProcessingSettings, field)
    if isinstance(v, Float) or isinstance(v, Int):
        return 'slider', {'range': v.range, 'label': v.description}
    if isinstance(v, Bool):
        return 'checkbox', {'label': v.description}
    if isinstance(v, EnumValidator):
        return 'radio', {'options': [e.name for e in v.enum_type], 'label': v.description}
    return None, {}


class PipelineController:
    """Owns settings + processor; reprocesses on change."""

    def __init__(self, camera_settings: CameraSettings, raw_files: list[Path], device=None):
        self.camera_settings = camera_settings
        self.raw_files = raw_files
        self.index = 0
        self.device = resolve_device(device)
        self.settings = camera_settings.image_processing
        self.processor = ImageProcessor.from_camera_settings(camera_settings, self.device)
        self.extra_rotation = ImageTransform.none
        self._raw_cache: dict[Path, torch.Tensor] = {}

    @property
    def current_file(self) -> Path:
        return self.raw_files[self.index]

    def load_current(self) -> torch.Tensor:
        path = self.current_file
        if path not in self._raw_cache:
            self._raw_cache[path] = load_raw_bytes(path, self.device)
        return self._raw_cache[path]

    def current_bayer(self) -> np.ndarray:
        """Decoded (H, W) mosaic for histograms, on the host."""
        return self.processor.load_bytes(self.load_current()).cpu().numpy()

    def process_current(self) -> np.ndarray:
        """Full pipeline on the current frame -> uint8 RGB on the host (no
        EMA: single image processing like the viewer)."""
        rgb = self.processor.load_image(self.load_current())
        bounds = _tonemap.compute_image_bounds([rgb], stride=8)
        rgb = self.processor.process_rgb(rgb, bounds)
        metrics = _tonemap.compute_image_metrics([rgb], stride=8)
        out = self.processor.tonemap(rgb, metrics)
        name = self.current_file.parent.stem
        out = self.processor.transform(out, name) if isinstance(
            self.processor.transforms, dict) and name in self.processor.transforms else (
            self.processor.transform(out, name) if not isinstance(self.processor.transforms, dict) else out)
        out = transform(out, self.extra_rotation)
        return out.cpu().numpy()

    def update_setting(self, field: str, value):
        """Settings update (validated again) + selective rebuild."""
        cur = getattr(self.settings, field)
        if isinstance(cur, bool):
            value = bool(value)
        elif isinstance(cur, int) and not isinstance(cur, bool):
            value = int(value)
        elif isinstance(cur, float):
            value = float(value)
        self.settings = dataclasses.replace(self.settings, **{field: value})
        self.processor.update_settings(self.settings)

    def apply_preset(self, name: str):
        self.settings = presets[name]
        self.processor.update_settings(self.settings)

    def rotate(self):
        self.extra_rotation = self.extra_rotation.next_rotation()

    def next_image(self, step: int = 1):
        self.index = (self.index + step) % len(self.raw_files)

    def reset(self):
        self.settings = self.camera_settings.image_processing
        self.processor.update_settings(self.settings)
        self.extra_rotation = ImageTransform.none

    def save_settings(self, path: Path | None = None):
        """Write live settings back into the camera JSON (by default this
        package's camera_settings/<name>.json)."""
        updated = dataclasses.replace(self.camera_settings, image_processing=self.settings)
        target = path or get_camera_settings_dir() / f'{self.camera_settings.name}.json'
        updated.save_json(target)
        return target
