"""Pipeline layer: settings, camera registry and the batched processor."""

from .camera_settings import CameraSettings, load_camera_settings_from_dir
from .config import Debayer, ImageProcessingSettings, ToneMapper
from .image_processor import ImageProcessor, ImageSizeMismatchError, build_pipeline_fn
from .presets import get_preset, presets
from .transform import ImageTransform, transform, transformed_size

__all__ = [
    'CameraSettings',
    'Debayer',
    'ImageProcessingSettings',
    'ImageProcessor',
    'ImageSizeMismatchError',
    'ImageTransform',
    'ToneMapper',
    'build_pipeline_fn',
    'get_preset',
    'load_camera_settings_from_dir',
    'presets',
    'transform',
    'transformed_size',
]
