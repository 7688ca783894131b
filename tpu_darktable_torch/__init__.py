"""tpu_darktable_torch: the RAW ISP of tpu_darktable on PyTorch and CUDA.

A second package beside the JAX one, module for module.  Public entry
points run on the card (`cuda`) unless the caller passes `device='cpu'`;
asking for the card where there is none raises.  The three kernels of the
main path are hand-written CUDA C++ for Hopper (csrc/), each with a plain
PyTorch version that the CPU runs (kernels/); so are the kernels of the
wavelet and NLM denoisers and of the general bilateral grid.
"""

from . import denoise, local_contrast
from .denoise import Wiener, estimate_channel_noise
from .local_contrast import Bilateral
from .ops.bayer import BayerPattern, PackedFormat
from .ops.packed import decode12_float, encode
from .pipeline import (
    CameraSettings,
    Debayer,
    ImageProcessingSettings,
    ImageProcessor,
    ImageTransform,
    ToneMapper,
    build_pipeline_fn,
    load_camera_settings_from_dir,
)

__all__ = [
    'BayerPattern',
    'Bilateral',
    'CameraSettings',
    'Debayer',
    'ImageProcessingSettings',
    'ImageProcessor',
    'ImageTransform',
    'PackedFormat',
    'ToneMapper',
    'Wiener',
    'build_pipeline_fn',
    'decode12_float',
    'denoise',
    'encode',
    'estimate_channel_noise',
    'load_camera_settings_from_dir',
    'local_contrast',
]
