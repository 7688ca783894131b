"""tpu_darktable_torch: the RAW ISP of tpu_darktable on PyTorch and CUDA.

A second package beside the JAX one, module for module.  Public entry
points run on the card (`cuda`) unless the caller passes `device='cpu'`;
asking for the card where there is none raises.  Every Pallas kernel of the
JAX package has a hand-written CUDA C++ counterpart for Hopper (csrc/),
each with a plain PyTorch version that the CPU runs (kernels/).  The JPEG
encoder (jpeg.py) and the streaming executor (pipeline/streaming.py) turn
the pipeline's frames into JFIF bytes; `extension` resolves the reference
binding's names against this package.
"""

from . import (bayer, color_conversion, debayer, denoise, extension, jpeg, local_contrast,
               tonemap, white_balance)
from .bayer import BayerPattern, PackedFormat, load_as_bayer, rgb_to_bayer
from .color_conversion import (
    color_transform_3x3,
    compute_log_luminance,
    compute_luminance,
    lab_to_rgb,
    lab_to_xyz,
    modify_hsl,
    modify_log_luminance,
    modify_luminance,
    modify_vibrance,
    rgb_to_lab,
    rgb_to_xyz,
    xyz_to_lab,
    xyz_to_rgb,
)
from .debayer import (
    PPG,
    RCD,
    Bilinear5x5,
    PostProcess,
    bilinear5x5_demosaic,
    decode12,
    decode12_float,
    decode12_half,
    decode12_u16,
    encode,
    encode12_float,
    encode12_u16,
)
from .denoise import Wiener, estimate_channel_noise
from .jpeg import InputFormat, Jpeg, JpegException, Subsampling
from .local_contrast import Bilateral, Laplacian, LaplacianParams
from .pipeline import (
    CameraSettings,
    Debayer,
    ImageProcessingSettings,
    ImageProcessor,
    ImageTransform,
    ToneMapper,
    build_pipeline_fn,
    get_preset,
    load_camera_settings_from_dir,
    presets,
)
from .tonemap import (
    TonemapParameters,
    aces_tonemap,
    compute_image_bounds,
    compute_image_metrics,
    linear_tonemap,
    metrics_from_dict,
    metrics_to_dict,
    print_metrics,
    reinhard_tonemap,
)
from .white_balance import apply_white_balance, estimate_white_balance

__all__ = [
    'PPG',
    'RCD',
    'BayerPattern',
    'Bilateral',
    'Bilinear5x5',
    'CameraSettings',
    'Debayer',
    'ImageProcessingSettings',
    'ImageProcessor',
    'ImageTransform',
    'InputFormat',
    'Jpeg',
    'JpegException',
    'Laplacian',
    'LaplacianParams',
    'PackedFormat',
    'PostProcess',
    'Subsampling',
    'ToneMapper',
    'TonemapParameters',
    'Wiener',
    'aces_tonemap',
    'apply_white_balance',
    'bayer',
    'bilinear5x5_demosaic',
    'build_pipeline_fn',
    'color_conversion',
    'color_transform_3x3',
    'compute_image_bounds',
    'compute_image_metrics',
    'compute_log_luminance',
    'compute_luminance',
    'debayer',
    'decode12',
    'decode12_float',
    'decode12_half',
    'decode12_u16',
    'denoise',
    'encode',
    'encode12_float',
    'encode12_u16',
    'estimate_channel_noise',
    'estimate_white_balance',
    'extension',
    'get_preset',
    'jpeg',
    'lab_to_rgb',
    'lab_to_xyz',
    'linear_tonemap',
    'load_as_bayer',
    'load_camera_settings_from_dir',
    'local_contrast',
    'metrics_from_dict',
    'metrics_to_dict',
    'modify_hsl',
    'modify_log_luminance',
    'modify_luminance',
    'modify_vibrance',
    'presets',
    'print_metrics',
    'reinhard_tonemap',
    'rgb_to_bayer',
    'rgb_to_lab',
    'rgb_to_xyz',
    'tonemap',
    'white_balance',
    'xyz_to_lab',
    'xyz_to_rgb',
]
