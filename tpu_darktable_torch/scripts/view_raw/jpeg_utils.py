"""JPEG encode/decode/PSNR helpers for the preview window (counterpart of
tpu_darktable/scripts/view_raw/jpeg_utils.py).  Encoding runs this
package's encoder on `device` (None = the card); only decoding needs
Pillow, imported where it is called."""

from __future__ import annotations

import io

import numpy as np

from ...jpeg import InputFormat, Jpeg

# one encoder for every preview, so its CUDA graphs replay from frame to frame
_JPEG = Jpeg()


def encode_jpeg_bytes(image_u8: np.ndarray, quality: int, progressive: bool = False,
                      device=None) -> bytes:
    data = _JPEG.encode(
        np.ascontiguousarray(image_u8), quality=quality,
        input_format=InputFormat.RGBI, progressive=progressive, device=device,
    )
    return np.asarray(data).tobytes()


def decode_jpeg_bytes(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert('RGB'))


def jpeg_psnr(original_u8: np.ndarray, decoded_u8: np.ndarray) -> float:
    mse = np.mean((original_u8.astype(np.float64) - decoded_u8.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0**2 / max(mse, 1e-12)))
