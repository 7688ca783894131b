"""Public JPEG module (counterpart of tpu_darktable/jpeg.py), mirroring the
reference's torch_darktable/jpeg.py.

The encoder itself (the DCT stage on the image's device and the entropy
scan on the device or the host) lives in ops/jpeg.py; this module provides
the reference-compatible class and enums (reference jpeg.py:10-33,
csrc/jpeg_encoder.{h,cu}).  A Jpeg owns the CUDA graphs of its two device
programs, as the workspace classes own theirs: on the card the first
encode of an image shape captures them, later ones replay them.
"""

from __future__ import annotations

from enum import IntEnum

from .ops.jpeg import JpegException, PendingJpeg, _encode, _encode_async, _Stages
from .ops.jpeg import encode_jpeg, encode_jpeg_async  # noqa: F401  (names of JAX's module)


class InputFormat(IntEnum):
    BGR = 0
    RGB = 1
    BGRI = 2
    RGBI = 3


class Subsampling(IntEnum):
    CSS_444 = 0
    CSS_422 = 1
    CSS_GRAY = 2


class Jpeg:
    """JPEG encoder (reference jpeg.py:24-31).

    encode() takes a uint8 image - (H, W, 3) for interleaved formats
    (RGBI/BGRI) or (3, H, W) for planar (RGB/BGR) - and returns the JPEG
    bitstream as a numpy uint8 array.  A tensor is encoded on its own
    device; an array goes to `device` (None = the card).
    """

    def __init__(self):
        self._stages = _Stages()

    def encode(
        self,
        image,
        quality: int = 94,
        input_format: InputFormat = InputFormat.RGBI,
        subsampling: Subsampling = Subsampling.CSS_422,
        progressive: bool = False,
        restart_interval: int | None = None,
        entropy: str = 'auto',
        device=None,
    ):
        return _encode(self._stages, image, quality, int(input_format), int(subsampling),
                       progressive, restart_interval, entropy, device)

    def encode_async(
        self,
        image,
        quality: int = 94,
        input_format: InputFormat = InputFormat.RGBI,
        subsampling: Subsampling = Subsampling.CSS_422,
        restart_interval: int | None = None,
        device=None,
    ) -> PendingJpeg:
        """Enqueue a device-entropy encode; call .result() for the bytes.

        Same bitstream as encode(entropy='device'); the split lets streaming
        callers overlap this frame's readback with later device work."""
        return _encode_async(self._stages, image, quality, int(input_format),
                             int(subsampling), restart_interval, device)


__all__ = ['InputFormat', 'Jpeg', 'JpegException', 'PendingJpeg', 'Subsampling']
