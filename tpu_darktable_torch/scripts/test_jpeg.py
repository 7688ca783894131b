"""JPEG encode test (counterpart of tpu_darktable/scripts/test_jpeg.py):
encode an RGB image, decode the bytes with Pillow and report the PSNR.

    python -m tpu_darktable_torch.scripts.test_jpeg IMAGE [--quality 94]
        [--subsampling 422] [--save out.jpg] [--output cmp.png] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import io
from pathlib import Path

import numpy as np
import torch

from ..jpeg import InputFormat, Jpeg, Subsampling
from .util import add_device_argument, display_images, load_image

SUBSAMPLING = {'444': Subsampling.CSS_444, '422': Subsampling.CSS_422,
               'gray': Subsampling.CSS_GRAY}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description='Test JPEG encoding')
    p.add_argument('image', type=Path)
    p.add_argument('--quality', type=int, default=94)
    p.add_argument('--subsampling', choices=list(SUBSAMPLING), default='422')
    p.add_argument('--save', type=Path, default=None, help='Save the encoded .jpg')
    p.add_argument('--output', type=Path, default=None)
    add_device_argument(p)
    return p


def run(rgb: torch.Tensor, args, device) -> dict[str, torch.Tensor]:
    """The image as uint8 and its JFIF bytes (a uint8 tensor on the host),
    encoded on the image's device."""
    u8 = torch.round(rgb * 255.0).to(torch.uint8)
    data = Jpeg().encode(u8, quality=args.quality, input_format=InputFormat.RGBI,
                         subsampling=SUBSAMPLING[args.subsampling])
    return {'original': u8, 'jpeg': torch.from_numpy(np.asarray(data))}


def main(argv=None):
    args = parser().parse_args(argv)
    images = run(load_image(args.image, args.device), args, args.device)
    u8 = images['original'].cpu().numpy()
    raw = images['jpeg'].numpy().tobytes()
    print(f'encoded {u8.shape[1]}x{u8.shape[0]} -> {len(raw)} bytes '
          f'(quality {args.quality}, {args.subsampling})')
    if args.save:
        Path(args.save).write_bytes(raw)
        print(f'saved {args.save}')

    from PIL import Image

    decoded = np.asarray(Image.open(io.BytesIO(raw)).convert('RGB'))
    mse = np.mean((decoded.astype(np.float64) - u8.astype(np.float64)) ** 2)
    psnr = 10 * np.log10(255.0**2 / max(mse, 1e-12))
    print(f'decode PSNR: {psnr:.2f} dB')
    display_images({'original': u8, f'jpeg q{args.quality}': decoded},
                   output=args.output, title=f'JPEG (PSNR {psnr:.1f} dB)')


if __name__ == '__main__':
    main()
