"""Visual Wiener denoise test (counterpart of
tpu_darktable/scripts/test_wiener.py): add Gaussian noise (seed 0) to an
RGB image and denoise it with the Wiener class in one of its four modes,
with the noise sigma estimated or given.

    python -m tpu_darktable_torch.scripts.test_wiener IMAGE [--mode rgb]
        [--sigma S] [--output cmp.png] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from .._device import to_device
from ..denoise import Wiener, estimate_channel_noise
from .util import add_device_argument, display_images, load_image


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description='Test Wiener denoising')
    p.add_argument('image', type=Path)
    p.add_argument('--noise', type=float, default=0.05, help='Added gaussian noise sigma')
    p.add_argument('--sigma', type=float, default=None,
                   help='Filter noise sigma (default: estimated)')
    p.add_argument('--tile-size', type=int, default=32, choices=[16, 32])
    p.add_argument('--overlap', type=int, default=4, choices=[2, 4, 8])
    p.add_argument('--mode', choices=['rgb', 'luminance', 'log_luminance', 'log'], default='rgb')
    p.add_argument('--output', type=Path, default=None)
    add_device_argument(p)
    return p


def run(rgb: torch.Tensor, args, device) -> dict[str, torch.Tensor]:
    """The image, its noisy copy and the denoised result."""
    h, w = rgb.shape[:2]
    rng = np.random.default_rng(0)
    noise = to_device(rng.normal(0.0, args.noise, tuple(rgb.shape)).astype(np.float32), rgb.device)
    noisy = torch.clamp(rgb + noise, 0.0, 1.0)

    wiener = Wiener(device, (w, h), overlap_factor=args.overlap, tile_size=args.tile_size)
    sigma = args.sigma
    if sigma is None:
        sigma = estimate_channel_noise(noisy)
        print('estimated channel noise:', sigma.cpu().numpy())
        if args.mode != 'rgb':
            sigma = float(sigma.mean())

    if args.mode == 'rgb':
        out = wiener.process(noisy, sigma)
    elif args.mode == 'luminance':
        out = wiener.process_luminance(noisy, float(sigma))
    elif args.mode == 'log_luminance':
        out = wiener.process_log_luminance(noisy, float(sigma))
    else:
        out = wiener.process_log(noisy, float(sigma))
    return {'original': rgb, 'noisy': noisy, 'denoised': out}


def main(argv=None):
    args = parser().parse_args(argv)
    images = run(load_image(args.image, args.device), args, args.device)
    display_images(images, output=args.output,
                   title=f'wiener {args.tile_size}x{args.overlap} ({args.mode})')


if __name__ == '__main__':
    main()
