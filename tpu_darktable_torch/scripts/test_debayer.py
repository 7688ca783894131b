"""Visual demosaic test (counterpart of tpu_darktable/scripts/test_debayer.py):
mosaic an RGB image, demosaic it with bilinear, PPG or RCD, and show or
save the two side by side.

    python -m tpu_darktable_torch.scripts.test_debayer IMAGE [--algorithm rcd]
        [--output cmp.png] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from ..debayer import PPG, RCD
from ..ops.bayer import BayerPattern, rgb_to_bayer
from ..ops.demosaic import bilinear5x5_demosaic
from .util import add_device_argument, display_images, load_image


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description='Test debayer algorithms')
    p.add_argument('image', type=Path, help='Input image path')
    p.add_argument('--algorithm', choices=['bilinear', 'ppg', 'rcd'], default='rcd')
    p.add_argument('--pattern', type=str, default='RGGB', choices=[p.name for p in BayerPattern])
    p.add_argument('--median-threshold', type=float, default=0.0)
    p.add_argument('--output', type=Path, default=None, help='Save comparison instead of showing')
    add_device_argument(p)
    return p


def run(rgb: torch.Tensor, args, device) -> dict[str, torch.Tensor]:
    """The (H, W, 3) image and its demosaiced mosaic, clipped to [0, 1]."""
    pattern = BayerPattern[args.pattern]
    bayer = rgb_to_bayer(rgb, pattern)
    h, w = bayer.shape[:2]
    if args.algorithm == 'bilinear':
        out = bilinear5x5_demosaic(bayer, pattern)
    elif args.algorithm == 'ppg':
        out = PPG(device, (w, h), pattern, median_threshold=args.median_threshold).process(bayer)
    else:
        out = RCD(device, (w, h), pattern).process(bayer)
    return {'original': rgb, f'{args.algorithm} demosaic': torch.clamp(out, 0.0, 1.0)}


def main(argv=None):
    args = parser().parse_args(argv)
    images = run(load_image(args.image, args.device), args, args.device)
    display_images(images, output=args.output, title=f'{args.algorithm} ({args.pattern})')


if __name__ == '__main__':
    main()
