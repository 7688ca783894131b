"""Visual bilateral-grid test (counterpart of
tpu_darktable/scripts/test_bilateral.py): the local-contrast boost of an
RGB image, in linear or log space.

    python -m tpu_darktable_torch.scripts.test_bilateral IMAGE [--sigma-s 2]
        [--log-space] [--output cmp.png] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from ..local_contrast import Bilateral
from .util import add_device_argument, display_images, load_image


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description='Test bilateral grid local contrast')
    p.add_argument('image', type=Path)
    p.add_argument('--sigma-s', type=float, default=2.0)
    p.add_argument('--sigma-r', type=float, default=0.2)
    p.add_argument('--detail', type=float, default=0.4)
    p.add_argument('--log-space', action='store_true')
    p.add_argument('--output', type=Path, default=None)
    add_device_argument(p)
    return p


def run(rgb: torch.Tensor, args, device) -> dict[str, torch.Tensor]:
    h, w = rgb.shape[:2]
    bil = Bilateral(device, (w, h), sigma_s=args.sigma_s, sigma_r=args.sigma_r)
    if args.log_space:
        out = bil.process_log_rgb(rgb, args.detail)
    else:
        out = bil.process_rgb(rgb, args.detail)
    return {'original': rgb, 'bilateral': out}


def main(argv=None):
    args = parser().parse_args(argv)
    images = run(load_image(args.image, args.device), args, args.device)
    display_images(images, output=args.output,
                   title=f'bilateral (sigma_s={args.sigma_s}, sigma_r={args.sigma_r}, '
                         f'detail={args.detail})')


if __name__ == '__main__':
    main()
