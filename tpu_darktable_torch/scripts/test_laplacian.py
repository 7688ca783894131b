"""Visual local-Laplacian test (counterpart of
tpu_darktable/scripts/test_laplacian.py).

    python -m tpu_darktable_torch.scripts.test_laplacian IMAGE [--clarity 0.3]
        [--output cmp.png] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from ..local_contrast import Laplacian, LaplacianParams
from .util import add_device_argument, display_images, load_image


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description='Test local Laplacian filter')
    p.add_argument('image', type=Path)
    p.add_argument('--sigma', type=float, default=0.2)
    p.add_argument('--shadows', type=float, default=1.0)
    p.add_argument('--highlights', type=float, default=1.0)
    p.add_argument('--clarity', type=float, default=0.0)
    p.add_argument('--num-gamma', type=int, default=6)
    p.add_argument('--output', type=Path, default=None)
    add_device_argument(p)
    return p


def run(rgb: torch.Tensor, args, device) -> dict[str, torch.Tensor]:
    h, w = rgb.shape[:2]
    params = LaplacianParams(num_gamma=args.num_gamma, sigma=args.sigma, shadows=args.shadows,
                             highlights=args.highlights, clarity=args.clarity)
    return {'original': rgb, 'laplacian': Laplacian(device, (w, h), params).process_rgb(rgb)}


def main(argv=None):
    args = parser().parse_args(argv)
    images = run(load_image(args.image, args.device), args, args.device)
    display_images(images, output=args.output,
                   title=f'local laplacian (sigma={args.sigma}, clarity={args.clarity})')


if __name__ == '__main__':
    main()
