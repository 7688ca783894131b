"""Shared helpers of the port's command-line tools (counterpart of
tpu_darktable/scripts/util.py).  Image display falls back to writing a
comparison PNG when there is no display."""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device, to_device


def add_device_argument(parser: argparse.ArgumentParser) -> None:
    parser.add_argument('--device', type=str, default='cuda',
                        help="Device to run on (default cuda; 'cpu' runs the plain versions)")


def _host(image) -> np.ndarray:
    return image.detach().cpu().numpy() if isinstance(image, torch.Tensor) else np.asarray(image)


def load_image(image_path: Path, device=None) -> torch.Tensor:
    """An RGB image file -> (H, W, 3) float32 tensor in [0, 1] on `device`
    (the card unless the caller asks for the CPU)."""
    from PIL import Image

    image_path = Path(image_path)
    if not image_path.exists():
        raise FileNotFoundError(f'Image not found: {image_path}')
    arr = np.asarray(Image.open(image_path).convert('RGB'), dtype=np.float32) / 255.0
    return to_device(torch.from_numpy(arr), resolve_device(device))


def save_image(image, path: Path) -> None:
    """Save a float [0, 1] or uint8 (H, W, 3) image."""
    from PIL import Image

    arr = _host(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0).round().astype(np.uint8)
    Image.fromarray(arr).save(path)


def display_images(named_images: dict, output: Path | None = None, title: str = '') -> None:
    """Show images side by side; without a display (or given `output`),
    save a comparison PNG instead."""
    import matplotlib

    headless = output is not None or not os.environ.get('DISPLAY')
    if headless:
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    n = len(named_images)
    fig, axes = plt.subplots(1, n, figsize=(6 * n, 6))
    if n == 1:
        axes = [axes]
    for ax, (name, img) in zip(axes, named_images.items()):
        arr = _host(img)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0.0, 1.0)
        ax.imshow(arr)
        ax.set_title(name)
        ax.axis('off')
    fig.suptitle(title)
    fig.tight_layout()
    if headless:
        out = output or Path('comparison.png')
        fig.savefig(out, dpi=100)
        print(f'saved {out}')
    else:
        plt.show()
    plt.close(fig)


__all__ = ['add_device_argument', 'display_images', 'load_image', 'save_image']
