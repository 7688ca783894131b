"""A-trous wavelet shrinkage and non-local means (counterpart of
tpu_darktable/ops/nlm.py).

Both take (H, W) or (H, W, C) float32 images and hand channel planes to
their kernel wrappers (kernels/wavelet.py, kernels/nlm.py): the hand
kernel on the card, its plain version on the CPU, at any size and depth.
"""

from __future__ import annotations

import torch

from .._device import constant_on, to_device
from ..kernels.nlm import nlm_core
from ..kernels.wavelet import wavelet_core

_F32 = torch.float32


def _planes(image: torch.Tensor):
    x = torch.as_tensor(image).to(_F32)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    if x.ndim != 3:
        raise RuntimeError(f'image must be (H, W) or (H, W, C), got shape {tuple(x.shape)}')
    return x.permute(2, 0, 1).contiguous(), squeeze


def _image(planes: torch.Tensor, squeeze: bool) -> torch.Tensor:
    out = planes.permute(1, 2, 0)
    return out[..., 0] if squeeze else out


def wavelet_denoise(image: torch.Tensor, sigma, levels: int = 4,
                    threshold_scale: float = 3.0) -> torch.Tensor:
    """A-trous wavelet soft-threshold denoise.

    Args:
        image: (H, W) or (H, W, C) float32.
        sigma: noise sigma (scalar or per-channel (C,)).
        levels: decomposition depth.
        threshold_scale: threshold = scale * sigma * 2^-level.

    Returns:
        Denoised image, same shape.
    """
    planes, squeeze = _planes(image)
    # a host sigma comes from the device cache: no copy a call (nor in a CUDA graph)
    sig = (to_device(sigma, planes.device, _F32) if isinstance(sigma, torch.Tensor)
           else constant_on(sigma, planes.device, _F32)).reshape(-1)
    sig = sig.expand(planes.shape[0]).contiguous()
    out = wavelet_core(planes, threshold_scale * sig, levels=levels)
    return _image(out, squeeze)


def nlm_denoise(image: torch.Tensor, strength: float, search_radius: int = 3,
                patch_radius: int = 1) -> torch.Tensor:
    """Non-local means over a (2*search_radius+1)^2 window, offset-major.

    Args:
        image: (H, W) or (H, W, C) float32.
        strength: filtering strength h (typical: the noise sigma).
        search_radius: half-width of the search window.
        patch_radius: half-width of the comparison patch.

    Returns:
        Denoised image, same shape.
    """
    planes, squeeze = _planes(image)
    n_patch = (2 * patch_radius + 1) ** 2
    inv_h2 = 1.0 / (strength * strength * n_patch * planes.shape[0])
    out = nlm_core(planes, inv_h2, search_radius=search_radius, patch_radius=patch_radius)
    return _image(out, squeeze)


__all__ = ['nlm_denoise', 'wavelet_denoise']
