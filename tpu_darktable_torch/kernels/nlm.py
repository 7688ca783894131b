"""Non-local means: wrapper of csrc/nlm.cu and its plain version.

Replaces the TPU kernel tpu_darktable/kernels/nlm.py:nlm_core: for each of
the (2sr+1)^2 search offsets, the squared difference between the image and
its edge-clamped shift summed over channels, zero outside the image,
box-summed over the (2pr+1)^2 patch, weighted by exp(-dist * inv_h2) and
accumulated with the shifted image; out = acc / wsum.

On the H100 the search is bound by its ~25 float ops a pixel and offset
(~1.2k a pixel at sr=3, pr=1, C=3), not by its 8C bytes a pixel; what a
simple kernel pays instead is shared-memory traffic.  At the shapes the
port runs (C = 3 or 1, sr=3, pr=1) the kernel keeps a 32 x 32 tile and its
sr + pr reach in shared memory, so the image crosses HBM once each way, and
each thread keeps the sums, the centre values and the shifted values of its
four pixels in registers through the whole offset loop; only the box sum's
column sums cross shared memory, one barrier an offset.  Any other C or
radii run a general kernel with its sums in shared memory.  The weight's
expf stays IEEE, which is most of what still separates it from the bound.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import launch


def nlm_core(planes: torch.Tensor, inv_h2: float, *, search_radius: int = 3,
             patch_radius: int = 1) -> torch.Tensor:
    """(C, H, W) float32 planes and inv_h2 = 1 / (h^2 (2pr+1)^2 C) ->
    (C, H, W) float32 denoised planes."""
    if planes.dtype != torch.float32 or planes.ndim != 3:
        raise RuntimeError(f'planes must be (C, H, W) float32, got {planes.dtype} {tuple(planes.shape)}')
    if not planes.is_contiguous():
        raise RuntimeError('planes must be contiguous')
    if search_radius < 0 or patch_radius < 0:
        raise ValueError(f'radii must be >= 0, got {search_radius}, {patch_radius}')
    if planes.device.type == 'cpu':
        return nlm_core_plain(planes, inv_h2, search_radius=search_radius,
                              patch_radius=patch_radius)
    out = torch.empty_like(planes)
    launch('nlm_core', planes.device, planes, out, *planes.shape, search_radius, patch_radius,
           float(inv_h2))
    return out


def nlm_core_plain(planes: torch.Tensor, inv_h2: float, *, search_radius: int = 3,
                   patch_radius: int = 1) -> torch.Tensor:
    """Plain PyTorch version: the offset loop of the JAX package's XLA path
    (tpu_darktable/ops/nlm.py nlm_denoise), on channel planes."""
    c, h, w = planes.shape
    sr, pr = search_radius, patch_radius
    dev = planes.device
    rows = torch.clamp(torch.arange(-sr, h + sr, device=dev), 0, h - 1)
    cols = torch.clamp(torch.arange(-sr, w + sr, device=dev), 0, w - 1)
    xp = planes.index_select(1, rows).index_select(2, cols)
    n = 2 * sr + 1
    acc = torch.zeros_like(planes)
    wsum = torch.zeros((h, w), dtype=planes.dtype, device=dev)
    for dy in range(n):
        for dx in range(n):
            shifted = xp[:, dy:dy + h, dx:dx + w]
            diff = planes - shifted
            d2 = 0.0
            for ch in range(c):
                d2 = d2 + diff[ch] * diff[ch]
            # box sum with zero fill: rows first, then columns
            p = F.pad(d2, (pr, pr, pr, pr))
            rsum = 0.0
            for t in range(2 * pr + 1):
                rsum = rsum + p[t:t + h]
            dist = 0.0
            for t in range(2 * pr + 1):
                dist = dist + rsum[:, t:t + w]
            wgt = torch.exp(-dist * inv_h2)
            acc = acc + wgt * shifted
            wsum = wsum + wgt
    return acc / wsum


__all__ = ['nlm_core', 'nlm_core_plain']
