"""A-trous wavelet shrinkage: wrapper of csrc/wavelet.cu and its plain
version.

Replaces the TPU kernel tpu_darktable/kernels/wavelet.py:wavelet_core: on
channel planes, `levels` a-trous B3 levels, each a dilated 5-tap blur of the
rows then of the columns with edge padding, the detail soft-thresholded at
thr * 0.5**lvl and added to a residual; out = current + residual.

On the H100 the cascade is bound by its ~25 float ops a level and pixel,
not by its 8 bytes a pixel (one read, one write); what is scarce is the
halo a tile must carry and recompute, which doubles with every level it
fuses.  The launcher runs the levels in groups: the first three in one
64 x 64 tile in shared memory (a 14-px halo; the residual in registers;
blocks off the image's rim read their taps without clamping); each later
level in one launch that takes its rows pass straight from the current
plane into shared memory and runs the columns pass there (no halo above or
below, 16 bytes a pixel through HBM); steps past 64 as a rows pass and a
columns pass through HBM.  `current` and the residual are handed on in
scratch planes, so any depth runs on the card.  The grouping moves no sum:
the kernel equals the plain version bit for bit.
"""

from __future__ import annotations

import torch

from . import _build, launch

_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
MAX_LEVELS = 30   # a step of 2**levels must fit an int


def _check(planes: torch.Tensor, thresholds: torch.Tensor, levels: int) -> None:
    if planes.dtype != torch.float32 or planes.ndim != 3:
        raise RuntimeError(f'planes must be (C, H, W) float32, got {planes.dtype} {tuple(planes.shape)}')
    if not planes.is_contiguous():
        raise RuntimeError('planes must be contiguous')
    if (thresholds.dtype != torch.float32 or tuple(thresholds.shape) != (planes.shape[0],)
            or thresholds.device != planes.device):
        raise RuntimeError(f'thresholds must be ({planes.shape[0]},) float32 on {planes.device}, '
                           f'got {thresholds.dtype} {tuple(thresholds.shape)} on {thresholds.device}')
    if not 0 <= levels <= MAX_LEVELS:
        raise ValueError(f'levels must be in [0, {MAX_LEVELS}], got {levels}')


def wavelet_core(planes: torch.Tensor, thresholds: torch.Tensor, *, levels: int = 4) -> torch.Tensor:
    """(C, H, W) float32 planes and (C,) base thresholds (scale * sigma) ->
    (C, H, W) float32 denoised planes."""
    _check(planes, thresholds, levels)
    if planes.device.type == 'cpu':
        return wavelet_core_plain(planes, thresholds, levels=levels)
    out = torch.empty_like(planes)
    # levels past the launcher's shared-memory tile hand `current` on through
    # two scratch planes
    deep = levels > _build.load(_build.ENTRIES['wavelet_core'].source).wavelet_fused_levels()
    cur = torch.empty_like(planes) if deep else None
    tmp = torch.empty_like(planes) if deep else None
    launch('wavelet_core', planes.device, planes, thresholds.contiguous(), out, cur, tmp,
           *planes.shape, levels)
    return out


def _atrous_blur(x: torch.Tensor, step: int) -> torch.Tensor:
    """Separable 5-tap B3 blur of (C, H, W) planes with taps `step` apart
    and edge padding (clamped coordinates)."""
    h, w = x.shape[-2:]
    rows = torch.arange(h, device=x.device)
    out = 0.0
    for t, wt in enumerate(_B3):
        out = out + wt * x.index_select(-2, torch.clamp(rows + (t - 2) * step, 0, h - 1))
    cols = torch.arange(w, device=x.device)
    res = 0.0
    for t, wt in enumerate(_B3):
        res = res + wt * out.index_select(-1, torch.clamp(cols + (t - 2) * step, 0, w - 1))
    return res


def wavelet_core_plain(planes: torch.Tensor, thresholds: torch.Tensor, *,
                       levels: int = 4) -> torch.Tensor:
    """Plain PyTorch version: the level loop of the JAX package's XLA path
    (tpu_darktable/ops/nlm.py wavelet_denoise), on channel planes."""
    current = planes
    residual = 0.0
    for lvl in range(levels):
        smooth = _atrous_blur(current, 1 << lvl)
        detail = current - smooth
        thr = (thresholds * (0.5 ** lvl))[:, None, None]
        detail = torch.sign(detail) * torch.clamp(torch.abs(detail) - thr, min=0.0)
        residual = residual + detail
        current = smooth
    return current + residual


__all__ = ['wavelet_core', 'wavelet_core_plain']
