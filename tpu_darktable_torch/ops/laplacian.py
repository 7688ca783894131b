"""Local-Laplacian local contrast (counterpart of
tpu_darktable/ops/laplacian.py).

Gaussian pyramids of the clamp-padded luminance and of `num_gamma`
remapped copies, assembled coarse to fine by picking the Laplacian
coefficients of the two remapped pyramids that bracket each pixel's value.
Pyramids are lists of tensors; the reference's float16 storage between
stages is emulated by rounding to `storage_dtype` after each stage, with
the arithmetic in float32.  Plain PyTorch on the tensor's device: the JAX
package has no Pallas kernel here.

Geometry: num_levels = min(30, floor(log2(min(w, h)))), the full pad
1 << (num_levels - 1), clamp-to-edge padding, boundary-clamped expansion.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .._device import device_cache, scalar_on, to_device
from ..utils import timing

_F32 = torch.float32
MAX_LEVELS = 30
_TAPS = tuple(float(v) for v in np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0)


@dataclass(frozen=True)
class LaplacianParams:
    num_gamma: int = 6
    sigma: float = 0.2
    shadows: float = 1.0
    highlights: float = 1.0
    clarity: float = 0.0


def _dl(x: int, level: int) -> int:
    """Level dimension: ceil division by 2^level."""
    return (x + (1 << level) - 1) >> level


def num_levels_for(width: int, height: int) -> int:
    return min(MAX_LEVELS, int(math.floor(math.log2(min(width, height)))))


def curve_deviation(params: LaplacianParams) -> float:
    """Upper bound on |curve(x, g) - x| over x in [0, 1+sigma], any g: the
    linear and bezier branches deviate by at most |shadhi - 1|(1 + sigma),
    the clarity term by ~0.35 sigma |clarity|."""
    dev_sh = max(abs(params.shadows - 1.0), abs(params.highlights - 1.0))
    return dev_sh * (1.0 + params.sigma) + 0.35 * params.sigma * abs(params.clarity)


def auto_max_supp(width: int, height: int, params: LaplacianParams,
                  pad_tolerance: float = 0.0) -> int:
    """Smallest boundary pad that reproduces the full-pad result.

    With the identity curve (neutral shadows, highlights and clarity) the
    assembly telescopes to the padded input at every level, so any pad is
    exact; 32 keeps every level >= 3 px for the boundary clamps.  Otherwise
    the full pad, unless `pad_tolerance` > 0 admits the smallest pad whose
    bound 0.01 * curve_deviation * (levels whose edge clamps reach the
    crop) stays within it.
    """
    n_levels = num_levels_for(width, height)
    full = 1 << (n_levels - 1)
    dev = curve_deviation(params)
    if dev == 0.0:
        return min(32, full)
    if pad_tolerance > 0.0:
        pad = 32
        while pad < full:
            n_corrupt = sum(1 for l in range(n_levels) if (8 << l) > pad)
            if 0.01 * dev * n_corrupt <= pad_tolerance:
                return pad
            pad *= 2
    return full


def _gauss_reduce(fine: torch.Tensor, ch: int, cw: int, storage) -> torch.Tensor:
    """5x5 [1, 4, 6, 4, 1]/16 reduce to (ch, cw); the edge rows and columns
    copy their neighbours."""
    p = F.pad(fine.to(_F32), (2, 6, 2, 6))
    rows = _TAPS[0] * p[0 : 2 * ch : 2, :]
    for j in range(1, 5):
        rows = rows + _TAPS[j] * p[j : j + 2 * ch : 2, :]
    out = _TAPS[0] * rows[:, 0 : 2 * cw : 2]
    for i in range(1, 5):
        out = out + _TAPS[i] * rows[:, i : i + 2 * cw : 2]
    out = torch.cat([out[1:2], out[1:-1], out[-2:-1]], dim=0)
    out = torch.cat([out[:, 1:2], out[:, 1:-1], out[:, -2:-1]], dim=1)
    return out.to(storage)


def _expand_axis(c: torch.Tensor, n_fine: int, axis: int) -> torch.Tensor:
    """Zero-stuffed 5-tap expand along one axis (no x4 factor)."""
    c = c.movedim(axis, 0)
    cp = F.pad(c, (0, 0, 1, 1))
    even = (cp[:-2] + 6.0 * cp[1:-1] + cp[2:]) / 16.0
    odd = 4.0 * (cp[1:-1] + cp[2:]) / 16.0
    inter = torch.stack((even, odd), dim=1).reshape((2 * c.shape[0],) + c.shape[1:])
    return inter[:n_fine].movedim(0, axis)


@device_cache(maxsize=128)
def _clamp_idx(n: int, dev: torch.device) -> torch.Tensor:
    """clamp_boundary for one axis, on the device, built once a geometry
    (the pipeline calls the stage every frame)."""
    hi = n - 2 if (n & 1) else n - 3
    return to_device(np.clip(np.arange(n), 1, hi), dev, torch.int64)


def _expand_clamped(coarse: torch.Tensor, fh: int, fw: int) -> torch.Tensor:
    """The 4x expand of `coarse` to (fh, fw), read at clamp_boundary'd
    positions."""
    e = _expand_axis(_expand_axis(coarse.to(_F32), fh, 0), fw, 1) * 4.0
    return e.index_select(0, _clamp_idx(fh, e.device)).index_select(1, _clamp_idx(fw, e.device))


def _curve(x, g, sigma, shadows, highlights, clarity):
    """The shadows/highlights remap curve plus the clarity term."""
    c = x - g
    pos = c > 0.0
    ssigma = torch.where(pos, sigma, -sigma)
    shadhi = torch.where(pos, shadows, highlights)
    linear = g + ssigma + shadhi * (c - ssigma)
    t = torch.clamp(c / (2.0 * ssigma), 0.0, 1.0)
    t2 = t * t
    mt = 1.0 - t
    bezier = g + ssigma * 2.0 * mt * t + t2 * (ssigma + ssigma * shadhi)
    val = torch.where(torch.abs(c) > 2.0 * sigma, linear, bezier)
    spread = scalar_on(2.0 * sigma * sigma / 3.0, x.device)
    return val + clarity * c * torch.exp(-c * c / spread)


def local_laplacian(mono, params: LaplacianParams = LaplacianParams(),
                    storage_dtype=torch.float16, max_supp: int | str | None = 'auto',
                    pad_tolerance: float = 0.0) -> torch.Tensor:
    """Local-Laplacian filter of an (H, W) luminance plane, on its device.

    `storage_dtype` emulates the reference's float16 pyramid storage
    (float32 for no rounding between stages).  `max_supp` is the boundary
    pad: 'auto' (auto_max_supp: the token pad for neutral parameters, the
    full pad otherwise unless `pad_tolerance` admits a smaller one), None
    (always the full pad 1 << (n_levels - 1)) or an int.
    """
    x = torch.as_tensor(mono, dtype=_F32)
    if x.ndim != 2:
        raise RuntimeError(f'mono must be a 2-D (H, W) plane, got shape {tuple(x.shape)}')
    h, w = x.shape
    ng = params.num_gamma
    sigma, shadows = float(params.sigma), float(params.shadows)
    highlights, clarity = float(params.highlights), float(params.clarity)

    n_levels = num_levels_for(w, h)
    if max_supp == 'auto':
        max_supp = auto_max_supp(w, h, params, pad_tolerance)
    elif max_supp is None:
        max_supp = 1 << (n_levels - 1)
    bw, bh = w + 2 * max_supp, h + 2 * max_supp
    dims = [(_dl(bh, l), _dl(bw, l)) for l in range(n_levels)]

    # clamp-to-edge pad, then the plain pyramid
    pad = (max_supp,) * 4
    padded = [F.pad(x[None, None], pad, mode='replicate')[0, 0].to(storage_dtype)]
    for l in range(1, n_levels):
        padded.append(_gauss_reduce(padded[l - 1], *dims[l], storage_dtype))

    # the gamma-remapped pyramids
    processed = []
    base = padded[0].to(_F32)
    for k in range(ng):
        g = (k + 0.5) / ng
        pyr = [_curve(base, g, sigma, shadows, highlights, clarity).to(storage_dtype)]
        for l in range(1, n_levels):
            pyr.append(_gauss_reduce(pyr[l - 1], *dims[l], storage_dtype))
        processed.append(pyr)
    del base
    # from the stage's opening mark to here: the seven pyramids; from here
    # to its closing mark, the assembly
    timing.mark('lap.pyramids')

    # coarse-to-fine assembly; each level's inputs are dropped once used
    output = padded[n_levels - 1]
    for l in range(n_levels - 2, -1, -1):
        fh, fw = dims[l]
        recon = _expand_clamped(output, fh, fw)

        v = padded[l].to(_F32)
        t = v * ng - 0.5
        hi = torch.clamp(torch.floor(t).to(torch.int32) + 1, 1, ng - 1)
        lo = hi - 1
        a = torch.clamp(t - lo.to(_F32), 0.0, 1.0)

        lap = torch.zeros((fh, fw), dtype=_F32, device=x.device)
        for k in range(ng):
            lk = processed[k][l].to(_F32) - _expand_clamped(processed[k][l + 1], fh, fw)
            wk = torch.where(lo == k, 1.0 - a, torch.where(hi == k, a, 0.0))
            lap = lap + lk * wk
            processed[k][l + 1] = None
        padded[l + 1] = None

        output = (recon + lap).to(storage_dtype)

    return output[max_supp : max_supp + h, max_supp : max_supp + w].to(_F32)


__all__ = [
    'LaplacianParams',
    'auto_max_supp',
    'curve_deviation',
    'local_laplacian',
    'num_levels_for',
]
