"""The LAB round trip of the luminance stages: wrappers of the two kernels
of csrc/lab.cu and their plain versions.

Replaces no TPU kernel: the JAX package leaves the round trip to XLA,
which fuses it.  Each luminance stage (Wiener denoise, the bilateral
detail boost, the local Laplacian) splits sRGB into LAB and a luminance
plane, maps the plane and merges it back; ops/color.py's
`rgb_to_lab_with_clipped_l`, `rgb_to_lab_with_l` and `lab_modify_luminance`
call these wrappers, so every caller on the card takes the kernels.

`lab_split` reads sRGB (..., 3) and writes LAB (..., 3) and a contiguous
plane (...): LAB L of the clipped linear values, or L itself.
`lab_merge` reads LAB's a and b and a new plane and writes
clip01(lab_to_rgb(cat(lum, a, b))).  Both are bound by bytes, 28 a pixel.

On the card the kernels equal the plain versions run there bit for bit
(csrc/lab.cu rounds as PyTorch's CUDA kernels do).  The CPU runs the plain
versions, today's chain of ops/color.py.
"""

from __future__ import annotations

import torch

from . import launch
from .._validate import check_channels_last
# ops.color calls these wrappers and the plain versions call its chain:
# each module reads the other's names only when called.
from ..ops import color as _color


def _check_float32(**tensors: torch.Tensor) -> None:
    """The kernels take float32 only; the CPU's chain takes any dtype."""
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise RuntimeError(f'{name} must be a float32 tensor, got {t.dtype} {tuple(t.shape)}')


def lab_split(rgb: torch.Tensor, *, clipped_l: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """sRGB (..., 3) -> (LAB (..., 3), lum (...) contiguous): lum is the
    LAB L of clip01(rgb) if `clipped_l`, else LAB's own L."""
    check_channels_last(rgb, 'rgb')
    if rgb.device.type == 'cpu':
        return lab_split_plain(rgb, clipped_l=clipped_l)
    _check_float32(rgb=rgb)
    x = rgb.contiguous()
    lab = torch.empty_like(x)
    lum = torch.empty(x.shape[:-1], dtype=x.dtype, device=x.device)
    if lum.numel():
        launch('lab_split', x.device, x, lab, lum, lum.numel(), int(clipped_l))
    return lab, lum


def lab_merge(lab: torch.Tensor, lum: torch.Tensor) -> torch.Tensor:
    """LAB (..., 3) with its L replaced by lum (...) -> clipped sRGB (..., 3)."""
    check_channels_last(lab, 'lab')
    if tuple(lum.shape) != tuple(lab.shape[:-1]):
        raise RuntimeError(f'lum shape {tuple(lum.shape)} must match lab leading dims '
                           f'{tuple(lab.shape[:-1])}')
    if lab.device.type == 'cpu':
        return lab_merge_plain(lab, lum)
    _check_float32(lab=lab, lum=lum)
    x, l = lab.contiguous(), lum.contiguous()
    out = torch.empty_like(x)
    if l.numel():
        launch('lab_merge', x.device, x, l, out, l.numel())
    return out


def lab_split_plain(rgb: torch.Tensor, *, clipped_l: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the clipped L shares the sRGB decode, since
    the decode commutes with clip01."""
    lin = _color.srgb_to_linear(rgb)
    lab = _color.xyz_to_lab(_color.color_transform_3x3(lin, _color._RGB_TO_XYZ))
    if clipped_l:
        lin = _color._clip01(lin)
        lum = _color.xyz_to_lab(_color.color_transform_3x3(lin, _color._RGB_TO_XYZ))[..., 0]
    else:
        lum = lab[..., 0]
    return lab, lum.contiguous()


def lab_merge_plain(lab: torch.Tensor, lum: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version."""
    lab = torch.cat((lum[..., None], lab[..., 1:]), dim=-1)
    return _color._clip01(_color.lab_to_rgb(lab))


__all__ = ['lab_merge', 'lab_merge_plain', 'lab_split', 'lab_split_plain']
