"""The LAB round trip of the luminance stages on the CPU: kernels/lab.py's
wrappers and the three functions of ops/color.py that call them.

A CPU tensor takes the plain chain, value for value what ops/color.py
computed before the wrappers (its unchanged primitives composed as it
composed them), and launches nothing; a tensor elsewhere is checked for
what the kernels take and handed to `kernels.launch` with the entry
points' arguments (a `meta` tensor stands in for a CUDA one).  The kernels
themselves: tests/test_torch_csrc_emu.py on the host, tests/test_torch_cuda.py
on the card.
"""

import re

import numpy as np
import pytest
import torch

from tpu_darktable_torch import kernels
from tpu_darktable_torch.kernels import lab as klab
from tpu_darktable_torch.kernels._build import ENTRIES
from tpu_darktable_torch.ops import color

import lab_grids


def _same(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _chain_lab(rgb):
    return color.xyz_to_lab(color.rgb_to_xyz(rgb))


def _chain_clipped_l(rgb):
    lin = color._clip01(color.srgb_to_linear(rgb))
    return color.xyz_to_lab(color.color_transform_3x3(lin, color._RGB_TO_XYZ))[..., 0]


def _chain_merge(lab, lum):
    return color._clip01(color.lab_to_rgb(torch.cat((lum[..., None], lab[..., 1:]), dim=-1)))


def _inputs(rng, shape):
    rgb = torch.from_numpy(rng.uniform(-0.1, 1.2, shape).astype(np.float32))
    return rgb, torch.from_numpy(rng.uniform(-0.1, 1.2, shape[:-1]).astype(np.float32))


@pytest.mark.parametrize('shape', [(3,), (7, 3), (16, 24, 3), (2, 9, 13, 3), (0, 3)])
def test_cpu_takes_the_plain_chain(rng, shape):
    """Every function value for value as before, at any leading shape, and
    no launch counted."""
    kernels.reset_launches()
    rgb, new = _inputs(rng, shape)
    _same(color.rgb_to_lab(rgb), _chain_lab(rgb))
    _same(color.rgb_to_lab_l(rgb), _chain_lab(rgb)[..., 0])
    lab, lum = color.rgb_to_lab_with_clipped_l(rgb)
    _same(lab, _chain_lab(rgb))
    _same(lum, _chain_clipped_l(rgb))
    lab, lum = color.rgb_to_lab_with_l(rgb)
    _same(lab, _chain_lab(rgb))
    _same(lum, _chain_lab(rgb)[..., 0])
    _same(color.lab_modify_luminance(lab, new), _chain_merge(lab, new))
    assert all(n == 0 for n in kernels.launches.values())


def test_cpu_takes_the_plain_chain_on_the_edge_grid(rng):
    """The kernels' edge grid (branch thresholds and their neighbours, 0,
    -0, 1, NaN): the plain chain value for value, NaN where it was NaN."""
    rgb = torch.from_numpy(lab_grids.edge_rgb(rng))
    _same(color.rgb_to_lab_with_clipped_l(rgb)[1], _chain_clipped_l(rgb))
    lab_np, lum_np = lab_grids.edge_merge(rng, _chain_lab(rgb).numpy())
    lab, lum = torch.from_numpy(lab_np), torch.from_numpy(lum_np)
    _same(color.lab_modify_luminance(lab, lum), _chain_merge(lab, lum))


@pytest.mark.parametrize('call,message', [
    (lambda: color.rgb_to_lab_with_l(torch.zeros(4, 4)),
     'rgb must have a trailing axis of 3 channels, got shape (4, 4)'),
    (lambda: color.lab_modify_luminance(torch.zeros(4, 2), torch.zeros(4)),
     'lab must have a trailing axis of 3 channels, got shape (4, 2)'),
    (lambda: color.lab_modify_luminance(torch.zeros(4, 3), torch.zeros(4, 1)),
     'lum shape (4, 1) must match lab leading dims (4,)'),
], ids=['split channels', 'merge channels', 'merge lum shape'])
def test_cpu_refuses_the_wrong_shapes(call, message):
    """Shapes are checked on every device."""
    with pytest.raises(RuntimeError, match=re.escape(message)):
        call()


def test_cpu_keeps_other_dtypes(rng):
    """The CPU chain takes what it took before, float64 included; only the
    kernels ask for float32."""
    rgb = torch.from_numpy(rng.uniform(0.0, 1.0, (5, 6, 3)))
    lab, lum = color.rgb_to_lab_with_clipped_l(rgb)
    assert lab.dtype == lum.dtype == torch.float64
    _same(color.lab_modify_luminance(lab, lum), _chain_merge(lab, lum))


@pytest.mark.parametrize('fn', [color.rgb_to_lab_with_clipped_l, color.rgb_to_lab_with_l])
@pytest.mark.parametrize('shape', [(7, 3), (16, 24, 3), (2, 9, 13, 3)])
def test_split_return_contract(rng, fn, shape):
    """(LAB with rgb's shape, a contiguous plane of its leading shape), both
    float32; the plane is no view of the LAB."""
    rgb, _ = _inputs(rng, shape)
    lab, lum = fn(rgb)
    assert tuple(lab.shape) == shape and tuple(lum.shape) == shape[:-1]
    assert lab.dtype == lum.dtype == torch.float32
    assert lum.is_contiguous() and lum.data_ptr() != lab.data_ptr()


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device='meta')


@pytest.mark.parametrize('call,message', [
    (lambda: klab.lab_split(_meta((4, 3), torch.float64), clipped_l=True),
     'rgb must be a float32 tensor, got torch.float64 (4, 3)'),
    (lambda: klab.lab_split(_meta((4, 4)), clipped_l=False),
     'rgb must have a trailing axis of 3 channels, got shape (4, 4)'),
    (lambda: klab.lab_merge(_meta((4, 3), torch.float16), _meta((4,))),
     'lab must be a float32 tensor, got torch.float16 (4, 3)'),
    (lambda: klab.lab_merge(_meta((4, 2)), _meta((4,))),
     'lab must have a trailing axis of 3 channels, got shape (4, 2)'),
    (lambda: klab.lab_merge(_meta((4, 3)), _meta((4,), torch.float16)),
     'lum must be a float32 tensor, got torch.float16 (4,)'),
    (lambda: klab.lab_merge(_meta((4, 3)), _meta((5,))),
     'lum shape (5,) must match lab leading dims (4,)'),
    (lambda: klab.lab_split(_meta((4, 3)), clipped_l=True),
     'lab_split: unsupported device meta'),
], ids=['split dtype', 'split channels', 'merge dtype', 'merge channels', 'merge lum dtype',
        'merge lum shape', 'no card'])
def test_wrapper_refuses_what_the_kernels_do_not_take(call, message):
    """Off the CPU the wrappers take float32 (..., 3) and a plane of its
    leading shape, and raise on anything else (the CPU's chain takes any
    dtype); a tensor that passes goes to kernels.launch, which takes only a
    CUDA device."""
    with pytest.raises(RuntimeError, match=re.escape(message)):
        call()


def test_wrapper_launch_arguments(monkeypatch):
    """The entry points' arguments in their declared order: contiguous
    inputs, outputs allocated by the wrapper, the pixel count, the plane's
    choice; no launch for an empty tensor."""
    calls = []
    monkeypatch.setattr(klab, 'launch', lambda name, device, *args: calls.append((name, device, args)))
    rgb = _meta((3, 5, 2)).permute(1, 2, 0)   # (5, 2, 3), not contiguous
    lab, lum = klab.lab_split(rgb, clipped_l=True)
    out = klab.lab_merge(lab, lum)
    (split_name, split_dev, split_args), (merge_name, _, merge_args) = calls
    assert (split_name, merge_name) == ('lab_split', 'lab_merge') and split_dev.type == 'meta'
    assert len(split_args) == len(ENTRIES['lab_split'].argtypes) - 1   # the stream: launch's
    assert len(merge_args) == len(ENTRIES['lab_merge'].argtypes) - 1
    x, lab_out, lum_out, n, clipped = split_args
    assert x.is_contiguous() and tuple(x.shape) == (5, 2, 3) and lab_out is lab and lum_out is lum
    assert (n, clipped) == (10, 1)
    assert merge_args[0] is lab and merge_args[1] is lum and merge_args[2] is out
    assert merge_args[3] == 10 and tuple(out.shape) == (5, 2, 3)
    klab.lab_split(_meta((4, 3)), clipped_l=False)
    assert calls[-1][2][4] == 0
    calls.clear()
    lab, lum = klab.lab_split(_meta((0, 3)), clipped_l=False)
    klab.lab_merge(lab, lum)
    assert not calls and tuple(lum.shape) == (0,)
