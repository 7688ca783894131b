"""Card-only checks of the port's kernels, importing nothing of JAX so that
they also run where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(tests/conftest.py imports JAX; nothing here needs it).  Each new kernel
against its plain version on a CUDA tensor, at small and ragged sizes
(tiles that do not divide the frame), and the launch counts.  Without a
card every test skips with its reason.
"""

import numpy as np
import pytest
import torch

from tpu_darktable_torch import kernels
from tpu_darktable_torch.kernels.grid_blur import grid_blur_xyz, grid_blur_xyz_plain
from tpu_darktable_torch.kernels.nlm import nlm_core, nlm_core_plain
from tpu_darktable_torch.kernels.wavelet import wavelet_core, wavelet_core_plain
from tpu_darktable_torch.ops import bilateral, nlm


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; chip_smoke.py runs these kernels on the card')
    return torch.device('cuda')


def _rand(seed, shape, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random(shape).astype(np.float32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize('z_mode', ['derivative', 'gaussian'])
def test_grid_blur_on_card(dev, z_mode):
    """Against the plain version: 1e-6 (same tap order, --fmad=false)."""
    grid = _rand(1, (9, 101, 150), dev)
    err = (grid_blur_xyz(grid, z_mode=z_mode) - grid_blur_xyz_plain(grid, z_mode=z_mode))
    assert err.abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize('levels', [1, 4, 6])
def test_wavelet_on_card(dev, levels):
    """The shared-memory cascade and the deeper HBM passes: 1e-6."""
    x = _rand(2, (3, 130, 200), dev)
    thr = torch.tensor([0.15, 0.1, 0.2], device=dev)
    err = wavelet_core(x, thr, levels=levels) - wavelet_core_plain(x, thr, levels=levels)
    assert err.abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize('c,sr,pr', [(3, 3, 1), (1, 2, 2)])
def test_nlm_on_card(dev, c, sr, pr):
    """Against the plain version: 1e-5 (CUDA expf against torch.exp)."""
    x = _rand(3, (c, 130, 200), dev)
    inv_h2 = 1.0 / (0.05 * 0.05 * (2 * pr + 1) ** 2 * c)
    err = (nlm_core(x, inv_h2, search_radius=sr, patch_radius=pr)
           - nlm_core_plain(x, inv_h2, search_radius=sr, patch_radius=pr))
    assert err.abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_paths_launch_their_kernels(dev):
    """On CUDA tensors the ops always launch their kernel, whatever the
    size or depth."""
    kernels.reset_launches()
    img = _rand(4, (50, 70, 3), dev)
    nlm.wavelet_denoise(img, 0.05, levels=7)
    nlm.nlm_denoise(img[..., 0], 0.05)
    lum = _rand(5, (50, 70), dev)
    bilateral.bilateral_process(lum, 3.0, 0.2, 0.4)
    bilateral.bilateral_denoise(lum, 2.5, 0.2, 0.5)
    assert kernels.launches['wavelet_core'] == 1
    assert kernels.launches['nlm_core'] == 1
    assert kernels.launches['grid_blur_xyz'] == 3
    assert kernels.launches['bilateral_band'] == 0
