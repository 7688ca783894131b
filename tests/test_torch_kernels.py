"""The port's kernel modules: plain versions against the JAX kernels (run in
interpret mode, as the JAX package's own tests run them) and the JAX XLA
paths, on the CPU.  The CUDA kernels themselves run only on the card: the
`cuda`-marked test here skips without one, and chip_smoke.py holds each
kernel against its plain version at the main path's shapes.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_darktable.kernels.bilateral_band import bilateral_band as j_band, riffle_phases
from tpu_darktable.kernels.color_smooth import color_smooth_diffs as j_csd
from tpu_darktable.ops import bilateral as jbil
from tpu_darktable.ops import rcd as jrcd
from tpu_darktable.ops.bayer import BayerPattern as JPattern

from tpu_darktable_torch import kernels
from tpu_darktable_torch.kernels.bilateral_band import bilateral_band, bilateral_band_plain
from tpu_darktable_torch.kernels.bilateral_fused import bilateral_fused
from tpu_darktable_torch.kernels.color_smooth import color_smooth_diffs, color_smooth_diffs_plain
from tpu_darktable_torch.kernels.grid_blur import grid_blur_xyz
from tpu_darktable_torch.kernels.jpeg_entropy import jpeg_entropy
from tpu_darktable_torch.kernels.lab import lab_merge, lab_split
from tpu_darktable_torch.kernels.nlm import nlm_core
from tpu_darktable_torch.kernels.rcd_interior import RING, rcd_interior, rcd_interior_plain
from tpu_darktable_torch.kernels.wavelet import wavelet_core
from tpu_darktable_torch.kernels.wiener_core import wiener_tile_core
from tpu_darktable_torch.ops import bilateral as tbil
from tpu_darktable_torch.ops import rcd as trcd
from tpu_darktable_torch.ops import wiener as twiener
from tpu_darktable_torch.ops.bayer import BayerPattern as TPattern, site_parities

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- color_smooth_diffs ----

def test_color_smooth_plain_vs_pallas_interpret(rng):
    """Plain version == the JAX Pallas kernel (interpret mode), bit for bit."""
    h, w = 40, 56
    d = (rng.random((2, h, w)) - 0.5).astype(np.float32)
    g = (rng.random((h, w)) - 0.1).astype(np.float32)
    ref = np.asarray(j_csd(jnp.asarray(d), jnp.asarray(g), n_passes=3, interpret=True))
    out = color_smooth_diffs(_t(d), _t(g), n_passes=3).numpy()
    np.testing.assert_array_equal(out, ref)


def test_color_smooth_wrapper_checks():
    with pytest.raises(RuntimeError):
        color_smooth_diffs(torch.zeros(3, 8, 8), torch.zeros(8, 8), n_passes=3)
    with pytest.raises(RuntimeError):
        color_smooth_diffs(torch.zeros(2, 8, 8), torch.zeros(8, 9), n_passes=3)
    with pytest.raises(ValueError):
        color_smooth_diffs(torch.zeros(2, 8, 8), torch.zeros(8, 8), n_passes=0)


# ---- rcd_interior ----

@pytest.mark.parametrize('pattern', ['RGGB', 'BGGR', 'GRBG', 'GBRG'])
def test_rcd_interior_plain_matches_full_path(rng, pattern):
    """The kernel's plain version equals the full-frame RCD >= RING px from
    every edge, for every CFA pattern: atol 1e-6."""
    h, w = 48, 64
    x = rng.random((h, w)).astype(np.float32)
    rp, bp = site_parities(TPattern[pattern])
    out = rcd_interior(_t(x), r_par=rp, b_par=bp).permute(1, 2, 0).numpy()
    ref = trcd._rcd_full(_t(x), TPattern[pattern], False).numpy()
    r = RING
    assert np.abs(out[r:-r, r:-r] - ref[r:-r, r:-r]).max() <= 1e-6


def test_rcd_kernel_path_vs_pallas_interpret(rng):
    """The kernel-path assembly (plain interior + ring + strips with the
    injected stale planes) against rcd_demosaic(use_pallas=True) run in
    interpret mode: atol 1e-6."""
    h, w = 96, 128
    x = rng.random((h, w)).astype(np.float32)
    ref = np.asarray(jrcd.rcd_demosaic(jnp.asarray(x), JPattern.GRBG, use_pallas=True))
    out = trcd._rcd_kernel_path(_t(x), TPattern.GRBG, True).numpy()
    assert np.abs(out - ref).max() <= 1e-6


def test_rcd_kernel_path_equals_full_path(rng):
    """On the port itself the two RCD paths agree: ring exact, interior 1e-6."""
    h, w = 100, 112
    x = rng.random((h, w)).astype(np.float32)
    a = trcd._rcd_kernel_path(_t(x), TPattern.BGGR, True).numpy()
    b = trcd._rcd_full(_t(x), TPattern.BGGR, True).numpy()
    ring = np.ones((h, w), bool)
    ring[RING:-RING, RING:-RING] = False
    d = np.abs(a - b).max(axis=-1)
    assert d[ring].max() == 0.0
    assert d.max() <= 1e-6


# ---- bilateral_band ----

@pytest.mark.parametrize('h,w,s,sr', [(96, 128, 2, 0.2), (64, 128, 8, 0.2), (48, 96, 1, 0.1)])
def test_bilateral_vs_xla_chain(rng, h, w, s, sr):
    """bilateral_process (plain band version) against the JAX XLA chain:
    atol 1e-6 (same op order; observed 0)."""
    lum = (rng.random((h, w)) * 0.95).astype(np.float32)
    ref = np.asarray(jbil.bilateral_process(jnp.asarray(lum), float(s), sr, 0.4,
                                            _use_pallas_blur=False, _use_band_kernel=False))
    out = tbil.bilateral_process(_t(lum), float(s), sr, 0.4).numpy()
    assert np.abs(out - ref).max() <= 1e-6


def test_bilateral_plain_vs_band_kernel_interpret(rng):
    """l_diff of the plain version against the JAX band kernel (interpret
    mode, riffled to (H, W)): atol 1e-6."""
    h, w, s, sr = 64, 96, 2, 0.2
    lum = (rng.random((h, w)) * 0.9).astype(np.float32)
    _, _, gz = jbil.compute_grid_size(w, h, float(s), sr)
    ref = np.asarray(riffle_phases(j_band(jnp.asarray(lum), s=s, gz=gz, sigma_r=sr, bg=16,
                                          interpret=True), w))
    out = bilateral_band(_t(lum), s=s, gz=gz, sigma_r=sr).numpy()
    assert np.abs(out - ref).max() <= 1e-6


def test_bilateral_general_path_not_ported(rng):
    """The general path (sigma_s 3.7 over a 64-px width), which raised
    before the grid blur was ported, now runs and agrees with the JAX
    package: atol 1e-5."""
    lum = rng.random((48, 64)).astype(np.float32)
    ref = np.asarray(jbil.bilateral_process(jnp.asarray(lum), 3.7, 0.13, 0.4))
    out = tbil.bilateral_process(_t(lum), 3.7, 0.13, 0.4).numpy()
    assert np.abs(out - ref).max() <= 1e-5


def test_cpu_runs_plain_versions_and_counts_nothing(rng):
    """On CPU tensors the wrappers run the plain versions; the launch counts
    move only where a CUDA kernel launches."""
    kernels.reset_launches()
    x = torch.from_numpy(rng.random((32, 32)).astype(np.float32))
    rcd_interior(x, r_par=(0, 0), b_par=(1, 1))
    color_smooth_diffs(torch.stack([x, x]), x, n_passes=2)
    bilateral_band(x, s=2, gz=6, sigma_r=0.2)
    grid_blur_xyz(torch.stack([x] * 6))
    wavelet_core(x[None], torch.tensor([0.1]), levels=4)
    nlm_core(x[None], 10.0)
    wf = np.full(16, 0.25, np.float32)
    wiener_tile_core(torch.stack([x, x]), torch.tensor([0.01]), wf, wf, k=16)
    bilateral_fused(x, s=2, gz=6, sigma_r=0.2)
    jpeg_entropy([torch.zeros((4, 64), dtype=torch.int16)], 2, 2, 16)
    lab, lum = lab_split(torch.stack([x] * 3, -1), clipped_l=True)
    lab_merge(lab, lum)
    # and through the stage functions the pipeline calls
    tbil.bilateral_process(x, 2.0, 0.2, 0.4)
    twiener.wiener_denoise(torch.from_numpy(rng.random((96, 128)).astype(np.float32)), 0.05, 16, 4,
                           use_separable=False)
    assert kernels.launches == {'rcd_interior': 0, 'color_smooth_diffs': 0, 'bilateral_band': 0,
                                'grid_blur_xyz': 0, 'wavelet_core': 0, 'nlm_core': 0,
                                'wiener_tile_core': 0, 'bilateral_fused': 0, 'jpeg_entropy': 0,
                                'lab_split': 0, 'lab_merge': 0}


@pytest.mark.cuda
def test_kernels_on_card_match_plain(rng):
    """On the card: each CUDA kernel against its plain version (RCD interior
    in the four patterns and color smoothing bit-exact, bilateral 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; chip_smoke.py runs these on the card')
    dev = torch.device('cuda')
    h, w = 256, 320
    x = torch.from_numpy(rng.random((h, w)).astype(np.float32)).to(dev)
    r = RING
    for pattern in TPattern:
        rp, bp = site_parities(pattern)
        k = rcd_interior(x, r_par=rp, b_par=bp)
        p = rcd_interior_plain(x, r_par=rp, b_par=bp)
        assert torch.equal(k[:, r:-r, r:-r], p[:, r:-r, r:-r]), pattern
    d = torch.stack([x - 0.5, 0.5 - x])
    assert torch.equal(color_smooth_diffs(d, x, n_passes=3),
                       color_smooth_diffs_plain(d, x, n_passes=3))
    assert (bilateral_band(x, s=2, gz=6, sigma_r=0.2)
            - bilateral_band_plain(x, s=2, gz=6, sigma_r=0.2)).abs().max().item() <= 1e-5
