"""The port's denoise family and general bilateral grid against the JAX
package, on the CPU: NLM and wavelet shrinkage (kernels/nlm.py,
kernels/wavelet.py), the grid blur (kernels/grid_blur.py), the general
bilateral path and bilateral_denoise, the noise estimate, the public
Wiener and Bilateral classes, and ImageProcessor on the general bilateral
path.  The JAX Pallas kernels run in interpret mode, as the JAX package's
own tests run them; the port's wrappers run their plain versions on CPU
tensors.  Tolerances are stated per test.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tpu_darktable as td
from tpu_darktable import denoise as jdenoise
from tpu_darktable import local_contrast as jlc
from tpu_darktable.kernels.grid_blur import grid_blur_xyz as j_grid_blur
from tpu_darktable.ops import bilateral as jbil
from tpu_darktable.ops import color as jcolor
from tpu_darktable.ops import nlm as jnlm
from tpu_darktable.ops import packed as jpacked
from tpu_darktable.ops import wiener as jwiener
from tpu_darktable.pipeline.config import (
    Debayer as JDebayer,
    ImageProcessingSettings as JSettings,
    ToneMapper as JTone,
)
from tpu_darktable.pipeline.image_processor import build_pipeline_fn

import tpu_darktable_torch as tt
from tpu_darktable_torch import kernels
from tpu_darktable_torch.kernels.grid_blur import grid_blur_xyz
from tpu_darktable_torch.kernels.nlm import nlm_core
from tpu_darktable_torch.kernels.wavelet import wavelet_core
from tpu_darktable_torch.ops import bilateral as tbil
from tpu_darktable_torch.ops import color as tcolor
from tpu_darktable_torch.ops import nlm as tnlm
from tpu_darktable_torch.ops import wiener as twiener
from tpu_darktable_torch.pipeline.config import ImageProcessingSettings as TSettings

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _max_err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


# ---- NLM ----

@pytest.mark.parametrize('shape,sr,pr', [((40, 48, 3), 3, 1), ((40, 48, 3), 2, 2),
                                         ((40, 48, 3), 1, 1), ((64, 96), 3, 1),
                                         ((64, 96), 2, 2), ((64, 96), 1, 1)])
def test_nlm_vs_jax(rng, shape, sr, pr):
    """nlm_denoise (plain version) against the JAX Pallas kernel in
    interpret mode and the JAX offset loop: atol 2e-6 (the bar of
    tests/test_nlm_kernel.py; the kernel's box sum associates differently)."""
    x = rng.random(shape).astype(np.float32)
    out = tnlm.nlm_denoise(_t(x), 0.1, search_radius=sr, patch_radius=pr).numpy()
    ref_kernel = jnlm.nlm_denoise(jnp.asarray(x), 0.1, search_radius=sr, patch_radius=pr,
                                  use_pallas=True, _pallas_interpret=True)
    ref_xla = jnlm.nlm_denoise(jnp.asarray(x), 0.1, search_radius=sr, patch_radius=pr,
                               use_pallas=False)
    assert out.shape == x.shape
    assert _max_err(out, ref_kernel) <= 2e-6
    assert _max_err(out, ref_xla) <= 2e-6


# ---- wavelet ----

@pytest.mark.parametrize('shape', [(70, 96, 3), (33, 40, 2), (96, 128)])
@pytest.mark.parametrize('levels', [3, 4])
def test_wavelet_vs_jax(rng, shape, levels):
    """wavelet_denoise (plain version) against the JAX Pallas kernel in
    interpret mode and the per-level XLA path: atol 2e-6."""
    x = rng.random(shape).astype(np.float32)
    out = tnlm.wavelet_denoise(_t(x), 0.05, levels=levels).numpy()
    ref_kernel = jnlm.wavelet_denoise(jnp.asarray(x), 0.05, levels=levels, use_pallas=True,
                                      _pallas_interpret=True)
    ref_xla = jnlm.wavelet_denoise(jnp.asarray(x), 0.05, levels=levels, use_pallas=False)
    assert out.shape == x.shape
    assert _max_err(out, ref_kernel) <= 2e-6
    assert _max_err(out, ref_xla) <= 2e-6


@pytest.mark.parametrize('shape', [(70, 96, 3), (96, 128)])
def test_wavelet_deep_levels_vs_xla(rng, shape):
    """levels=5 (beyond the JAX kernel's band; the port's kernel takes it)
    against the per-level XLA path, with per-channel sigmas: atol 2e-6."""
    x = rng.random(shape).astype(np.float32)
    sigma = np.array([0.05, 0.04, 0.06], np.float32)[: (shape[2] if len(shape) == 3 else 1)]
    out = tnlm.wavelet_denoise(_t(x), _t(sigma), levels=5).numpy()
    ref = jnlm.wavelet_denoise(jnp.asarray(x), jnp.asarray(sigma), levels=5, use_pallas=False)
    assert _max_err(out, ref) <= 2e-6


# ---- grid blur ----

@pytest.mark.parametrize('z_mode', ['derivative', 'gaussian'])
@pytest.mark.parametrize('shape', [(6, 70, 45), (11, 37, 130)])
def test_grid_blur_vs_pallas_interpret(rng, shape, z_mode):
    """grid_blur_xyz (plain version) against the JAX Pallas kernel in
    interpret mode, gy not a multiple of the kernel's 64-row band: atol 1e-6."""
    grid = (rng.random(shape) - 0.3).astype(np.float32)
    ref = j_grid_blur(jnp.asarray(grid), bh=64, z_mode=z_mode, interpret=True)
    out = grid_blur_xyz(_t(grid), z_mode=z_mode).numpy()
    assert _max_err(out, ref) <= 1e-6


def test_grid_blur_wrapper_checks():
    with pytest.raises(RuntimeError):
        grid_blur_xyz(torch.zeros(6, 8))
    with pytest.raises(RuntimeError):
        grid_blur_xyz(torch.zeros(6, 8, 9).transpose(1, 2))
    with pytest.raises(ValueError):
        grid_blur_xyz(torch.zeros(6, 8, 8), z_mode='box')


# ---- bilateral, general path ----

@pytest.mark.parametrize('shape,sigma_s,sigma_r', [((60, 85), 3.0, 0.2), ((60, 85), 2.5, 0.2),
                                                   ((24, 1600), 0.5, 0.25)])
def test_bilateral_general_vs_jax(rng, shape, sigma_s, sigma_r):
    """The general path (sigma_s that does not divide the frame, a
    fractional sigma_s, and sigma_s=0.5 whose x grid is clamped to 3001
    cells with a tail) against the JAX package: atol 1e-5."""
    h, w = shape
    lum = (rng.random(shape) * 0.95).astype(np.float32)
    if sigma_s == 0.5:
        gx, gy, _ = jbil.compute_grid_size(w, h, sigma_s, sigma_r)
        assert gx == 3001 and jbil._axis_splat_operator(w, gx, sigma_s)[2] < w
    ref = jbil.bilateral_process(jnp.asarray(lum), sigma_s, sigma_r, 0.4)
    out = tbil.bilateral_process(_t(lum), sigma_s, sigma_r, 0.4).numpy()
    assert _max_err(out, ref) <= 1e-5


@pytest.mark.parametrize('shape,sigma_s', [((60, 85), 3.0), ((8, 1600), 0.5)])
def test_bilateral_denoise_vs_jax(rng, shape, sigma_s):
    """bilateral_denoise (gaussian z blur of two grids) against the JAX
    package: atol 1e-5."""
    noisy = (0.5 + rng.normal(0, 0.03, shape)).astype(np.float32)
    ref = jbil.bilateral_denoise(jnp.asarray(noisy), sigma_s, 0.25, 0.8)
    out = tbil.bilateral_denoise(_t(noisy), sigma_s, 0.25, 0.8).numpy()
    assert _max_err(out, ref) <= 1e-5


def test_splat_operators_equal_jax():
    """The numpy splat and slice operators are exact copies."""
    for args in [(700, 101, 0.5), (85, 30, 3.0), (60, 26, 2.5)]:
        for a, b in zip(tbil._axis_splat_operator(*args), jbil._axis_splat_operator(*args)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tbil._axis_slice_weights(*args), jbil._axis_slice_weights(*args)):
            np.testing.assert_array_equal(a, b)


# ---- noise estimate and colour helpers ----

@pytest.mark.parametrize('shape', [(40, 48, 3), (40, 40, 3)])
def test_estimate_channel_noise_vs_jax(rng, shape):
    """An even (30) and an odd (25) sample count at stride 8: the even
    median averages the two middle values as jnp.median does (torch.median
    would take the lower one).  To rounding: rtol 1e-6."""
    x = (0.5 + rng.normal(0, 0.05, shape)).astype(np.float32)
    ref = np.asarray(jwiener.estimate_channel_noise(jnp.asarray(x)))
    out = twiener.estimate_channel_noise(_t(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6)


def test_luminance_helpers_vs_jax(rng):
    """compute_(log_)luminance and modify_(log_)luminance: atol 2e-6."""
    rgb = (rng.random((12, 16, 3)) * 1.2 - 0.1).astype(np.float32)
    new_l = rng.random((12, 16)).astype(np.float32)
    pairs = [
        (tcolor.compute_luminance(_t(rgb)), jcolor.compute_luminance(rgb)),
        (tcolor.compute_log_luminance(_t(rgb)), jcolor.compute_log_luminance(rgb)),
        (tcolor.modify_luminance(_t(rgb), _t(new_l)), jcolor.modify_luminance(rgb, new_l)),
        (tcolor.modify_log_luminance(_t(rgb), _t(new_l - 1.0)),
         jcolor.modify_log_luminance(rgb, new_l - 1.0)),
    ]
    for out, ref in pairs:
        assert _max_err(out.numpy(), ref) <= 2e-6
    with pytest.raises(RuntimeError):
        tcolor.modify_luminance(_t(rgb), _t(new_l[:4]))


# ---- public classes ----

def test_wiener_class_vs_jax(rng):
    """Wiener.process / process_luminance / process_log_luminance /
    process_log against the JAX class: atol 2e-5 (the Wiener bar of
    tests/test_torch_ops.py plus the LAB round trip)."""
    rgb = (0.2 + 0.6 * rng.random((48, 64, 3))).astype(np.float32)
    jw = jdenoise.Wiener(None, (64, 48))
    tw = tt.Wiener('cpu', (64, 48))
    for name, noise in [('process', 0.05), ('process_luminance', 0.05),
                        ('process_log_luminance', 0.075), ('process_log', [0.05, 0.04, 0.06])]:
        ref = getattr(jw, name)(jnp.asarray(rgb), noise if isinstance(noise, float)
                                else jnp.asarray(noise))
        out = getattr(tw, name)(_t(rgb), noise if isinstance(noise, float)
                                else _t(np.asarray(noise, np.float32)))
        assert _max_err(out.numpy(), ref) <= 2e-5, name
    assert tw.overlap_factor == 4
    assert repr(tw) == repr(jw)


BAD_WIENER = [
    (lambda m, dev: m.Wiener(dev, (64, 48), overlap_factor=3), ValueError),
    (lambda m, dev: m.Wiener(dev, (64, 48), tile_size=8), ValueError),
    (lambda m, dev: m.Wiener(dev, (0, 48)), ValueError),
    (lambda m, dev: m.Wiener(dev), TypeError),
    (lambda m, dev: m.check_overlap_factor(5), ValueError),
]


@pytest.mark.parametrize('case', range(len(BAD_WIENER)))
def test_wiener_class_argument_errors(case):
    """The same bad arguments raise the same errors in both packages."""
    make, err = BAD_WIENER[case]
    with pytest.raises(err):
        make(jdenoise, None)
    with pytest.raises(err):
        make(tt.denoise, 'cpu')


def test_wiener_class_input_errors():
    """Shape, channel and noise checks, as the JAX class makes them."""
    for mod, arr, dev in [(jdenoise, jnp.zeros, None), (tt.denoise, torch.zeros, 'cpu')]:
        w = mod.Wiener(dev, (16, 12))
        with pytest.raises(ValueError):
            w.process(arr((12, 16)), 0.1)
        with pytest.raises(RuntimeError):
            w.process(arr((12, 17, 3)), 0.1)
        with pytest.raises(ValueError):
            w.process(arr((12, 16, 2)), 0.1)
        with pytest.raises(ValueError):
            w.process(arr((12, 16, 3)), arr((2,)))
    assert isinstance(tt.denoise.create_wiener('cpu', (16, 12), overlap=8), tt.Wiener)


def test_bilateral_class_vs_jax(rng):
    """Bilateral.process / process_rgb / process_log_rgb on the general path
    (sigma_s=3 over an 85-px width) against the JAX class: atol 2e-5."""
    rgb = (0.1 + 0.8 * rng.random((60, 85, 3))).astype(np.float32)
    jb = jlc.Bilateral(None, (85, 60), sigma_s=3.0, sigma_r=0.2)
    tb = tt.Bilateral('cpu', (85, 60), sigma_s=3.0, sigma_r=0.2)
    lum = rgb[..., 0]
    assert _max_err(tb.process(_t(lum), 0.4).numpy(), jb.process(jnp.asarray(lum), 0.4)) <= 2e-5
    for name in ('process_rgb', 'process_log_rgb'):
        ref = getattr(jb, name)(jnp.asarray(rgb), 0.4)
        out = getattr(tb, name)(_t(rgb), 0.4)
        assert _max_err(out.numpy(), ref) <= 2e-5, name
    assert tb.image_size == jb.image_size == (85, 60)
    assert (tb.sigma_s, tb.sigma_r) == (jb.sigma_s, jb.sigma_r)
    with pytest.raises(RuntimeError):
        tb.process(torch.zeros(61, 85), 0.4)
    with pytest.raises(RuntimeError):
        jb.process(jnp.zeros((61, 85)), 0.4)
    with pytest.raises(TypeError):
        tt.Bilateral('cpu', sigma_s=2.0, sigma_r=0.2)


def test_public_surface():
    for name in ('Wiener', 'Bilateral', 'estimate_channel_noise', 'denoise', 'local_contrast'):
        assert hasattr(tt, name), name
    for name in ('nlm_denoise', 'wavelet_denoise', 'create_wiener', 'check_overlap_factor'):
        assert callable(getattr(tt.denoise, name)), name


# ---- the pipeline on the general bilateral path ----

def _frames(w, h, n, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        m = np.clip(0.4 + 0.3 * np.sin(xx / (9.0 + i)) * np.cos(yy / 7.0)
                    + rng.normal(0, 0.04, (h, w)), 0, 1).astype(np.float32)
        out.append(np.asarray(jpacked.encode12_float(jnp.asarray(m.reshape(-1)))))
    return np.stack(out)


def test_pipeline_general_bilateral_vs_jax():
    """FULL settings with bil_sigma_spatial=3.0 at 128x96 (128 % 3 != 0, so
    the general bilateral path), two frames: ImageProcessor within 1 uint8
    count of the JAX build_pipeline_fn."""
    w, h = 128, 96
    full = dict(debayer=JDebayer.rcd, postprocess=True, enable_denoise=True,
                enable_bilateral=True, tone_mapping=JTone.adaptive_aces, tone_gamma=1.5,
                tone_intensity=2.0, light_adapt=0.8, vibrance=0.5, bil_sigma_spatial=3.0)
    wb = (1.2, 1.0, 1.1)
    frames = _frames(w, h, 2, seed=7)
    fn = jax.jit(build_pipeline_fn(JSettings(**full), (w, h), td.BayerPattern.RGGB,
                                   td.PackedFormat.Packed12, True))
    ref, _, _ = fn(jnp.asarray(frames), jnp.asarray(wb, jnp.float32), jnp.zeros(2, jnp.float32),
                   jnp.zeros(5, jnp.float32), jnp.float32(1.0))
    tfull = {k: v for k, v in full.items() if k not in ('debayer', 'tone_mapping')}
    settings = dataclasses.replace(TSettings(**tfull), debayer=tt.Debayer.rcd,
                                   tone_mapping=tt.ToneMapper.adaptive_aces)
    proc = tt.ImageProcessor((w, h), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12, settings,
                             device='cpu', white_balance=wb)
    out = proc.process_batch(frames).numpy()
    assert np.abs(out.astype(int) - np.asarray(ref).astype(int)).max() <= 1


# ---- launches and the card ----

def test_cpu_wrappers_count_no_launches(rng):
    kernels.reset_launches()
    x = _t(rng.random((2, 20, 24)).astype(np.float32))
    nlm_core(x, 10.0)
    wavelet_core(x, _t(np.full(2, 0.1, np.float32)), levels=5)
    grid_blur_xyz(x)
    assert all(n == 0 for n in kernels.launches.values())

