"""The port's piecewise entry point and what it needs, against the JAX
package on the CPU: the tonemappers and metrics helpers, bilinear and PPG
demosaic, local green equilibration, the white-balance estimate, the Bayer
and packed helpers, the workspace classes, the presets, and
ImageProcessor.load_bytes -> debayer -> process_rgb -> tonemap against the
fused path and against JAX's piecewise path.  uint8 outputs: 1 count; float
stencils: bit for bit; reductions: the tolerance in the test.
"""

import dataclasses
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tpu_darktable as td
from tpu_darktable import debayer as jdebayer
from tpu_darktable.ops import bayer as jbayer
from tpu_darktable.ops import color as jcolor
from tpu_darktable.ops import demosaic as jdem
from tpu_darktable.ops import packed as jpacked
from tpu_darktable.ops import postprocess as jpost
from tpu_darktable.ops import tonemap as jtone
from tpu_darktable.ops import white_balance as jwb
from tpu_darktable.pipeline import ImageProcessor as JProcessor
from tpu_darktable.pipeline.config import (
    Debayer as JDebayer,
    ImageProcessingSettings as JSettings,
    ToneMapper as JTone,
)

import tpu_darktable_torch as tt
from tpu_darktable_torch import debayer as tdebayer
from tpu_darktable_torch.convert import processor_state_from_numpy, settings_from_dict
from tpu_darktable_torch.ops import bayer as tbayer
from tpu_darktable_torch.ops import color as tcolor
from tpu_darktable_torch.ops import demosaic as tdem
from tpu_darktable_torch.ops import packed as tpacked
from tpu_darktable_torch.ops import postprocess as tpost
from tpu_darktable_torch.ops import tonemap as ttone
from tpu_darktable_torch.ops import white_balance as twb

# `pipeline.presets` is the dict of presets in both packages; the modules:
jpresets_mod = importlib.import_module('tpu_darktable.pipeline.presets')
tpresets_mod = importlib.import_module('tpu_darktable_torch.pipeline.presets')

torch.set_num_threads(1)
PATTERNS = ['RGGB', 'BGGR', 'GRBG', 'GBRG']
WB = (1.2, 1.0, 1.1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _counts(a, b):
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max())


# ---- tonemap ----

_PARAMS = dict(gamma=1.5, intensity=2.0, light_adapt=0.8, vibrance=0.5)


@pytest.mark.parametrize('name', ['linear', 'filmic', 'filmic_plain', 'adaptive_aces', 'aces',
                                  'reinhard'])
def test_tonemappers_vs_jax(rng, name):
    """Every tonemapper on an image with negative and > 1 pixels: 1 count."""
    rgb = (rng.random((40, 56, 3)) * 1.3 - 0.1).astype(np.float32)
    jm = jtone.compute_image_metrics([jnp.asarray(rgb)], stride=4)
    tm = ttone.compute_image_metrics([_t(rgb)], stride=4)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6)
    jp, tp = jtone.TonemapParameters(**_PARAMS), ttone.TonemapParameters(**_PARAMS)
    calls = {
        'linear': lambda m, x, mt, p: m.linear_tonemap(x, mt, p),
        'filmic': lambda m, x, mt, p: m.filmic_tonemap(x, p, mt),
        'filmic_plain': lambda m, x, mt, p: m.filmic_tonemap(x, p),
        'adaptive_aces': lambda m, x, mt, p: m.adaptive_aces_tonemap(x, mt, p),
        'aces': lambda m, x, mt, p: m.aces_tonemap(x, p),
        'reinhard': lambda m, x, mt, p: m.reinhard_tonemap(x, mt, p),
    }
    ref = np.asarray(calls[name](jtone, jnp.asarray(rgb), jm, jp))
    out = calls[name](ttone, _t(rgb), tm, tp)
    assert out.dtype == torch.uint8 and _counts(out.numpy(), ref) <= 1


def test_rrt_and_odt_fit_vs_jax(rng):
    v = (rng.random((16, 3)) * 4).astype(np.float32)
    np.testing.assert_allclose(ttone._rrt_and_odt_fit(_t(v)).numpy(),
                               np.asarray(jtone._rrt_and_odt_fit(jnp.asarray(v))), rtol=1e-6)


@pytest.mark.parametrize('rescale', [False, True])
def test_image_metrics_rescale_vs_jax(rng, rescale):
    """A list of two frames, strided; rescale=True masks saturation after
    rescaling by the set's bounds.  atol 1e-6 (sum order)."""
    frames = [(rng.random((32, 48, 3)) * 1.4).astype(np.float32) for _ in range(2)]
    ref = jtone.compute_image_metrics([jnp.asarray(f) for f in frames], stride=4, rescale=rescale)
    out = ttone.compute_image_metrics([_t(f) for f in frames], stride=4, rescale=rescale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_array_equal(
        ttone.compute_image_bounds([_t(f) for f in frames], stride=4).numpy(),
        np.asarray(jtone.compute_image_bounds([jnp.asarray(f) for f in frames], stride=4)))


def test_metrics_dict_helpers_vs_jax(capsys):
    m = np.array([-1.25, 0.31, 0.2, 0.3, 0.4], np.float32)
    jd, tdict = jtone.metrics_to_dict(jnp.asarray(m)), ttone.metrics_to_dict(_t(m))
    assert jd == tdict
    np.testing.assert_array_equal(ttone.metrics_from_dict(tdict).numpy(),
                                  np.asarray(jtone.metrics_from_dict(jd)))
    jtone.print_metrics(jnp.asarray(m))
    ref = capsys.readouterr().out
    ttone.print_metrics(_t(m))
    assert capsys.readouterr().out == ref
    with pytest.raises(AssertionError):
        ttone.metrics_to_dict(torch.zeros(4))


# ---- demosaic, postprocess, white balance ----

@pytest.mark.parametrize('pattern', PATTERNS)
def test_bilinear_vs_jax(rng, pattern):
    """Bit for bit, with the reference's BGGR / GBRG pixel-type order, at an
    odd size; (H, W, 1) input."""
    x = rng.random((37, 50, 1)).astype(np.float32)
    ref = np.asarray(jdem.bilinear5x5_demosaic(jnp.asarray(x), jbayer.BayerPattern[pattern]))
    out = tdem.bilinear5x5_demosaic(_t(x), tbayer.BayerPattern[pattern]).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize('pattern', PATTERNS)
@pytest.mark.parametrize('threshold', [0.0, 4.0])
def test_ppg_demosaic_vs_jax(rng, pattern, threshold):
    """Whole PPG with and without the pre-median, strip-assembled border
    (48 x 64) and the small-frame branch (14 x 18): bit for bit."""
    for shape in [(48, 64), (14, 18)]:
        x = rng.random(shape).astype(np.float32)
        ref = np.asarray(jdem.ppg_demosaic(jnp.asarray(x), jbayer.BayerPattern[pattern],
                                           threshold))
        out = tdem.ppg_demosaic(_t(x), tbayer.BayerPattern[pattern], threshold).numpy()
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize('pattern', PATTERNS)
def test_pre_median_vs_jax(rng, pattern):
    x = (rng.random((30, 44)) - 0.05).astype(np.float32)
    ref = np.asarray(jdem.pre_median(jnp.asarray(x), jbayer.BayerPattern[pattern], 0.04))
    out = tdem.pre_median(_t(x), tbayer.BayerPattern[pattern], 0.04).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out != np.maximum(x, 0)).any()


@pytest.mark.parametrize('pattern', PATTERNS)
def test_green_eq_local_vs_jax(rng, pattern):
    """Bit for bit, on a flat-ish image so that the correction applies."""
    rgb = (rng.random((40, 52, 3)) * 0.2 + 0.4).astype(np.float32)
    ref = np.asarray(jpost.green_eq_local(jnp.asarray(rgb), jbayer.BayerPattern[pattern], 0.04))
    out = tpost.green_eq_local(_t(rgb), tbayer.BayerPattern[pattern], 0.04).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out != rgb).any()


def test_postprocess_local_switch_vs_jax(rng):
    """postprocess with both green equilibrations and one smoothing pass:
    the JAX signature, 2e-7 (the global ratio is a reduction)."""
    rgb = (rng.random((40, 52, 3)) * 0.2 + 0.4).astype(np.float32)
    kw = dict(color_smoothing_passes=1, green_eq_local_enabled=True,
              green_eq_global_enabled=True, green_eq_threshold=4.0)
    ref = np.asarray(jpost.postprocess(jnp.asarray(rgb), jbayer.BayerPattern.GRBG, **kw))
    out = tpost.postprocess(_t(rgb), tbayer.BayerPattern.GRBG, **kw).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-7)
    off = tpost.postprocess(_t(rgb), tbayer.BayerPattern.GRBG,
                            **{**kw, 'green_eq_local_enabled': False}).numpy()
    assert (off != out).any()


@pytest.mark.parametrize('pattern', PATTERNS)
def test_estimate_white_balance_vs_jax(rng, pattern):
    """A batch with saturated cells; returns the chroma ratios (r/g, 1,
    b/g) as the reference does.  rtol 1e-6: the two means are reductions
    summed in another order; the sort and the threshold are exact."""
    x = (rng.random((2, 64, 96)) * 1.05).astype(np.float32)
    ref = np.asarray(jwb.estimate_white_balance(jnp.asarray(x), jbayer.BayerPattern[pattern]))
    out = twb.estimate_white_balance(_t(x), tbayer.BayerPattern[pattern]).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    assert out[1] == 1.0
    as_list = twb.estimate_white_balance([_t(x[0]), _t(x[1])], tbayer.BayerPattern[pattern])
    np.testing.assert_array_equal(as_list.numpy(), out)


def test_estimate_white_balance_degenerate():
    """A frame too small for the sample grid, and a fully saturated one:
    unit gains, as in JAX."""
    tiny = torch.rand(8, 8)
    np.testing.assert_array_equal(
        twb.estimate_white_balance(tiny, tbayer.BayerPattern.RGGB).numpy(), np.ones(3))
    sat = np.ones((32, 32), np.float32)
    ref = np.asarray(jwb.estimate_white_balance(jnp.asarray(sat), jbayer.BayerPattern.RGGB))
    out = twb.estimate_white_balance(_t(sat), tbayer.BayerPattern.RGGB).numpy()
    np.testing.assert_array_equal(out, ref)


# ---- bayer, packed, colour helpers ----

@pytest.mark.parametrize('pattern', PATTERNS)
def test_bayer_helpers_vs_jax(rng, pattern):
    jp, tp = jbayer.BayerPattern[pattern], tbayer.BayerPattern[pattern]
    np.testing.assert_array_equal(tbayer.fc_map(7, 9, tp), jbayer.fc_map(7, 9, jp))
    for a, b in zip(tbayer.channel_masks(6, 8, tp), jbayer.channel_masks(6, 8, jp)):
        np.testing.assert_array_equal(a, b)
    assert tbayer.pixel_order(tp) == jbayer.pixel_order(jp)
    assert tbayer.channels(tp) == jbayer.channels(jp)
    rgb = rng.random((12, 16, 3)).astype(np.float32)
    mosaic = tbayer.rgb_to_bayer(_t(rgb), tp)
    np.testing.assert_array_equal(mosaic.numpy(), np.asarray(jbayer.rgb_to_bayer(jnp.asarray(rgb), jp)))
    planes = tbayer.stack_bayer(mosaic[..., 0])
    np.testing.assert_array_equal(planes.numpy(),
                                  np.asarray(jbayer.stack_bayer(jnp.asarray(mosaic[..., 0].numpy()))))
    np.testing.assert_array_equal(tbayer.expand_bayer(planes).numpy(), mosaic.numpy())


@pytest.mark.parametrize('ids', [False, True])
def test_decode12_dispatch_vs_jax(rng, ids):
    fmt_t = tbayer.PackedFormat.Packed12_IDS if ids else tbayer.PackedFormat.Packed12
    fmt_j = jbayer.PackedFormat.Packed12_IDS if ids else jbayer.PackedFormat.Packed12
    data = rng.integers(0, 256, 96, dtype=np.uint8)
    for t_dt, j_dt in ((torch.float32, jnp.float32), (torch.float16, jnp.float16),
                       (torch.uint16, jnp.uint16)):
        ref = np.asarray(jpacked.decode12(jnp.asarray(data), j_dt, fmt_j))
        out = tpacked.decode12(_t(data), t_dt, fmt_t)
        assert out.dtype == t_dt
        np.testing.assert_array_equal(out.numpy(), ref)
    with pytest.raises(ValueError):
        tpacked.decode12(_t(data), torch.int64)


def test_xyz_conversions_vs_jax(rng):
    rgb = rng.random((9, 11, 3)).astype(np.float32)
    xyz = tcolor.rgb_to_xyz(_t(rgb))
    np.testing.assert_allclose(xyz.numpy(), np.asarray(jcolor.rgb_to_xyz(jnp.asarray(rgb))),
                               atol=1e-6)
    np.testing.assert_allclose(tcolor.xyz_to_rgb(xyz).numpy(),
                               np.asarray(jcolor.xyz_to_rgb(jnp.asarray(xyz.numpy()))), atol=1e-6)
    np.testing.assert_allclose(tcolor.xyz_to_linear_rgb(xyz).numpy(),
                               np.asarray(jcolor.xyz_to_linear_rgb(jnp.asarray(xyz.numpy()))),
                               atol=1e-6)


# ---- workspace classes ----

@pytest.mark.parametrize('cls', ['PPG', 'RCD', 'PostProcess', 'Bilinear5x5'])
def test_workspace_classes_vs_jax(rng, cls):
    """process() against the JAX class (jitted there: PPG bit for bit, the
    others 1e-6 for XLA's fused rounding), the same shape check and
    message, and both constructor call patterns."""
    w, h = 64, 48
    pat_t, pat_j = tbayer.BayerPattern.GRBG, jbayer.BayerPattern.GRBG
    if cls == 'Bilinear5x5':
        x = rng.random((h, w, 1)).astype(np.float32)
        out = tdebayer.Bilinear5x5(pat_t).process(_t(x)).numpy()
        # the JAX class jits the op, and XLA's fused arithmetic rounds the
        # 13-tap sum differently from the eager op the function test holds
        np.testing.assert_allclose(out, np.asarray(jdebayer.Bilinear5x5(pat_j).process(x)),
                                   atol=3e-7)
        np.testing.assert_array_equal(tdebayer.bilinear5x5_demosaic(_t(x), pat_t).numpy(), out)
        # an array that is no tensor goes to the card, never silently to the CPU
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match='is_available'):
                tdebayer.Bilinear5x5(pat_t).process(x)
        return
    kw = {'PPG': dict(median_threshold=4.0), 'RCD': {},
          'PostProcess': dict(color_smoothing_passes=2, green_eq_local=True,
                              green_eq_global=True, green_eq_threshold=4.0)}[cls]
    t_ws = getattr(tdebayer, cls)('cpu', (w, h), pat_t, **kw)
    j_ws = getattr(jdebayer, cls)(None, (w, h), pat_j, **kw)
    c = 3 if cls == 'PostProcess' else 1
    x = (rng.random((h, w, c)) * 0.2 + 0.4).astype(np.float32)
    np.testing.assert_allclose(t_ws.process(_t(x)).numpy(), np.asarray(j_ws.process(jnp.asarray(x))),
                               atol=0 if cls == 'PPG' else 1e-6)
    assert t_ws.image_size == j_ws.image_size == (w, h)
    bad = np.zeros((h, w + 2, c), np.float32)
    with pytest.raises(RuntimeError) as t_err:
        t_ws.process(_t(bad))
    with pytest.raises(RuntimeError) as j_err:
        j_ws.process(jnp.asarray(bad))
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(TypeError, match='image_size is required'):
        getattr(tdebayer, cls)('cpu')
    if cls == 'PPG':
        assert t_ws.median_threshold == j_ws.median_threshold == 4.0
    if cls == 'PostProcess':
        assert t_ws.color_smoothing_passes == 2 and t_ws.green_eq_threshold == 4.0


def test_norm_workspace_args():
    assert tdebayer._norm_workspace_args((64, 48), None) == (None, (64, 48))
    assert tdebayer._norm_workspace_args('cpu', [64, 48]) == ('cpu', (64, 48))
    assert jdebayer._norm_workspace_args((64, 48), None) == (None, (64, 48))


# ---- presets ----

@pytest.mark.parametrize('name', ['aces', 'adaptive_aces', 'reinhard', 'fast'])
def test_presets_vs_jax(name):
    """Field for field, and carried across by convert.settings_from_dict."""
    jp = jpresets_mod.get_preset(name)
    tp = tpresets_mod.get_preset(name)
    assert tp.to_dict() == jp.model_dump(mode='json')
    assert settings_from_dict(jp.model_dump()) == tp
    assert tt.get_preset(name) is tt.presets[name]


def test_presets_module_surface():
    assert set(tpresets_mod.presets) == set(jpresets_mod.presets)
    for attr in ('aces', 'adaptive_aces', 'reinhard'):
        assert getattr(tpresets_mod, attr) is tpresets_mod.presets[attr]
    with pytest.raises(ValueError) as t_err:
        tpresets_mod.get_preset('nope')
    with pytest.raises(ValueError) as j_err:
        jpresets_mod.get_preset('nope')
    assert str(t_err.value) == str(j_err.value)


# ---- ImageProcessor: the piecewise API ----

def _bytes(h, w, rng, ids=False, padding=0, smooth=False):
    """Packed bytes of a random mosaic, or of a smooth one with mild noise
    (pure noise parks RCD overshoot on the Reinhard pole rgb = -adapt, where
    a last-bit difference flips uint8 values arbitrarily)."""
    if smooth:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        mosaic = np.clip(0.45 + 0.25 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
                         + rng.normal(0, 0.03, (h, w)), 0.0, 0.9).astype(np.float32)
    else:
        mosaic = (rng.random((h, w)) * 0.8).astype(np.float32)
    data = np.asarray(jpacked.encode12_float(jnp.asarray(mosaic.reshape(-1)), ids_format=ids))
    if padding:
        data = np.concatenate([data, np.zeros(padding, np.uint8)])
    return data, mosaic


def _jsettings(**kw):
    base = dict(debayer=JDebayer.rcd, postprocess=True, enable_denoise=True,
                enable_bilateral=True, tone_mapping=JTone.reinhard, tone_intensity=2.5,
                vibrance=0.5)
    base.update(kw)
    return JSettings(**base)


def _procs(js, size=(128, 96), **kw):
    jp = JProcessor(size, td.BayerPattern.RGGB, td.PackedFormat.Packed12, js, white_balance=WB, **kw)
    tp = tt.ImageProcessor(size, tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                           settings_from_dict(js.model_dump()), device='cpu', white_balance=WB,
                           **kw)
    return jp, tp


def _piecewise_t(proc, data):
    rgb = proc.load_image(data)
    rgb = proc.process_rgb(rgb, tt.compute_image_bounds([rgb], stride=8))
    return proc.tonemap(rgb, tt.compute_image_metrics([rgb], stride=8))


def _piecewise_j(proc, data):
    rgb = proc.load_image(jnp.asarray(data))
    rgb = proc.process_rgb(rgb, td.compute_image_bounds([rgb], stride=8))
    return proc.tonemap(rgb, td.compute_image_metrics([rgb], stride=8))


@pytest.mark.parametrize('extra', [{}, dict(enable_denoise=False)],
                         ids=['denoise+bilateral', 'bilateral_only'])
def test_fused_matches_piecewise(rng, extra):
    """In the port: one fused call == load_image -> process_rgb -> tonemap
    with bounds and metrics taken as the fused path takes them (1 count);
    and the port's piecewise == JAX's piecewise (1 count)."""
    js = _jsettings(**extra)
    jp, tp = _procs(js)
    data, _ = _bytes(96, 128, rng)
    fused = tp.process(data, 'x').numpy()
    _, tp2 = _procs(js)
    piecewise = _piecewise_t(tp2, data).numpy()
    assert piecewise.shape == (96, 128, 3) and piecewise.dtype == np.uint8
    assert _counts(fused, piecewise) <= 1
    assert _counts(piecewise, _piecewise_j(jp, data)) <= 1


# the float32 cases keep the ids this test had before it took denoise_f16
@pytest.mark.parametrize('size,f16', [((128, 96), False), ((320, 240), False),
                                      ((128, 96), True), ((320, 240), True)],
                         ids=['size0', 'size1', 'size0-denoise_f16', 'size1-denoise_f16'])
def test_fused_and_piecewise_share_the_tile_core_route(rng, monkeypatch, size, f16):
    """Both entry points take the Wiener route `denoise_f16` names, once a
    frame, and agree within 1 count: off, kernels/wiener_core.py; on, the
    separable einsums with float16 spectral and storage dtypes (no tile
    core)."""
    from tpu_darktable_torch.ops import wiener as twiener

    seen, separable = [], []
    real, real_sep = twiener.wiener_tile_core, twiener._wiener_separable
    monkeypatch.setattr(twiener, 'wiener_tile_core',
                        lambda slabs, *a, **kw: seen.append(tuple(slabs.shape))
                        or real(slabs, *a, **kw))
    monkeypatch.setattr(twiener, '_wiener_separable',
                        lambda *a, **kw: separable.append((kw['spectral_dtype'],
                                                           kw['storage_dtype']))
                        or real_sep(*a, **kw))
    js = _jsettings(denoise_f16=f16)
    w, h = size
    data, _ = _bytes(h, w, rng, smooth=True)
    _, tp = _procs(js, size=size)
    fused = tp.process(data, 'x').numpy()
    _, tp2 = _procs(js, size=size)
    piecewise = _piecewise_t(tp2, data).numpy()
    if f16:
        assert seen == [] and separable == [(torch.float16, torch.float16)] * 2
    else:
        assert separable == []
        assert len(seen) == 2 and seen[0] == seen[1] and seen[0][0] == 16   # C = 1, overlap 4
    assert _counts(fused, piecewise) <= 1


@pytest.mark.parametrize('debayer,tone', [('ppg', 'linear'), ('bilinear', 'filmic'),
                                          ('ppg', 'adaptive_aces'), ('bilinear', 'aces'),
                                          ('rcd', 'filmic'), ('rcd', 'linear')])
def test_debayers_and_tonemappers_fused_and_piecewise_vs_jax(rng, debayer, tone):
    """Every debayer and tonemapper through build_pipeline_fn (fused, via
    process) and through the piecewise chain, against JAX: 1 count each."""
    js = _jsettings(debayer=JDebayer[debayer], tone_mapping=JTone[tone], tone_gamma=1.5,
                    tone_intensity=2.0, light_adapt=0.8, ppg_median_threshold=2.0)
    jp, tp = _procs(js)
    data, _ = _bytes(96, 128, rng, smooth=True)
    assert _counts(tp.process(data, 'x').numpy(), jp.process(jnp.asarray(data), 'x')) <= 1
    jp2, tp2 = _procs(js)
    assert _counts(_piecewise_t(tp2, data).numpy(), _piecewise_j(jp2, data)) <= 1


def test_piecewise_pieces_vs_jax(rng):
    """load_bytes (with padding, IDS format), debayer and the default-metrics
    tonemap, piece by piece."""
    js = _jsettings()
    size = (128, 96)
    jp = JProcessor(size, td.BayerPattern.BGGR, td.PackedFormat.Packed12_IDS, js, padding=16)
    tp = tt.ImageProcessor(size, tt.BayerPattern.BGGR, tt.PackedFormat.Packed12_IDS,
                           settings_from_dict(js.model_dump()), device='cpu', padding=16)
    data, _ = _bytes(96, 128, rng, ids=True, padding=16, smooth=True)
    bayer = tp.load_bytes(data)
    np.testing.assert_array_equal(bayer.numpy(), np.asarray(jp.load_bytes(jnp.asarray(data))))
    assert bayer.shape == (96, 128)
    rgb = tp.debayer(bayer)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jp.debayer(jnp.asarray(bayer.numpy()))),
                               atol=2e-6)
    out = tp.tonemap(rgb)   # metrics computed at stride 4, as in JAX
    assert _counts(out.numpy(), jp.tonemap(jnp.asarray(rgb.numpy()))) <= 1
    unnormalized = tp.process_rgb(rgb)   # bounds=None: no normalize
    ref = jp.process_rgb(jnp.asarray(rgb.numpy()))
    np.testing.assert_allclose(unnormalized.numpy(), np.asarray(ref), atol=1e-3)


def test_bytes_by_keyword_as_in_jax(rng):
    """load_bytes, load_image and process name their first parameter
    `bytes`, as JAX's do, and give JAX's results when called by keyword."""
    jp, tp = _procs(_jsettings())
    data, _ = _bytes(96, 128, rng, smooth=True)
    np.testing.assert_array_equal(tp.load_bytes(bytes=data).numpy(),
                                  np.asarray(jp.load_bytes(bytes=jnp.asarray(data))))
    np.testing.assert_allclose(tp.load_image(bytes=data).numpy(),
                               np.asarray(jp.load_image(bytes=jnp.asarray(data))), atol=2e-6)
    assert _counts(tp.process(bytes=data, image_name='x').numpy(),
                   jp.process(bytes=jnp.asarray(data), image_name='x')) <= 1


def test_piecewise_errors_repr_and_final_size(rng):
    js = _jsettings(resize_width=64)
    jp, tp = _procs(js, transforms=tt.ImageTransform.rotate_90)
    assert tp.final_size == jp.final_size == (64, 48)
    assert repr(tp) == repr(JProcessor(
        (128, 96), td.BayerPattern.RGGB, td.PackedFormat.Packed12, js, white_balance=WB,
        transforms=td.pipeline.ImageTransform.rotate_90)).replace('device=None', 'device=cpu')
    named = tt.ImageProcessor((128, 96), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                              settings_from_dict(js.model_dump()), device='cpu',
                              transforms={'a': tt.ImageTransform.flip_vert})
    assert 'wb=None' in repr(named) and 'transform={a: flip_vert}' in repr(named)
    with pytest.raises(tt.pipeline.ImageSizeMismatchError, match='expected 18432 bytes'):
        tp.load_bytes(np.zeros(100, np.uint8))
    with pytest.raises(AssertionError):
        tp.debayer(torch.zeros(96, 128, 1))
    # the Laplacian is accepted: the workspaces rebuild and process_rgb runs it
    tp.update_settings(dataclasses.replace(tp.settings, enable_laplacian=True, lap_clarity=0.3))
    assert tp.settings.enable_laplacian
    out = tp.process_rgb(torch.full((96, 128, 3), 0.5))
    assert out.shape == (96, 128, 3) and bool(torch.isfinite(out).all())


def test_state_carried_as_metrics_dict():
    """convert.processor_state_from_numpy takes JAX's metrics_to_dict dict."""
    _, tp = _procs(_jsettings())
    m = np.array([-1.25, 0.31, 0.2, 0.3, 0.4], np.float32)
    processor_state_from_numpy(tp, [0.0, 0.9], jtone.metrics_to_dict(jnp.asarray(m)))
    np.testing.assert_array_equal(tp.metrics.numpy(), m)
    np.testing.assert_array_equal(tp.bounds.numpy(), np.array([0.0, 0.9], np.float32))


def test_update_settings_rebuilds_workspaces():
    _, tp = _procs(_jsettings())
    old = tp.bil_workspace
    tp.update_settings(dataclasses.replace(tp.settings, bil_sigma_spatial=4.0, denoise_overlap=2,
                                           ppg_median_threshold=3.0))
    assert tp.bil_workspace is not old and tp.bil_workspace.sigma_s == 4.0
    assert tp.wiener_workspace.overlap_factor == 2
    assert tp.ppg_workspace.median_threshold == 3.0
    assert tp.postprocess_workspace.color_smoothing_passes == tp.settings.color_smoothing_passes


def test_exports_use_the_jax_names():
    """Everything the port exports at the top level exists in the JAX
    package under the same name (top level or pipeline)."""
    for name in tt.__all__:
        assert hasattr(tt, name), name
        assert hasattr(td, name) or hasattr(td.pipeline, name) \
            or name in ('build_pipeline_fn', 'load_camera_settings_from_dir'), name
    for mod in ('bayer', 'color_conversion', 'debayer', 'tonemap', 'white_balance'):
        for name in getattr(tt, mod).__all__:
            assert name in getattr(td, mod).__all__, (mod, name)
