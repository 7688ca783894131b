"""The port end to end against the JAX package, on the CPU: the FULL
pipeline over two batches (EMA exercised), the RCD goldens, the settings
schema, state carried across, device rules, and the port's isolation from
JAX.  Output tolerance: 1 uint8 count; EMA state: atol 1e-5 (the metrics
of the Laplacian chains 3e-5, see there).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tpu_darktable as td
from tpu_darktable.ops import packed as jpacked
from tpu_darktable.pipeline import ImageProcessor as JProcessor
from tpu_darktable.pipeline.camera_settings import load_camera_settings_from_dir as j_load_cams
from tpu_darktable.pipeline.config import (
    Debayer as JDebayer,
    ImageProcessingSettings as JSettings,
    ToneMapper as JTone,
)
from tpu_darktable.pipeline.image_processor import build_pipeline_fn

import tpu_darktable_torch as tt
from tpu_darktable_torch.convert import processor_state_from_numpy, settings_from_dict
from tpu_darktable_torch.pipeline.config import ImageProcessingSettings as TSettings

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / 'tests' / 'goldens' / 'pipeline_goldens.npz'

FULL = dict(debayer=JDebayer.rcd, postprocess=True, enable_denoise=True,
            enable_bilateral=True, tone_mapping=JTone.adaptive_aces, tone_gamma=1.5,
            tone_intensity=2.0, light_adapt=0.8, vibrance=0.5)
WB = (1.2, 1.0, 1.1)


def _frames(w, h, n, seed, ids=False):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        m = np.clip(0.4 + 0.3 * np.sin(xx / (9.0 + i)) * np.cos(yy / 7.0)
                    + rng.normal(0, 0.04, (h, w)), 0, 1).astype(np.float32)
        out.append(np.asarray(jpacked.encode12_float(jnp.asarray(m.reshape(-1)), ids_format=ids)))
    return np.stack(out)


@pytest.mark.parametrize('size', [(128, 96), (320, 240)])
def test_full_pipeline_two_batches(size):
    """FULL settings, RGGB Packed12 with WB, two batches of 2: port output
    within 1 count of build_pipeline_fn; bounds and metrics within 1e-5
    (both on the float16 Wiener route of the default denoise_f16)."""
    w, h = size
    js = JSettings(**FULL)
    fn = jax.jit(build_pipeline_fn(js, size, td.BayerPattern.RGGB, td.PackedFormat.Packed12, True))
    proc = tt.ImageProcessor(size, tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                             settings_from_dict(js.model_dump()), device='cpu', white_balance=WB)
    frames = _frames(w, h, 4, seed=7)
    bounds, metrics = jnp.zeros(2, jnp.float32), jnp.zeros(5, jnp.float32)
    for k in range(2):
        batch = frames[2 * k : 2 * k + 2]
        alpha = jnp.float32(1.0 if k == 0 else js.moving_average)
        ref, bounds, metrics = fn(jnp.asarray(batch), jnp.asarray(WB, jnp.float32),
                                  bounds, metrics, alpha)
        out = proc.process_batch(batch)
        assert out.shape == (2, h, w, 3) and out.dtype == torch.uint8
        d = np.abs(np.asarray(ref).astype(int) - out.numpy().astype(int))
        assert d.max() <= 1, (k, d.max())
        np.testing.assert_allclose(proc.bounds.numpy(), np.asarray(bounds), atol=1e-5)
        np.testing.assert_allclose(proc.metrics.numpy(), np.asarray(metrics), atol=1e-5)


# The case filed against the port's Wiener route: FULL's stages with the
# default tone settings and bilateral 0.6, where JAX's float16 and float32
# Wiener routes put a few pixels 42-51 counts apart (one of them maps to
# (0, 0, 0) and the other to a colour).
_ROUTE_CASE = dict(debayer=JDebayer.rcd, postprocess=True, enable_denoise=True,
                   enable_bilateral=True, bilateral=0.6)


@pytest.mark.parametrize('f16', [True, False], ids=['denoise_f16', 'float32'])
@pytest.mark.parametrize('tone', ['adaptive_aces', 'reinhard'])
@pytest.mark.parametrize('seed', [3, 8, 11])
def test_wiener_route_follows_denoise_f16(seed, tone, f16):
    """The port takes the Wiener route `denoise_f16` names, as JAX does:
    fused (one batch of 2) and piecewise (one frame, bounds and metrics at
    stride 8) within 1 count of the JAX ImageProcessor on the same route;
    bounds within 1e-5."""
    size = (160, 96)
    js = JSettings(**_ROUTE_CASE, tone_mapping=JTone[tone], denoise_f16=f16)
    jproc = JProcessor(size, td.BayerPattern.RGGB, td.PackedFormat.Packed12, js,
                       white_balance=WB)
    tproc = tt.ImageProcessor(size, tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                              settings_from_dict(js.model_dump()), device='cpu',
                              white_balance=WB)
    frames = _frames(*size, 2, seed=seed)
    ref = np.asarray(jproc.process_batch(jnp.asarray(frames))).astype(int)
    out = tproc.process_batch(frames).numpy().astype(int)
    assert np.abs(ref - out).max() <= 1
    np.testing.assert_allclose(tproc.bounds.numpy(), np.asarray(jproc.bounds), atol=1e-5)
    rgb = tproc.load_image(bytes=frames[0])
    rgb = tproc.process_rgb(rgb, tt.compute_image_bounds([rgb], stride=8))
    out = tproc.tonemap(rgb, tt.compute_image_metrics([rgb], stride=8)).numpy().astype(int)
    jrgb = jproc.load_image(bytes=jnp.asarray(frames[0]))
    jrgb = jproc.process_rgb(jrgb, td.compute_image_bounds([jrgb], stride=8))
    ref = np.asarray(jproc.tonemap(jrgb, td.compute_image_metrics([jrgb], stride=8))).astype(int)
    assert np.abs(ref - out).max() <= 1


def _golden_input(size, ids):
    # tests/test_goldens.py:_input_bytes, on the port's encoder
    w, h = size
    rng = np.random.default_rng(1234)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    mosaic = np.clip(0.4 + 0.25 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
                     + rng.normal(0, 0.04, (h, w)).astype(np.float32), 0, 1)
    return tt.encode(torch.from_numpy(mosaic.reshape(-1).astype(np.float32)),
                     tt.PackedFormat.Packed12_IDS if ids else tt.PackedFormat.Packed12)


def _golden(debayer, tone, postprocess=True, denoise=True, bilateral=True, **extra):
    return dict(debayer=tt.Debayer[debayer], tone_mapping=tt.ToneMapper[tone],
                postprocess=postprocess, enable_denoise=denoise, enable_bilateral=bilateral,
                **extra)


# tests/test_goldens.py:CASES: (size, pattern, IDS, settings)
_RCD_DN = _golden('rcd', 'reinhard')
_RCD_PLAIN = _golden('rcd', 'reinhard', denoise=False, bilateral=False)
_PPG_ACES = _golden('ppg', 'aces', denoise=False, bilateral=False)
GOLDEN_CASES = {
    'rcd_reinhard': ((96, 64), 'RGGB', False, _RCD_DN),
    'ppg_aces': ((96, 64), 'RGGB', False, _PPG_ACES),
    'bilinear_adaptive_aces': ((96, 64), 'RGGB', False,
                               _golden('bilinear', 'adaptive_aces', postprocess=False,
                                       bilateral=False)),
    'rcd_linear_lap': ((96, 64), 'RGGB', False,
                       _golden('rcd', 'linear', postprocess=False, denoise=False,
                               bilateral=False, enable_laplacian=True, lap_clarity=0.3)),
    'rcd_reinhard_ids': ((96, 64), 'RGGB', True, _RCD_DN),
    'rcd_bggr': ((96, 64), 'BGGR', False, _RCD_PLAIN),
    'rcd_grbg': ((96, 64), 'GRBG', False, _RCD_PLAIN),
    'ppg_gbrg': ((96, 64), 'GBRG', False, _PPG_ACES),
    'rcd_4to3_aspect': ((320, 240), 'RGGB', False, _RCD_DN),
}


@pytest.mark.parametrize('name', list(GOLDEN_CASES))
def test_rcd_goldens(name):
    """Every golden of tests/goldens/pipeline_goldens.npz: 1 count."""
    size, pattern, ids, extra = GOLDEN_CASES[name]
    settings = TSettings(tone_intensity=2.0, tone_gamma=1.2, light_adapt=0.8, vibrance=0.3,
                         **extra)
    proc = tt.ImageProcessor(size, tt.BayerPattern[pattern],
                             tt.PackedFormat.Packed12_IDS if ids else tt.PackedFormat.Packed12,
                             settings, device='cpu', white_balance=WB)
    out = proc.process(_golden_input(size, ids), 'x').numpy()
    ref = np.load(GOLDEN)[name]
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


_LAP_CHAINS = {
    # tests/test_pipeline.py:test_laplacian_in_fused_chain's chain
    'bilinear_lap': dict(enable_denoise=False, enable_bilateral=False, postprocess=False,
                         debayer=JDebayer.bilinear, enable_laplacian=True, lap_clarity=0.5),
    # golden rcd_linear_lap's local contrast on FULL's settings, on the
    # float32 Wiener route (the float16 route:
    # test_full_laplacian_metrics_follow_the_float32_route)
    'full_lap': dict(FULL, enable_laplacian=True, lap_clarity=0.3, denoise_f16=False),
    'bilateral_lap': dict(FULL, enable_denoise=False, enable_laplacian=True, lap_shadows=0.7,
                          lap_highlights=1.3),
}


@pytest.mark.parametrize('route', ['fused', 'piecewise'])
@pytest.mark.parametrize('chain', list(_LAP_CHAINS))
def test_laplacian_in_chain_matches_jax(chain, route):
    """The local Laplacian as the last luminance stage, against the JAX
    ImageProcessor: 1 count; fused over two batches of 2 with the EMA
    state (bounds 1e-5, metrics 3e-5), piecewise on one frame with bounds
    and metrics taken at stride 8.  The stage changes the output."""
    size = (128, 96)
    js = JSettings(**_LAP_CHAINS[chain])
    jproc = JProcessor(size, td.BayerPattern.RGGB, td.PackedFormat.Packed12, js,
                       white_balance=WB)
    tproc = tt.ImageProcessor(size, tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                              settings_from_dict(js.model_dump()), device='cpu',
                              white_balance=WB)
    frames = _frames(*size, 4, seed=21)
    if route == 'fused':
        for k in range(2):
            batch = frames[2 * k : 2 * k + 2]
            ref = np.asarray(jproc.process_batch(jnp.asarray(batch)))
            out = tproc.process_batch(batch).numpy()
            assert np.abs(ref.astype(int) - out.astype(int)).max() <= 1
            np.testing.assert_allclose(tproc.bounds.numpy(), np.asarray(jproc.bounds), atol=1e-5)
            np.testing.assert_allclose(tproc.metrics.numpy(), np.asarray(jproc.metrics),
                                       atol=3e-5)
    else:
        rgb = tproc.load_image(frames[0])
        rgb = tproc.process_rgb(rgb, tt.compute_image_bounds([rgb], stride=8))
        out = tproc.tonemap(rgb, tt.compute_image_metrics([rgb], stride=8)).numpy()
        jrgb = jproc.load_image(jnp.asarray(frames[0]))
        jrgb = jproc.process_rgb(jrgb, td.compute_image_bounds([jrgb], stride=8))
        ref = np.asarray(jproc.tonemap(jrgb, td.compute_image_metrics([jrgb], stride=8)))
        assert np.abs(ref.astype(int) - out.astype(int)).max() <= 1
    off = tt.ImageProcessor(size, tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                            dataclasses.replace(tproc.settings, enable_laplacian=False),
                            device='cpu', white_balance=WB)
    assert (off.process_batch(frames[2:4]).numpy() != out[-1:] if route == 'fused'
            else off.process(frames[0], 'x').numpy() != out).any()


def test_full_laplacian_metrics_follow_the_float32_route():
    """FULL + Laplacian (clarity 0.3) on each Wiener route, against the JAX
    package on the same route: output within 1 count, bounds 1e-5.  On the
    float32 route the metrics EMA is within 3e-5.  On the float16 route the
    port's LAB differs from XLA's by 1 ulp at ~2% of the pixels, the float16
    storage turns a few of those into float16-ulp steps of the Wiener
    output, and the clarity term lifts them into the metrics' log mean
    (observed 2.0e-4 at 128x96): there the bar is a tenth of the distance
    between JAX's own two routes (2.7e-3), which the port on the other
    route would not meet."""
    size = (128, 96)
    frames = _frames(*size, 2, seed=21)
    settings = dict(FULL, enable_laplacian=True, lap_clarity=0.3)
    metrics, gaps = {}, {}
    for f16 in (True, False):
        js = JSettings(**settings, denoise_f16=f16)
        jproc = JProcessor(size, td.BayerPattern.RGGB, td.PackedFormat.Packed12, js,
                           white_balance=WB)
        ref = np.asarray(jproc.process_batch(jnp.asarray(frames))).astype(int)
        tproc = tt.ImageProcessor(size, tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                                  settings_from_dict(js.model_dump()), device='cpu',
                                  white_balance=WB)
        out = tproc.process_batch(frames).numpy().astype(int)
        assert np.abs(ref - out).max() <= 1
        np.testing.assert_allclose(tproc.bounds.numpy(), np.asarray(jproc.bounds), atol=1e-5)
        metrics[f16] = np.asarray(jproc.metrics)
        gaps[f16] = np.abs(tproc.metrics.numpy() - metrics[f16]).max()
    assert gaps[False] <= 3e-5
    assert gaps[True] <= 0.1 * np.abs(metrics[True] - metrics[False]).max()


def test_settings_schema_matches_jax():
    """Field for field: names, order, defaults; enum members and values."""
    t_fields = {f.name: f for f in dataclasses.fields(TSettings)}
    j_fields = JSettings.model_fields
    assert list(t_fields) == list(j_fields)
    for name, jf in j_fields.items():
        tf = t_fields[name]
        t_default = tf.default
        j_default = jf.default
        if isinstance(j_default, (JDebayer, JTone)):
            assert t_default.name == j_default.name and t_default.value == j_default.value
        else:
            assert t_default == j_default, name
    for t_enum, j_enum in ((tt.Debayer, JDebayer), (tt.ToneMapper, JTone)):
        assert [(m.name, m.value) for m in t_enum] == [(m.name, m.value) for m in j_enum]
    with pytest.raises(ValueError):
        TSettings(tone_gamma=9.0)
    with pytest.raises(ValueError):
        TSettings(denoise_overlap=1)


def test_settings_round_trip_and_camera_files(tmp_path):
    js = JSettings(**FULL, denoise_overlap=2, resize_width=1024)
    ts = settings_from_dict(js.model_dump())
    assert ts.to_dict() == js.model_dump(mode='json')
    assert JSettings.model_validate(ts.to_dict()) == js
    ts.save_json(tmp_path / 's.json')
    assert TSettings.load_json(tmp_path / 's.json') == ts
    t_cams = tt.load_camera_settings_from_dir()
    j_cams = j_load_cams()
    assert set(t_cams) == set(j_cams)
    for name, jc in j_cams.items():
        assert t_cams[name].to_dict() == jc.model_dump(mode='json'), name


def test_state_carried_from_jax():
    """EMA state and WB taken from a JAX ImageProcessor continue the same
    next batch in the port: 1 count, state 1e-5."""
    size = (128, 96)
    js = JSettings(**FULL)
    jproc = JProcessor(size, td.BayerPattern.RGGB, td.PackedFormat.Packed12, js,
                       white_balance=WB)
    frames = _frames(*size, 2, seed=11)
    jproc.process_batch(jnp.asarray(frames[:1]))
    tproc = tt.ImageProcessor(size, tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                              settings_from_dict(js.model_dump()), device='cpu')
    processor_state_from_numpy(tproc, np.asarray(jproc.bounds), np.asarray(jproc.metrics),
                               np.asarray(jproc.white_balance))
    ref = np.asarray(jproc.process_batch(jnp.asarray(frames[1:])))
    out = tproc.process_batch(frames[1:]).numpy()
    assert np.abs(ref.astype(int) - out.astype(int)).max() <= 1
    np.testing.assert_allclose(tproc.metrics.numpy(), np.asarray(jproc.metrics), atol=1e-5)


def test_device_rules():
    """Entry points default to the card and never fall back to the CPU."""
    settings = TSettings(**{k: v for k, v in FULL.items() if k not in ('debayer', 'tone_mapping')})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='cuda'):
            tt.ImageProcessor((64, 64), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12, settings)
    # every stage is ported: the local Laplacian builds and runs on the CPU
    lap = tt.ImageProcessor((64, 64), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                            dataclasses.replace(settings, enable_laplacian=True), device='cpu')
    assert lap.process_rgb(torch.full((64, 64, 3), 0.5)).shape == (64, 64, 3)
    proc = tt.ImageProcessor((64, 64), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                             settings, device='cpu')
    with pytest.raises(tt.pipeline.ImageSizeMismatchError):
        proc.process_batch(np.zeros((1, 100), np.uint8))


def test_rcd_strict_alias_flag_matches_jax():
    """build_pipeline_fn(rcd_strict_alias=False), the sharded programs'
    reference, against JAX's with the same flag on the small FULL case:
    1 count, EMA state 1e-5; it differs from the strict program."""
    size = (128, 96)
    js = JSettings(**FULL)
    frames = _frames(*size, 2, seed=21)
    ref, jb, jm = jax.jit(build_pipeline_fn(js, size, td.BayerPattern.RGGB,
                                            td.PackedFormat.Packed12, True,
                                            rcd_strict_alias=False))(
        jnp.asarray(frames), jnp.asarray(WB, jnp.float32), jnp.zeros(2, jnp.float32),
        jnp.zeros(5, jnp.float32), jnp.float32(1.0))
    state = (torch.tensor(WB), torch.zeros(2), torch.zeros(5), torch.tensor(1.0))
    ts = settings_from_dict(js.model_dump())
    out, tb, tm = tt.build_pipeline_fn(ts, size, tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                                       True, rcd_strict_alias=False)(torch.from_numpy(frames),
                                                                     *state)
    assert np.abs(out.numpy().astype(int) - np.asarray(ref).astype(int)).max() <= 1
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)
    strict = tt.build_pipeline_fn(ts, size, tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                                  True)(torch.from_numpy(frames), *state)[0]
    assert not torch.equal(strict, out)


def test_port_imports_without_jax():
    """The port, its command-line tools, parallel/ and the viewer included,
    imports with jax and tpu_darktable blocked (and Pillow and matplotlib,
    which the tools and the viewer's windows import only to read, write or
    show a file), and no source file of it names jax or tpu_darktable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tpu_darktable'] = None\n"
        "sys.modules['PIL'] = sys.modules['matplotlib'] = None   # absent on the card host\n"
        "import tpu_darktable_torch, tpu_darktable_torch.convert\n"
        "import tpu_darktable_torch.kernels.rcd_interior, tpu_darktable_torch.kernels._build\n"
        "import tpu_darktable_torch.kernels.color_smooth, tpu_darktable_torch.kernels.bilateral_band\n"
        "import tpu_darktable_torch.kernels.grid_blur, tpu_darktable_torch.kernels.wavelet\n"
        "import tpu_darktable_torch.kernels.nlm, tpu_darktable_torch.denoise\n"
        "import tpu_darktable_torch.local_contrast, tpu_darktable_torch.debayer\n"
        "import tpu_darktable_torch.kernels.wiener_core, tpu_darktable_torch.kernels.bilateral_fused\n"
        "import tpu_darktable_torch.pipeline.presets, tpu_darktable_torch.tonemap\n"
        "import tpu_darktable_torch.jpeg, tpu_darktable_torch.ops.jpeg\n"
        "import tpu_darktable_torch.ops.jpeg_entropy, tpu_darktable_torch.ops.jpeg_progressive\n"
        "import tpu_darktable_torch.native, tpu_darktable_torch.pipeline.streaming\n"
        "import tpu_darktable_torch.utils.timing, tpu_darktable_torch.ops.laplacian\n"
        "import tpu_darktable_torch.extension, tpu_darktable_torch._paths\n"
        "import tpu_darktable_torch.pipeline.camera_settings, tpu_darktable_torch.pipeline.util\n"
        "import tpu_darktable_torch.scripts.util, tpu_darktable_torch.scripts.bayer_utils\n"
        "import tpu_darktable_torch.scripts.dump_camera_settings\n"
        "import tpu_darktable_torch.scripts.run_benchmark, tpu_darktable_torch.scripts.test_jpeg\n"
        "import tpu_darktable_torch.scripts.test_debayer, tpu_darktable_torch.scripts.test_wiener\n"
        "import tpu_darktable_torch.scripts.test_bilateral, tpu_darktable_torch.scripts.test_laplacian\n"
        "import tpu_darktable_torch.parallel, tpu_darktable_torch.parallel.spatial_pipeline\n"
        "import tpu_darktable_torch.scripts.view_raw.main, tpu_darktable_torch.scripts.view_raw.ui\n"
        "import tpu_darktable_torch.scripts.view_raw.pipeline_ui\n"
        "import tpu_darktable_torch.scripts.view_raw.jpeg_utils\n"
        "import tpu_darktable_torch.scripts.view_raw.histogram_ui\n"
        "import tpu_darktable_torch.scripts.view_raw.histogram_window\n"
        "import tpu_darktable_torch.scripts.view_raw.jpeg_preview_window\n"
        "import tpu_darktable_torch.scripts.view_raw.histogram_display\n"
        "import tpu_darktable_torch.scripts.view_raw.ui_builder\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules if sys.modules[m])\n"
    )
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    import re
    bad = re.compile(r'^\s*(import jax|from jax|import tpu_darktable[. ]|import tpu_darktable$'
                     r'|from tpu_darktable[. ])', re.M)
    for path in [*sorted((REPO / 'tpu_darktable_torch').rglob('*.py')), REPO / 'chip_smoke.py',
                 REPO / 'chip_trace.py']:
        assert not bad.search(path.read_text()), path
