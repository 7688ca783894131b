"""The port's command-line tools: each runs headless on the CPU as a
subprocess (`--device cpu`, MPLBACKEND=Agg, no JAX_PLATFORMS) and exits 0,
and each image tool's pure function `run(rgb, args, device)` equals the
JAX package's ops on the same seeded input, within the tolerances the
other test_torch_* files hold those ops to."""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tpu_darktable as td
from tpu_darktable import denoise as jdenoise
from tpu_darktable import local_contrast as jlc
from tpu_darktable.ops import laplacian as jlap
from tpu_darktable.pipeline.camera_settings import load_camera_settings_from_dir as j_load_cams
from tpu_darktable.scripts import bayer_utils as jbu

from tpu_darktable_torch.ops.bayer import BayerPattern
from tpu_darktable_torch.scripts import bayer_utils as tbu
from tpu_darktable_torch.scripts import (test_bilateral, test_debayer, test_jpeg, test_laplacian,
                                         test_wiener)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
OP_LINE = re.compile(r'^(.+?): \d+ iterations', re.M)


def _run_cli(module, *args):
    return subprocess.run(
        [sys.executable, '-m', module, *args],
        capture_output=True, text=True, timeout=480,
        env={'PATH': '/usr/bin:/bin:/usr/local/bin', 'HOME': str(Path.home()),
             'MPLBACKEND': 'Agg'},
        cwd=REPO,
    )


@pytest.fixture(scope='module')
def test_png(tmp_path_factory):
    from PIL import Image

    path = tmp_path_factory.mktemp('imgs') / 'test.png'
    arr = (np.random.default_rng(0).random((64, 96, 3)) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path)
    return path


def _rgb(seed, h=64, w=96):
    """A smooth colour scene with mild noise, as (H, W, 3) float32 in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rgb = np.stack([0.45 + 0.3 * np.sin(xx / 9.0) * np.cos(yy / 7.0),
                    0.5 + 0.25 * np.cos(xx / 13.0), 0.4 + 0.3 * np.sin((xx + yy) / 11.0)], -1)
    return np.clip(rgb + rng.normal(0, 0.03, rgb.shape), 0, 1).astype(np.float32)


def _port(module, rgb, *argv):
    args = module.parser().parse_args(['unused.png', *argv, '--device', 'cpu'])
    return {k: v.numpy() for k, v in module.run(torch.from_numpy(rgb), args, 'cpu').items()}


# ---- the CLIs as subprocesses ----

def test_dump_camera_settings_cli():
    """The JSON printed for pfr equals JAX's model dump as a dict."""
    r = _run_cli('tpu_darktable_torch.scripts.dump_camera_settings', '--camera', 'pfr')
    assert r.returncode == 0, r.stderr
    head, body = r.stdout.split('\n', 1)
    assert head == '=== pfr ==='
    assert json.loads(body) == j_load_cams()['pfr'].model_dump(mode='json')


def test_run_benchmark_cli_prints_jax_op_names():
    """At 64x48 with one iteration: exit 0 and the same set of op names
    as the JAX package's CLI."""
    size = ['--width', '64', '--height', '48', '--bench-iters', '1', '--warmup-iters', '1']
    r = _run_cli('tpu_darktable_torch.scripts.run_benchmark', *size, '--device', 'cpu')
    assert r.returncode == 0, r.stderr
    j = subprocess.run([sys.executable, '-m', 'tpu_darktable.scripts.run_benchmark', *size],
                       capture_output=True, text=True, timeout=480, cwd=REPO,
                       env={'PATH': '/usr/bin:/bin:/usr/local/bin', 'HOME': str(Path.home()),
                            'JAX_PLATFORMS': 'cpu'})
    assert j.returncode == 0, j.stderr
    names = set(OP_LINE.findall(r.stdout))
    assert len(names) == 13 and names == set(OP_LINE.findall(j.stdout))


@pytest.mark.parametrize('module,args', [
    ('test_debayer', ['--algorithm', 'rcd']),
    ('test_debayer', ['--algorithm', 'ppg', '--pattern', 'GRBG']),
    ('test_bilateral', ['--sigma-s', '3', '--log-space']),
    ('test_wiener', ['--mode', 'log_luminance']),
    ('test_laplacian', ['--clarity', '0.3']),
    ('test_jpeg', ['--quality', '90', '--subsampling', '444']),
], ids=['debayer_rcd', 'debayer_ppg', 'bilateral', 'wiener', 'laplacian', 'jpeg'])
def test_image_cli_runs_headless(test_png, tmp_path, module, args):
    out = tmp_path / 'cmp.png'
    extra = ['--save', str(tmp_path / 'out.jpg')] if module == 'test_jpeg' else []
    r = _run_cli(f'tpu_darktable_torch.scripts.{module}', str(test_png), *args, *extra,
                 '--output', str(out), '--device', 'cpu')
    assert r.returncode == 0, r.stderr
    assert out.exists() and f'saved {out}' in r.stdout
    if module == 'test_jpeg':
        # the test image is uniform noise, the hardest case for JPEG
        psnr = float(re.search(r'decode PSNR: ([0-9.]+) dB', r.stdout).group(1))
        assert psnr > 25 and (tmp_path / 'out.jpg').exists()


def test_image_cli_on_the_card_by_default(test_png):
    """Without --device the tools ask for the card and never fall back."""
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device works')
    r = _run_cli('tpu_darktable_torch.scripts.test_bilateral', str(test_png), '--output', 'x.png')
    assert r.returncode != 0 and 'is_available() is False' in r.stderr


# ---- the pure functions against the JAX package's ops ----

@pytest.mark.parametrize('algorithm,pattern,tol', [('bilinear', 'RGGB', 3e-7),
                                                    ('ppg', 'GRBG', 0.0),
                                                    ('rcd', 'BGGR', 1e-6)])
def test_debayer_run_vs_jax(algorithm, pattern, tol):
    """The demosaic the CLI shows: PPG bit for bit, bilinear 3e-7 (the JAX
    op is jitted and XLA fuses its 13-tap sum), RCD 1e-6 (the workspace
    classes' bars, tests/test_torch_piecewise.py)."""
    rgb = _rgb(1)
    out = _port(test_debayer, rgb, '--algorithm', algorithm, '--pattern', pattern,
                '--median-threshold', '2.0')
    jp = td.BayerPattern[pattern]
    bayer = td.rgb_to_bayer(jnp.asarray(rgb), jp)
    h, w = bayer.shape[:2]
    ref = {'bilinear': lambda: td.bilinear5x5_demosaic(bayer, jp),
           'ppg': lambda: td.PPG(None, (w, h), jp, median_threshold=2.0).process(bayer),
           'rcd': lambda: td.RCD(None, (w, h), jp).process(bayer)}[algorithm]()
    got = out[f'{algorithm} demosaic']
    assert got.shape == (64, 96, 3) and got.min() >= 0.0 and got.max() <= 1.0
    assert np.abs(got - np.asarray(jnp.clip(ref, 0.0, 1.0))).max() <= tol
    np.testing.assert_array_equal(out['original'], rgb)


@pytest.mark.parametrize('sigma_s,log_space', [(2.0, False), (3.0, False), (2.0, True)])
def test_bilateral_run_vs_jax(sigma_s, log_space):
    """The fast path (sigma_s 2) and the general one (3), linear and log:
    2e-5, the Bilateral class's bar (tests/test_torch_denoise.py)."""
    rgb = _rgb(2)
    argv = ['--sigma-s', str(sigma_s), '--detail', '0.5'] + (['--log-space'] if log_space else [])
    out = _port(test_bilateral, rgb, *argv)['bilateral']
    bil = jlc.Bilateral(None, (96, 64), sigma_s=sigma_s, sigma_r=0.2)
    ref = (bil.process_log_rgb if log_space else bil.process_rgb)(jnp.asarray(rgb), 0.5)
    assert np.abs(out - np.asarray(ref)).max() <= 2e-5


@pytest.mark.parametrize('mode,sigma', [('rgb', None), ('rgb', 0.04), ('luminance', None),
                                        ('log_luminance', None), ('log', 0.05)])
def test_wiener_run_vs_jax(mode, sigma):
    """The noisy input equals JAX's (seed 0) and the denoised image is
    within 2e-5 of the JAX Wiener class in each mode, the sigma estimated
    or given (the Wiener class's bar, tests/test_torch_denoise.py)."""
    rgb = _rgb(3)
    argv = ['--mode', mode, '--tile-size', '16', '--overlap', '2']
    out = _port(test_wiener, rgb, *argv, *(['--sigma', str(sigma)] if sigma else []))
    rng = np.random.default_rng(0)
    noisy = jnp.clip(jnp.asarray(rgb) + jnp.asarray(
        rng.normal(0.0, 0.05, rgb.shape).astype(np.float32)), 0.0, 1.0)
    np.testing.assert_array_equal(out['noisy'], np.asarray(noisy))
    wiener = jdenoise.Wiener(None, (96, 64), overlap_factor=2, tile_size=16)
    s = sigma
    if s is None:
        s = td.estimate_channel_noise(noisy)
        if mode != 'rgb':
            s = float(np.asarray(s).mean())
    fn = {'rgb': wiener.process, 'luminance': wiener.process_luminance,
          'log_luminance': wiener.process_log_luminance, 'log': wiener.process_log}[mode]
    ref = fn(noisy, s if mode == 'rgb' else float(s))
    assert np.abs(out['denoised'] - np.asarray(ref)).max() <= 2e-5


@pytest.mark.parametrize('argv', [[], ['--shadows', '0.6', '--highlights', '1.4',
                                       '--clarity', '0.3']], ids=['neutral', 'strong'])
def test_laplacian_run_vs_jax(argv):
    """1e-3 with under 0.5% of the values above 1e-6, the Laplacian
    class's bar (tests/test_torch_laplacian.py)."""
    rgb = _rgb(4)
    out = _port(test_laplacian, rgb, *argv)['laplacian']
    kw = dict(zip(('shadows', 'highlights', 'clarity'), map(float, argv[1::2]))) if argv else {}
    ref = jlc.Laplacian(None, (96, 64), jlap.LaplacianParams(**kw)).process_rgb(jnp.asarray(rgb))
    d = np.abs(out - np.asarray(ref))
    assert d.max() <= 1e-3 and (d > 1e-6).mean() < 5e-3


@pytest.mark.parametrize('subsampling', ['444', '422', 'gray'])
def test_jpeg_run_vs_jax(subsampling):
    """The encoded bytes equal the JAX encoder's for the same image."""
    rgb = _rgb(5)
    out = _port(test_jpeg, rgb, '--quality', '90', '--subsampling', subsampling)
    u8 = (rgb * 255.0).round().astype(np.uint8)
    np.testing.assert_array_equal(out['original'], u8)
    sub = {'444': td.Subsampling.CSS_444, '422': td.Subsampling.CSS_422,
           'gray': td.Subsampling.CSS_GRAY}[subsampling]
    ref = td.Jpeg().encode(u8, quality=90, input_format=td.InputFormat.RGBI, subsampling=sub)
    assert out['jpeg'].tobytes() == np.asarray(ref).tobytes()


@pytest.mark.parametrize('pattern', ['RGGB', 'GBRG'])
def test_bayer_utils_vs_jax(pattern):
    """Channel samples and statistics equal JAX's, for an array and for a
    tensor, (H, W) and (H, W, 1)."""
    mosaic = np.random.default_rng(6).random((16, 24)).astype(np.float32)
    mosaic[0, :4] = 1.0
    ref = jbu.extract_bayer_channels(mosaic, td.BayerPattern[pattern])
    for x in (mosaic, torch.from_numpy(mosaic), torch.from_numpy(mosaic)[..., None]):
        out = tbu.extract_bayer_channels(x, BayerPattern[pattern])
        assert list(out) == list(ref)
        for name in ref:
            np.testing.assert_array_equal(out[name], ref[name])
        assert tbu.channel_statistics(x, BayerPattern[pattern]) == \
            jbu.channel_statistics(mosaic, td.BayerPattern[pattern])
