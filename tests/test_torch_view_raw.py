"""The port's raw viewer (tpu_darktable_torch/scripts/view_raw/) headless on
the CPU, case by case as tests/test_scripts.py holds the JAX package's:
the controller (`device='cpu'`; its frame within 1 uint8 count of the JAX
package's controller on the same raw file, its mosaic bit for bit), the
histogram renderers, windows and component, the widget layout, the main
window, the JPEG helpers (bytes equal to the JAX package's), and `main` on
a directory as a subprocess.  matplotlib runs on the Agg backend.
"""

import dataclasses
import inspect
import subprocess
import sys
from pathlib import Path

import matplotlib
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_darktable.ops import packed as jpacked
from tpu_darktable.pipeline.camera_settings import CameraSettings as JCameraSettings
from tpu_darktable.pipeline.config import (Debayer as JDebayer,
                                           ImageProcessingSettings as JSettings,
                                           ToneMapper as JTone)
from tpu_darktable.scripts.view_raw import jpeg_utils as jjpeg
from tpu_darktable.scripts.view_raw import pipeline_ui as jpui

from tpu_darktable_torch.ops.packed import encode12_float
from tpu_darktable_torch.pipeline.camera_settings import CameraSettings
from tpu_darktable_torch.pipeline.config import ToneMapper
from tpu_darktable_torch.scripts.view_raw import jpeg_utils, pipeline_ui
from tpu_darktable_torch.scripts.view_raw.pipeline_ui import PipelineController, widget_spec

matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
SETTINGS = dict(debayer='bilinear', postprocess=False, enable_denoise=False,
                enable_bilateral=False, tone_mapping='reinhard', tone_intensity=2.5)


@pytest.fixture(scope='module')
def raw_file(tmp_path_factory):
    """A synthetic Packed12 raw file, with the port's and the JAX package's
    settings for its camera."""
    h, w = 64, 96
    mosaic = (np.random.default_rng(1).random((h, w)) * 0.8).astype(np.float32)
    data = np.asarray(jpacked.encode12_float(jnp.asarray(mosaic.reshape(-1))))
    d = tmp_path_factory.mktemp('cam') / 'testcam'
    d.mkdir()
    path = d / 'frame0.raw'
    path.write_bytes(data.tobytes())
    kw = dict(name='testcam', image_size=(w, h))
    port = CameraSettings(image_processing=pipeline_ui.ImageProcessingSettings(**SETTINGS), **kw)
    jax_settings = JCameraSettings(image_processing=JSettings(**SETTINGS), **kw)
    return path, port, jax_settings


def _controller(raw_file):
    path, settings, _ = raw_file
    return PipelineController(settings, [path], device='cpu')


def _max_diff(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a.astype(int) - b.astype(int)).max()


# ---- the controller ----

def test_pipeline_controller(raw_file, tmp_path):
    path, settings, jsettings = raw_file
    c = _controller(raw_file)
    jc = jpui.PipelineController(jsettings, [path])
    img = c.process_current()
    assert isinstance(img, np.ndarray) and img.shape == (64, 96, 3) and img.dtype == np.uint8
    assert _max_diff(img, jc.process_current()) <= 1
    np.testing.assert_array_equal(c.current_bayer(), np.asarray(jc.current_bayer()))

    # live settings update changes the output, as JAX's does
    c.update_setting('tone_gamma', 2.0)
    jc.update_setting('tone_gamma', 2.0)
    img2 = c.process_current()
    assert (img != img2).any()
    assert _max_diff(img2, jc.process_current()) <= 1

    # preset switch + rotate + reset
    c.apply_preset('reinhard')
    jc.apply_preset('reinhard')
    assert c.settings.tone_mapping == ToneMapper.reinhard
    c.rotate()
    jc.rotate()
    img3 = c.process_current()
    assert img3.shape == (96, 64, 3)
    assert _max_diff(img3, jc.process_current()) <= 1
    c.reset()
    assert c.settings == settings.image_processing
    assert c.extra_rotation.name == 'none'

    # settings persistence round trip
    target = c.save_settings(tmp_path / 'cam.json')
    loaded = CameraSettings.load_json(target)
    assert loaded.image_processing == c.settings
    assert loaded == dataclasses.replace(settings, image_processing=c.settings)

    # navigation wraps
    c.next_image(1)
    assert c.index == 0


def test_update_setting_validates():
    """dataclasses.replace, which update_setting uses, runs the settings'
    validators: a value outside a field's range raises."""
    c_settings = pipeline_ui.ImageProcessingSettings(**SETTINGS)
    with pytest.raises(ValueError, match='tone_gamma'):
        dataclasses.replace(c_settings, tone_gamma=9.0)


def test_update_setting_coerces_types(raw_file):
    c = _controller(raw_file)
    c.update_setting('enable_bilateral', 1)
    c.update_setting('denoise_overlap', 2.0)
    assert c.settings.enable_bilateral is True and c.settings.denoise_overlap == 2
    c.update_setting('debayer', pipeline_ui.ImageProcessingSettings().debayer)
    assert c.processor.settings == c.settings


@pytest.mark.parametrize('field', ['tone_gamma', 'denoise_overlap', 'postprocess', 'debayer',
                                   'tone_mapping', 'lap_sigma', 'bilateral'])
def test_widget_spec_matches_jax(field):
    assert widget_spec(field) == jpui.widget_spec(field)
    kind, meta = widget_spec('tone_gamma')
    assert kind == 'slider' and meta['range'] == (0.1, 5.0)


def test_widget_field_lists_match_jax():
    for name in ('SLIDER_FIELDS', 'CHECKBOX_FIELDS', 'RADIO_FIELDS'):
        assert getattr(pipeline_ui, name) == getattr(jpui, name)


def test_controller_resolves_to_the_card(raw_file):
    """Without a device the controller means the card; where there is none
    it raises (nothing falls back to the CPU)."""
    path, settings, _ = raw_file
    if torch.cuda.is_available():
        assert PipelineController(settings, [path]).device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='cuda'):
            PipelineController(settings, [path])


# ---- histograms ----

def test_histogram_display(raw_file):
    from tpu_darktable_torch.scripts.view_raw.histogram_display import (draw_histograms,
                                                                        get_channel_means)
    from tpu_darktable.scripts.view_raw.histogram_display import (
        get_channel_means as j_channel_means)

    c = _controller(raw_file)
    bayer = c.current_bayer()
    fig, ax = plt.subplots()
    sat = draw_histograms(ax, bayer, c.camera_settings.bayer_pattern)
    assert set(sat) == {'R', 'G1', 'G2', 'B'}
    plt.close(fig)
    from tpu_darktable.ops.bayer import BayerPattern as JPattern
    assert get_channel_means(bayer, c.camera_settings.bayer_pattern) == \
        j_channel_means(bayer, JPattern.RGGB)


def test_histogram_window(raw_file):
    """Persistent levels popup: channel toggles, saturation legend and
    update_display on a new frame."""
    from tpu_darktable_torch.scripts.view_raw.histogram_window import HistogramWindow

    c = _controller(raw_file)
    bayer = c.current_bayer()
    win = HistogramWindow(bayer, c.camera_settings.bayer_pattern)
    assert win.is_open()
    assert 'μ=' in win.hist_ax.get_title()
    legend = win.hist_ax.get_legend()
    assert legend is not None
    assert any('% sat' in t.get_text() for t in legend.get_texts())

    win._on_channel_toggle('Red')
    assert not win.channel_states['Red']
    texts = [t.get_text() for t in win.hist_ax.get_legend().get_texts()]
    assert not any(t.startswith('Red') for t in texts)

    win.update_display(bayer * 0.5)
    win.close()
    assert not win.is_open()


def test_jpeg_preview_window(raw_file):
    """Persistent JPEG explorer: quality changes re-encode, the PSNR and size
    readout updates."""
    from tpu_darktable_torch.scripts.view_raw.jpeg_preview_window import JpegPreviewWindow

    c = _controller(raw_file)
    win = JpegPreviewWindow(c.process_current, device='cpu')
    assert win.is_open()
    first = win.info_text.get_text()
    assert 'dB PSNR' in first and 'MB' in first

    win.quality_slider.set_val(30)
    assert win.jpeg_quality == 30
    assert win.info_text.get_text() != first

    win._on_progressive_toggle('Progressive')
    assert win.jpeg_progressive
    win.close()
    assert not win.is_open()


def test_histogram_ui_component(raw_file):
    """Embedded HistogramDisplay: mode switching keeps the zoom scale."""
    from tpu_darktable_torch.scripts.view_raw.histogram_ui import HistogramDisplay

    c = _controller(raw_file)
    bayer = c.current_bayer()
    pattern = c.camera_settings.bayer_pattern
    fig = plt.figure()
    disp = HistogramDisplay()
    res = disp.setup_display(fig, (0.1, 0.1, 0.8, 0.8), bayer, pattern)
    assert 'μ=' in res.display_info and not res.needs_setup
    assert disp.get_channel_controls() is not None

    res = disp.update_display(bayer, pattern, channel_mode='Red')
    assert disp.channel_mode == 'Red' and not res.needs_setup

    fresh = HistogramDisplay()
    assert fresh.update_display(bayer, pattern).needs_setup
    plt.close(fig)


def test_histogram_mode_renderer_reference_semantics(raw_file):
    """draw_mode_histograms: full (0, 1) range including saturated samples,
    per-mode titles, green halved only in 'all' mode."""
    from tpu_darktable_torch.scripts.view_raw.histogram_display import draw_mode_histograms

    c = _controller(raw_file)
    bayer = c.current_bayer()
    pattern = c.camera_settings.bayer_pattern
    fig, ax = plt.subplots()
    draw_mode_histograms(ax, bayer, pattern, 'all')
    assert ax.get_title() == 'RGB Channels'
    assert ax.get_ylabel() == 'Count (Normalized)'
    assert max(p.get_x() + p.get_width() for p in ax.patches) >= 1.0 - 1e-9

    ax.clear()
    draw_mode_histograms(ax, bayer, pattern, 'green')
    assert ax.get_title() == 'Green Channel'
    assert ax.get_ylabel() == 'Count'
    assert sum(p.get_height() for p in ax.patches) == bayer.size // 2
    plt.close(fig)


# ---- widget layout ----

def test_horizontal_radio_layout():
    """orientation='horizontal': labels flow left to right on <= 2 rows."""
    from tpu_darktable_torch.scripts.view_raw.ui_builder import (create_clean_axes,
                                                                 create_radio_buttons)

    fig = plt.figure(figsize=(8, 6))
    ax = create_clean_axes(fig, (0.1, 0.8, 0.8, 0.1))
    rb = create_radio_buttons(ax, ['All', 'Red', 'Green', 'Blue'], 'All',
                              orientation='horizontal')
    pos = [t.get_position() for t in rb.labels]
    ys = sorted({round(y, 3) for _, y in pos})
    assert len(ys) <= 2
    for y in ys:
        xs = [x for x, py in pos if round(py, 3) == y]
        assert xs == sorted(xs) and len(set(xs)) == len(xs)

    ax2 = create_clean_axes(fig, (0.1, 0.6, 0.3, 0.1))
    labels = ['linear', 'reinhard', 'aces', 'adaptive_aces', 'filmic']
    rb2 = create_radio_buttons(ax2, labels, 'aces', orientation='horizontal')
    assert len({round(t.get_position()[1], 3) for t in rb2.labels}) == 2
    plt.close(fig)


def test_ui_builder_layout():
    """VStack placement: rows advance downward, half panels pair up."""
    from tpu_darktable_torch.scripts.view_raw.ui_builder import (VStack, create_checkboxes,
                                                                 create_radio_buttons,
                                                                 fit_fontsize)

    fig = plt.figure(figsize=(10, 8))
    col = VStack(fig, x=0.7, top=0.95, width=0.26)
    s1 = col.slider_ax()
    s2 = col.slider_ax()
    assert s2.get_position().y0 < s1.get_position().y0

    left = col.panel_ax(3, half=1)
    right = col.panel_ax(5, half=2)
    assert abs(left.get_position().x0 - 0.7) < 1e-6
    assert right.get_position().x0 > left.get_position().x0
    after = col.take(0.03)
    assert after[1] + after[3] <= right.get_position().y0 + 1e-9

    rb = create_radio_buttons(left, ['alpha', 'beta'], 'beta')
    assert rb.value_selected == 'beta'
    cb = create_checkboxes(right, ['one', 'two'], [True, False])
    assert cb.get_status() == [True, False]
    assert fit_fontsize(fig, ['short'], avail_fraction=0.5) == 8.0
    plt.close(fig)


# ---- the main window ----

def test_main_ui_constructs_and_refreshes(raw_file, tmp_path):
    """ProcessRawUI builds headless, navigates, and keeps its popups in step
    with the current frame; its callbacks drive the controller."""
    from tpu_darktable_torch.scripts.view_raw.ui import ProcessRawUI

    c = _controller(raw_file)
    ui = ProcessRawUI(c)
    assert ui._im is not None
    shown = ui._im.get_array().copy()
    np.testing.assert_array_equal(shown, c.process_current())

    ui.show_histogram()
    ui.show_jpeg_preview()
    assert ui.histogram_window.is_open() and ui.jpeg_window.is_open()
    before = ui.jpeg_window.info_text.get_text()
    ui._nav(1)  # a single file: wraps to itself, and refreshes the popups
    assert ui.histogram_window.is_open()
    assert before == ui.jpeg_window.info_text.get_text()

    ui._rotate()
    assert ui._im.get_array().shape == (96, 64, 3)
    ui._on_tonemap('linear')
    assert c.settings.tone_mapping.name == 'linear'
    ui._reset()
    assert c.settings == c.camera_settings.image_processing

    ui.histogram_window.close()
    ui.jpeg_window.close()
    plt.close(ui.fig)


# ---- the JPEG helpers ----

def test_jpeg_utils_roundtrip():
    """The port's encoder gives the JAX package's bytes; Pillow decodes them."""
    yy, xx = np.mgrid[0:32, 0:48].astype(np.float32)
    img = np.clip(np.stack([
        128 + 90 * np.sin(xx / 7), 128 + 70 * np.cos(yy / 9), 128 + 50 * np.sin((xx + yy) / 11)
    ], -1), 0, 255).astype(np.uint8)
    for progressive in (False, True):
        data = jpeg_utils.encode_jpeg_bytes(img, quality=90, progressive=progressive, device='cpu')
        assert data == jjpeg.encode_jpeg_bytes(img, quality=90, progressive=progressive)
        dec = jpeg_utils.decode_jpeg_bytes(data)
        assert dec.shape == img.shape
        assert jpeg_utils.jpeg_psnr(img, dec) > 30.0


# ---- the entry point ----

def test_find_raw_files(tmp_path):
    from tpu_darktable_torch.scripts.view_raw.main import find_raw_files

    (tmp_path / 'a').mkdir()
    for name in ('a/x.raw', 'b.bin', 'c', 'd.png'):
        (tmp_path / name).write_bytes(b'\0')
    assert [p.name for p in find_raw_files(tmp_path)] == ['x.raw', 'b.bin', 'c']
    with pytest.raises(FileNotFoundError):
        find_raw_files(tmp_path / 'a' / 'x.raw.missing')


def test_main_on_directory(tmp_path):
    """`main` on a directory named after a camera (carrot: 2472x2062,
    Packed12_IDS): the camera is found by the name, the window built and
    shown (at once, on Agg), exit 0."""
    d = tmp_path / 'carrot'
    d.mkdir()
    w, h = 2472, 2062
    mosaic = (np.random.default_rng(3).random(w * h) * 0.8).astype(np.float32)
    (d / 'f0.raw').write_bytes(encode12_float(torch.from_numpy(mosaic), ids_format=True)
                               .numpy().tobytes())
    r = subprocess.run(
        [sys.executable, '-m', 'tpu_darktable_torch.scripts.view_raw.main', str(tmp_path),
         '--device', 'cpu'],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={'PATH': '/usr/bin:/bin:/usr/local/bin', 'HOME': str(Path.home()),
             'MPLBACKEND': 'Agg', 'OMP_NUM_THREADS': '2'})
    assert r.returncode == 0, r.stderr
    assert 'camera: carrot (2472, 2062)' in r.stdout


# ---- the surface ----

VIEW_RAW = ['histogram_display', 'histogram_ui', 'histogram_window', 'jpeg_preview_window',
            'jpeg_utils', 'main', 'pipeline_ui', 'ui', 'ui_builder']


@pytest.mark.parametrize('module', VIEW_RAW)
def test_view_raw_surface_covers_jax(module):
    """Every public name a JAX module defines exists in the port's module,
    and each function or class takes the JAX package's parameters, in its
    order (the port may add `device` after them)."""
    import importlib

    jmod = importlib.import_module(f'tpu_darktable.scripts.view_raw.{module}')
    tmod = importlib.import_module(f'tpu_darktable_torch.scripts.view_raw.{module}')
    assert getattr(tmod, '__all__', None) == getattr(jmod, '__all__', None)
    for name, obj in vars(jmod).items():
        if name.startswith('_') or getattr(obj, '__module__', None) != jmod.__name__:
            continue
        assert hasattr(tmod, name), name
        if callable(obj):
            jp = list(inspect.signature(obj).parameters)
            tp = list(inspect.signature(getattr(tmod, name)).parameters)
            assert tp[:len(jp)] == jp and set(tp[len(jp):]) <= {'device'}, (name, jp, tp)
