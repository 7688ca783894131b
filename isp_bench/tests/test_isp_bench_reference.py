"""The reference against the measured package's CPU path at a small size,
the benchmark's packer against the package's decoder, and the control
against the reference."""

import json

import numpy as np
import pytest
import torch

from isp_bench import scene
from isp_bench.reference import jpeg as ref_jpeg
from isp_bench.reference.isp import Camera, ReferenceISP, lerp
from tpu_darktable_torch.ops.packed import decode12_float
from tpu_darktable_torch.pipeline.camera_settings import CameraSettings
from tpu_darktable_torch.pipeline.image_processor import ImageProcessor
from tpu_darktable_torch.pipeline.transform import transform
from tpu_darktable_torch.jpeg import Jpeg

SIZE = [128, 96]


def _camera(name):
    from isp_bench import spec

    cam = dict(spec.config(name)['camera'], image_size=SIZE)
    return cam


@pytest.mark.parametrize('ids', [False, True])
def test_packer_round_trips_through_the_package_decoder(ids):
    v = torch.randint(0, 4096, (3, 96), dtype=torch.int32, generator=torch.Generator().manual_seed(1))
    packed = scene.pack12(v, ids)
    assert torch.equal(decode12_float(packed, ids_format=ids, scaled=False).to(torch.int32), v)


def test_frames_depend_on_the_seed_alone():
    cam = _camera('beetroot')
    a = scene.frame_pool(cam, 2, 2**31 + 5, 'cpu')
    b = scene.frame_pool(cam, 2, 2**31 + 5, 'cpu')
    c = scene.frame_pool(cam, 2, 2**31 + 6, 'cpu')
    assert a.shape == (2, SIZE[0] * SIZE[1] * 3 // 2) and a.dtype == np.uint8
    assert np.array_equal(a, b) and not np.array_equal(a, c)


# the local-Laplacian camera: artichoke with upstream's documented clarity
LAPLACIAN = {'enable_laplacian': True, 'lap_clarity': 0.3}


def _laplacian_camera():
    cam = _camera('artichoke')
    return dict(cam, image_processing=dict(cam['image_processing'], **LAPLACIAN))


def _follow(cam):
    """The reference against ImageProcessor's CPU path over three batches:
    bounds equal, metrics within 1e-6, uint8 within one count."""
    pool = scene.frame_pool(cam, 4, 11, 'cpu')
    proc = ImageProcessor.from_camera_settings(CameraSettings.from_dict(cam), device='cpu')
    ref = ReferenceISP(Camera.from_dict(cam), 'cpu')
    bounds, metrics = torch.zeros(2), torch.zeros(5)
    for k, idx in enumerate([[0, 1], [2, 3], [0, 1]]):
        frames = [torch.from_numpy(pool[i]) for i in idx]
        m_in = proc.metrics
        out = proc.process_batch(torch.stack(frames))
        alpha = ref.alpha(k == 0)
        bounds = lerp(bounds, ref.batch_bounds([ref.sample(ref.front(f)) for f in frames]), alpha)
        u8, m = ref.run_batch(frames, bounds, torch.zeros(5) if m_in is None else m_in, alpha)
        assert torch.equal(proc.bounds, bounds)
        # the CPU's float16 matmuls may sum in another order from one
        # process to the next; the card's comparison has its own limits
        assert (proc.metrics - m).abs().max() <= 1e-6
        for j in range(len(frames)):
            assert (out[j].int() - u8[j].int()).abs().max() <= 1


@pytest.mark.parametrize('name', ['artichoke', 'beetroot'])
def test_reference_follows_the_package_cpu_path(name):
    _follow(_camera(name))


def test_laplacian_route_follows_the_package_cpu_path():
    cam = _laplacian_camera()
    assert 'local_contrast' in ReferenceISP(Camera.from_dict(cam), 'cpu').stages
    _follow(cam)


def test_laplacian_control_is_not_correct():
    """A run of the stream cell with the Laplacian camera is correct, and
    the bfloat16 control in its place is not."""
    from isp_bench import bench, check, spec

    over = {'image_size': SIZE, 'image_processing': _laplacian_camera()['image_processing']}
    r = bench.run('artichoke.stream_jpeg', 2**31 + 41, 1.5, False, devices=['cpu'],
                  camera_override=over, control=True)
    assert r['correct'] is True, r['checks']
    ok, rows = check.verdict(r['control'], spec.limits('artichoke.stream_jpeg'))
    assert ok is False, rows


@pytest.mark.parametrize('setting,value', [('debayer', 'ppg'), ('tone_mapping', 'filmic'),
                                           ('resize_width', 1024)])
def test_uncovered_setting_raises_when_the_reference_is_made(setting, value):
    cam = _camera('artichoke')
    cam = dict(cam, image_processing=dict(cam['image_processing'], **{setting: value}))
    with pytest.raises(NotImplementedError, match=setting):
        ReferenceISP(Camera.from_dict(cam), 'cpu')


def test_stage_file_is_picked_up_by_its_setting(tmp_path, monkeypatch):
    """A stage file dropped into the routes directory covers its setting,
    with no edit to isp.py or check.py: here a PPG camera, demosaicked by a
    file that runs the frozen RCD and counts its calls."""
    from isp_bench.reference import isp

    (tmp_path / 'debayer.ppg.py').write_text(
        'from ..frozen.ops import rcd\n'
        'calls = []\n\n\n'
        'def demosaic(isp, bayer):\n'
        '    calls.append(bayer.shape)\n'
        '    return rcd.rcd_demosaic(bayer, isp.camera.pattern, strict_alias=True)\n')
    (tmp_path / 'tone_mapping.filmic.py').write_text('X = 1\n')
    monkeypatch.setattr(isp, 'ROUTES', tmp_path)
    base = _camera('artichoke')
    cam = dict(base, image_processing=dict(base['image_processing'], debayer='ppg'))
    ref = ReferenceISP(Camera.from_dict(cam), 'cpu')
    demosaic = ref.stages['demosaic']
    frame = torch.from_numpy(scene.frame_pool(cam, 1, 5, 'cpu')[0])
    rgb = ref.front(frame)
    assert demosaic.__globals__['calls'] == [(SIZE[1], SIZE[0])]
    # the same frame through the built-in RCD of the plain camera
    assert torch.equal(rgb, ReferenceISP(Camera.from_dict(base), 'cpu').front(frame))
    # a file that defines no stage covers nothing
    cam = dict(base, image_processing=dict(base['image_processing'], tone_mapping='filmic'))
    with pytest.raises(NotImplementedError, match='defines none'):
        ReferenceISP(Camera.from_dict(cam), 'cpu')


def test_control_is_far_from_the_reference():
    cam = _camera('artichoke')
    pool = scene.frame_pool(cam, 2, 3, 'cpu')
    frames = [torch.from_numpy(p) for p in pool]
    ref = ReferenceISP(Camera.from_dict(cam), 'cpu')
    ctl = ReferenceISP(Camera.from_dict(cam), 'cpu', lower_precision=True)
    b = ref.batch_bounds([ref.sample(ref.front(f)) for f in frames])
    a = ref.alpha(True)
    u8, _ = ref.run_batch(frames, b, torch.zeros(5), a)
    u8c, _ = ctl.run_batch(frames, b, torch.zeros(5), a)
    assert max(int((x.int() - y.int()).abs().max()) for x, y in zip(u8, u8c)) >= 10


@pytest.mark.parametrize('shape', [(48, 64), (600, 1000), (1030, 1022)])
@pytest.mark.parametrize('tf', ['none', 'rotate_90', 'rotate_270'])
def test_reference_jpeg_equals_the_package_encoder(shape, tf):
    from tpu_darktable_torch.pipeline.transform import ImageTransform

    h, w = shape
    rng = np.random.default_rng(h + w)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 80 * np.sin(xx / 17) * np.cos(yy / 23)
    img = np.clip(base[..., None] * np.array([1, 0.7, 0.4]) + rng.normal(0, 6, (h, w, 3)), 0, 255)
    t = transform(torch.from_numpy(img.astype(np.uint8)), ImageTransform[tf]).contiguous()
    want = np.asarray(Jpeg().encode(t, quality=90, entropy='host'))
    assert np.array_equal(ref_jpeg.encode(t, 90), want)
    assert np.array_equal(np.asarray(Jpeg().encode(t, quality=90, entropy='device')), want)


def test_reference_camera_reads_the_settings_files():
    from isp_bench import spec

    cam = Camera.from_dict(spec.config('beetroot')['camera'])
    assert cam.ids and cam.white_balance == (1.8, 1.0, 2.1)
    assert cam.transform_of('cam1').name == 'rotate_90' and cam.transform_of('cam12').name == 'rotate_270'
    assert cam.settings['tone_mapping'] == 'aces' and cam.settings['denoise_f16'] is True
    art = Camera.from_dict(json.loads(json.dumps(spec.config('artichoke')['camera'])))
    assert art.white_balance is None and art.transform_of('x').name == 'rotate_270'
