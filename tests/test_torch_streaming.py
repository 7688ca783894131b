"""The port's streaming executor on the CPU (tests/test_pipeline.py:310-357
on the port's ImageProcessor), against JAX's executor on the same frames,
and the one transform dispatch table on tensors and on numpy arrays."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tpu_darktable as td
from tpu_darktable.ops import jpeg as J
from tpu_darktable.ops import packed as jpacked
from tpu_darktable.pipeline import ImageProcessor as JProcessor
from tpu_darktable.pipeline import ImageTransform as JTransform
from tpu_darktable.pipeline.config import (
    Debayer as JDebayer,
    ImageProcessingSettings as JSettings,
    ToneMapper as JTone,
)
from tpu_darktable.pipeline.streaming import StreamingExecutor as JExecutor

import tpu_darktable_torch as tt
from tpu_darktable_torch.pipeline.config import ImageProcessingSettings as TSettings
from tpu_darktable_torch.pipeline.streaming import StreamingExecutor
from tpu_darktable_torch.pipeline.transform import ImageTransform, transform

torch.set_num_threads(1)

SMALL = dict(debayer='bilinear', postprocess=False, enable_denoise=False,
             enable_bilateral=False, tone_mapping='reinhard', tone_intensity=2.5, vibrance=0.5)
# config 5's settings (bench.py's FULL) in miniature
FULL = dict(debayer='rcd', postprocess=True, enable_denoise=True, enable_bilateral=True,
            tone_mapping='adaptive_aces', tone_gamma=1.5, tone_intensity=2.0, light_adapt=0.8,
            vibrance=0.5)


def _frames(rng, h, w, n):
    out = []
    for i in range(n):
        mosaic = (rng.random((h, w)) * 0.8).astype(np.float32)
        out.append((f'f{i}', np.asarray(jpacked.encode12_float(jnp.asarray(mosaic.reshape(-1))))))
    return out


def _port_processor(kw, w, h, n):
    s = TSettings(**{k: (tt.Debayer[v] if k == 'debayer' else tt.ToneMapper[v]
                         if k == 'tone_mapping' else v) for k, v in kw.items()})
    return tt.ImageProcessor(
        (w, h), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12, s, device='cpu',
        white_balance=(1.2, 1.0, 1.1),
        transforms={f'f{i}': (ImageTransform.rotate_90 if i % 2 else ImageTransform.none)
                    for i in range(n)})


def _jax_processor(kw, w, h, n):
    s = JSettings(**{k: (JDebayer[v] if k == 'debayer' else JTone[v]
                         if k == 'tone_mapping' else v) for k, v in kw.items()})
    return JProcessor(
        (w, h), td.BayerPattern.RGGB, td.PackedFormat.Packed12, s,
        white_balance=(1.2, 1.0, 1.1),
        transforms={f'f{i}': (JTransform.rotate_90 if i % 2 else JTransform.none)
                    for i in range(n)})


def test_streaming_executor(rng):
    h, w, n = 64, 64, 5
    proc = _port_processor(SMALL, w, h, n)
    frames = _frames(rng, h, w, n)

    ex = StreamingExecutor(proc, batch_size=2, jpeg_quality=90, jpeg_workers=2)
    assert ex.device_jpeg is False   # auto: on only for a processor on a card
    results = ex.run(frames)
    assert len(results) == n
    by_name = {r.name: r for r in results}
    assert set(by_name) == {f'f{i}' for i in range(n)}
    for i in range(n):
        r = by_name[f'f{i}']
        assert r.error is None
        assert r.jpeg is not None and r.jpeg[:2] == b'\xff\xd8'
        assert r.image.shape == ((w, h, 3) if i % 2 else (h, w, 3))

    # images-only mode
    results2 = StreamingExecutor(proc, batch_size=3, jpeg_quality=None).run(frames)
    assert len(results2) == n and all(r.jpeg is None for r in results2)

    # device-JPEG mode: the entropy packed by the device path; bitstreams and
    # images equal the host-worker executor's.  The EMA state is reset so this
    # run starts from the same state as ex's.
    proc.metrics = None
    proc.bounds = None
    seen = []
    results3 = StreamingExecutor(proc, batch_size=2, jpeg_quality=90, device_jpeg=True).run(
        frames, on_result=seen.append)
    assert [r.name for r in seen] == [r.name for r in results3]
    by_name3 = {r.name: r for r in results3}
    for i in range(n):
        r3 = by_name3[f'f{i}']
        assert r3.error is None
        assert r3.jpeg == by_name[f'f{i}'].jpeg
        np.testing.assert_array_equal(r3.image, by_name[f'f{i}'].image)


@pytest.mark.parametrize('kw,size,n', [(SMALL, (64, 64), 5), (FULL, (128, 96), 3)],
                         ids=['small', 'full'])
def test_streaming_matches_jax(rng, kw, size, n):
    """Against JAX's executor on the same frames: images within 1 count, and
    each port JPEG is JAX's encode of the port's image, byte for byte."""
    w, h = size
    frames = _frames(rng, h, w, n)
    ours = {r.name: r for r in StreamingExecutor(
        _port_processor(kw, w, h, n), batch_size=2, jpeg_quality=90, device_jpeg=True).run(frames)}
    theirs = {r.name: r for r in JExecutor(
        _jax_processor(kw, w, h, n), batch_size=2, jpeg_quality=90).run(frames)}
    assert set(ours) == set(theirs)
    for name, r in ours.items():
        assert r.error is None and theirs[name].error is None
        assert r.image.shape == theirs[name].image.shape
        assert np.abs(r.image.astype(int) - theirs[name].image.astype(int)).max() <= 1, name
        assert r.jpeg == J.encode_jpeg(r.image, quality=90).tobytes(), name


def test_transform_host_matches_device(rng):
    """One dispatch table serves tensors (torch) and host arrays (numpy):
    every member gives the same pixels either way, and the host path stays
    numpy."""
    img = rng.random((4, 6, 3)).astype(np.float32)
    for tf in ImageTransform:
        host = transform(img, tf, xp=np)
        dev = transform(torch.from_numpy(img), tf).numpy()
        assert isinstance(host, np.ndarray), tf
        np.testing.assert_array_equal(host, dev, err_msg=str(tf))
    with pytest.raises(ValueError):
        transform(img, 'not-a-transform')
