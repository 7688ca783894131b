"""The port's streaming executor on the CPU (tests/test_pipeline.py:310-357
on the port's ImageProcessor), against JAX's executor on the same frames;
its drainer thread under a paced feed, a slow consumer and failures; and
the one transform dispatch table on tensors and on numpy arrays."""

import sys
import threading
import time

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


# the executor's modes: keyword arguments beyond the processor and batch size
MODES = {'device JPEG': dict(jpeg_quality=90, device_jpeg=True),
         'host JPEG': dict(jpeg_quality=90, device_jpeg=False, jpeg_workers=1),
         'images only': dict(jpeg_quality=None)}


def _paced(frames, batch, pace, on_take=None):
    """The frames, with `pace` seconds of sleep before each batch's first
    frame, as an open loop waits for its next capture; `on_take()` is
    called as that frame is handed out."""
    for i, f in enumerate(frames):
        if i % batch == 0:
            time.sleep(pace)
            if on_take is not None:
                on_take()
        yield f


def _run(frames, mode, n, batch=2, pace=0.0):
    ex = StreamingExecutor(_port_processor(SMALL, 64, 64, n), batch_size=batch, **MODES[mode])
    return ex.run(_paced(frames, batch, pace))


@pytest.mark.parametrize('mode', ['device JPEG', 'images only'])
def test_paced_feed_gets_each_batch_back_before_the_next_take(rng, mode):
    """With the feed waiting before each batch, every result of batch k
    reaches on_result before the feed hands out batch k+1's first frame
    (a batch no longer waits for the next one's flush)."""
    n, batch = 6, 2
    frames = _frames(rng, 64, 64, n)
    seen, at_take = [], []
    ex = StreamingExecutor(_port_processor(SMALL, 64, 64, n), batch_size=batch, **MODES[mode])
    results = ex.run(_paced(frames, batch, 0.3, lambda: at_take.append(len(seen))),
                     on_result=seen.append)
    assert at_take == [0, 2, 4]
    assert [r.name for r in seen] == [r.name for r in results] == [f'f{i}' for i in range(n)]
    assert all(r.error is None for r in results)


@pytest.mark.parametrize('mode', ['device JPEG', 'host JPEG'])
def test_paced_and_unpaced_feeds_give_the_same_results(rng, mode):
    """The same frames fed at once and paced (a partial last batch too),
    each from a fresh processor: the same results in the same order, the
    same JPEG bytes and images."""
    n = 5
    frames = _frames(rng, 64, 64, n)
    at_once = _run(frames, mode, n)
    paced = _run(frames, mode, n, pace=0.1)
    assert [r.name for r in paced] == [r.name for r in at_once] == [f'f{i}' for i in range(n)]
    for a, b in zip(at_once, paced):
        assert a.error is None and b.error is None
        assert a.jpeg[:2] == b'\xff\xd8' and a.jpeg == b.jpeg, a.name
        np.testing.assert_array_equal(a.image, b.image)


class _Boom(Exception):
    pass


@pytest.mark.parametrize('mode', ['device JPEG', 'host JPEG'])
@pytest.mark.parametrize('where', ['on_result', 'feed'])
def test_failures_come_out_of_run_and_no_thread_outlives_it(rng, mode, where):
    """An exception raised inside on_result, or by the feed after the first
    batch, comes out of run on the caller's thread, and no thread the
    executor started is alive once run has returned."""
    n = 6
    frames = _frames(rng, 64, 64, n)

    def feed():
        for i, f in enumerate(frames):
            if where == 'feed' and i == 3:
                raise _Boom('the feed')
            yield f

    def on_result(r):
        if where == 'on_result' and r.name == 'f1':
            raise _Boom('on_result')

    before = set(threading.enumerate())
    ex = StreamingExecutor(_port_processor(SMALL, 64, 64, n), batch_size=2, **MODES[mode])
    with pytest.raises(_Boom, match=where):
        ex.run(feed(), on_result=on_result)
    assert [t.name for t in threading.enumerate() if t not in before] == []


class _Counting:
    """A processor that, at each batch it makes, notes how many of its
    batches (the new one among them) have results that have not all
    reached the caller; the caller's on_result takes `delay` seconds, so
    the drain lags the feed."""

    def __init__(self, proc, batch, delay=0.05):
        self.proc, self.batch, self.delay = proc, batch, delay
        self.made = self.done = self.most = 0

    def __getattr__(self, name):
        return getattr(self.proc, name)

    def process_batch(self, x):
        self.made += 1
        self.most = max(self.most, self.made - self.done // self.batch)
        return self.proc.process_batch(x)

    def on_result(self, r):
        time.sleep(self.delay)
        self.done += 1


@pytest.mark.parametrize('mode', ['device JPEG', 'images only'])
def test_at_most_two_batches_are_undrained(rng, mode):
    n, batch = 8, 2
    proc = _Counting(_port_processor(SMALL, 64, 64, n), batch)
    results = StreamingExecutor(proc, batch_size=batch, **MODES[mode]).run(
        _frames(rng, 64, 64, n), on_result=proc.on_result)
    assert len(results) == n and proc.made == n // batch and proc.done == n
    assert proc.most == 2


def test_feed_order_and_bound_hold_under_a_short_switch_interval(rng):
    """Stress: 24 batches of one frame with the interpreter switching
    threads every microsecond: the results keep feed order and at most two
    batches are undrained."""
    n = 24
    proc = _Counting(_port_processor(SMALL, 64, 64, n), 1, delay=0.0)
    frames = _frames(rng, 64, 64, n)
    seen = []

    def on_result(r):
        seen.append(r.name)
        proc.on_result(r)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        results = StreamingExecutor(proc, batch_size=1, **MODES['device JPEG']).run(
            frames, on_result=on_result)
    finally:
        sys.setswitchinterval(old)
    assert seen == [r.name for r in results] == [f'f{i}' for i in range(n)]
    assert all(r.error is None for r in results) and proc.most <= 2


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
