"""utils/timing of the port on the CPU: the stage timer and the chained
benchmark protocol (the cases of tests/test_timing.py), and the tracer:
spans, device marks (the CPU's ring; a capture emulated as a graph whose
replay writes its marks), counters, the switch and the capture key."""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import tpu_darktable_torch as tt
from tpu_darktable_torch import _device, _graph, kernels
from tpu_darktable_torch.ops.packed import encode12_float
from tpu_darktable_torch.ops import jpeg as jp
from tpu_darktable_torch.pipeline.config import Debayer, ImageProcessingSettings, ToneMapper
from tpu_darktable_torch.pipeline.streaming import StreamingExecutor
from tpu_darktable_torch.utils import StageTimer, benchmark_op, timing, trace_to


def test_stage_timer(rng):
    t = StageTimer()
    x = torch.from_numpy(rng.random((64, 64)).astype(np.float32))
    with t.stage('double') as st:
        st.record(x * 2.0)
    with t.stage('square') as st:
        st.record((x * x, {'again': x + 1}))
    assert [n for n, _ in t.timings] == ['double', 'square']
    assert all(dt >= 0 for _, dt in t.timings)
    t.print_timings()
    t.reset()
    assert not t.timings


def test_stage_timer_disabled():
    t = StageTimer(enabled=False)
    with t.stage('noop'):
        pass
    assert not t.timings


def test_benchmark_op(rng, tmp_path):
    x = torch.from_numpy(rng.random((128, 128)).astype(np.float32))
    dt = benchmark_op(lambda v: v * 0.5 + 0.1, x, iters=5, warmup=1)
    assert dt > 0
    with trace_to(str(tmp_path)):
        benchmark_op(lambda v: v * 0.5, x, iters=2, warmup=0)
    assert (tmp_path / 'trace.json').stat().st_size > 0


# ---- the tracer ----

CPU = torch.device('cpu')
FULL = ImageProcessingSettings(
    debayer=Debayer.rcd, postprocess=True, enable_denoise=True, enable_bilateral=True,
    tone_mapping=ToneMapper.adaptive_aces, tone_gamma=1.5, tone_intensity=2.0, light_adapt=0.8,
    vibrance=0.5)
# the marks of one call of the batched program of B frames, in order
FRONT = ['decode', 'demosaic', 'postprocess']
BACK = ['normalize', 'denoise', 'bilateral']


def program_marks(b, back=BACK):
    return ['begin'] + FRONT * b + ['bounds'] + back * b + ['metrics', 'tonemap']


@pytest.fixture()
def tracer():
    """The tracer on, from nothing recorded; off again after the test."""
    timing.reset()
    timing.enable()
    yield timing
    timing.disable()
    timing.reset()


@pytest.fixture()
def untraced():
    timing.disable()
    timing.reset()
    yield timing
    timing.reset()


def _frames(w, h, n, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return torch.stack([encode12_float(torch.from_numpy(np.clip(
        0.4 + 0.3 * np.sin(xx / (9.0 + i)) * np.cos(yy / 7.0) + rng.normal(0, 0.04, (h, w)),
        0, 1).astype(np.float32).reshape(-1))) for i in range(n)])


def _processor(settings=FULL, w=64, h=48):
    return tt.ImageProcessor((w, h), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12, settings,
                             device='cpu', white_balance=(1.2, 1.0, 1.1))


def test_spans_nest_and_carry_their_attrs(tracer):
    with timing.span('outer', seq=3):
        with timing.span('inner', owner='x'):
            pass
        with timing.span('inner'):
            pass
    got = timing.spans()
    assert [s.name for s in got] == ['inner', 'inner', 'outer']
    inner, _, outer = got
    assert outer.attrs == {'seq': 3} and inner.attrs == {'owner': 'x'}
    assert inner.parent == 'outer' and outer.parent is None
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert {s.thread for s in got} == {threading.get_ident()}


def test_spans_of_a_thread_nest_in_that_thread_alone(tracer):
    def work():
        with timing.span('worker'):
            pass

    with timing.span('main'):
        t = threading.Thread(target=work)
        t.start()
        t.join()
    worker = next(s for s in timing.spans() if s.name == 'worker')
    assert worker.parent is None and worker.thread != threading.get_ident()


def test_stage_timer_stages_are_spans(tracer):
    t = StageTimer()
    with t.stage('double') as st:
        st.record(torch.ones(4) * 2)
    assert [n for n, _ in t.timings] == ['double']
    assert [s.name for s in timing.spans()] == ['double']


def test_tracing_off_records_nothing_and_launches_nothing(untraced, monkeypatch):
    """A processor run without the switch: no span, no mark logged or
    written, and a capture keeps no mark."""
    def refuse(*a, **k):
        raise AssertionError('a mark was made with the tracer off')

    monkeypatch.setattr(kernels, 'launch', refuse)
    monkeypatch.setattr(timing, '_write_plain', refuse)
    proc = _processor()
    frames = _frames(64, 48, 4)
    proc.process_batch(frames[:2])
    proc.process_batch(frames[2:])
    timing.mark('loose')
    with timing.call('begin', CPU):
        timing.mark('inside')
    assert timing.spans() == [] and timing.marks() == [] and not timing.tracing()
    with _device.capturing() as made:
        with timing.call('begin', CPU):
            timing.mark('captured')
    assert made.marks == []


def test_cpu_marks_in_order_with_the_right_count_a_call(tracer):
    proc = _processor()
    frames = _frames(64, 48, 6)
    for k in range(3):
        proc.process_batch(frames[2 * k:2 * k + 2])
    got = timing.marks()
    calls = sorted({m.call for m in got})
    assert len(calls) == 3
    for c in calls:
        of_call = [m for m in got if m.call == c]
        assert [m.name for m in of_call] == program_marks(2)
        assert all(a.ns <= b.ns for a, b in zip(of_call, of_call[1:]))
        assert all(m.device == CPU for m in of_call)
    assert [s.name for s in timing.spans()] == ['isp.input'] * 3


def test_marks_follow_the_enabled_stages(tracer):
    s = dataclasses.replace(FULL, enable_denoise=False, enable_laplacian=True, lap_clarity=0.3)
    _processor(s).process_batch(_frames(64, 48, 1))
    assert [m.name for m in timing.marks()] == program_marks(1, ['normalize', 'bilateral',
                                                                 'lap.pyramids', 'laplacian'])


def test_the_sharded_stages_outside_a_call_are_unmarked(tracer):
    fused = tt.build_pipeline_fn(FULL, (64, 48), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                                 True)
    fused.stages.front(_frames(64, 48, 1), torch.ones(3))
    assert timing.marks() == []


class _MarkGraph:
    """A CUDA graph emulated on the CPU: a replay runs the captured function
    again, its own marks held back, and writes the captured marks to the
    CPU ring as the graph's mark nodes do on the card."""

    def replay(self):
        with _device.capturing():
            self.rerun()
        for mark_id, _ in self.marks:
            timing._write_plain(timing._ring(CPU), mark_id)


def _mark_record(graph, pool, fn, inputs):
    graph.marks = _device.current_capture().marks   # the capture's, filled by fn
    graph.rerun = lambda: fn(*inputs)
    return fn(*inputs)


@pytest.fixture()
def emulated(monkeypatch):
    monkeypatch.setattr(_graph, '_on_card', lambda t: isinstance(t, torch.Tensor))
    monkeypatch.setattr(_graph, '_new_pool', lambda: 'pool')
    monkeypatch.setattr(_graph, '_new_graph', _MarkGraph)
    monkeypatch.setattr(_graph, '_record', _mark_record)
    kernels.reset_launches()
    yield
    kernels.reset_launches()


def _marked(x):
    with timing.call('begin', x.device):
        y = x * 2
        timing.mark('a')
        y = y + 1
        timing.mark('b')
    return y


def test_a_capture_with_marks_adds_them_on_every_replay(tracer, emulated):
    g = _graph.Graphed(_marked)
    x = torch.arange(4.0)
    g(x)                                     # eager, then the capture
    entry = g._captured[_graph.capture_key((x,)) + timing.TRACED]
    assert [n for _, n in entry.made.marks] == ['begin', 'a', 'b']
    assert len(timing.marks()) == 3          # the eager call's; the capture logs none
    g(x + 1)
    g(x + 2)
    got = timing.marks()
    calls = sorted({m.call for m in got})
    assert len(got) == 9 and len(calls) == 3
    for c in calls:
        assert [m.name for m in got if m.call == c] == ['begin', 'a', 'b']
    replayed = [m for m in got if m.call in calls[1:]]
    assert {m.host for m in replayed if m.call == calls[1]} != \
        {m.host for m in replayed if m.call == calls[2]}
    spans = [s for s in timing.spans() if s.name.startswith('graph.')]
    assert [s.name for s in spans] == ['graph.capture', 'graph.replay', 'graph.replay']
    assert all(s.attrs == {'owner': '_marked'} for s in spans)


def test_tracing_state_splits_the_capture_key(emulated, untraced):
    g = _graph.Graphed(_marked)
    x = torch.arange(4.0)
    g(x)
    key = _graph.capture_key((x,))
    assert list(g._captured) == [key] and g._captured[key].made.marks == []
    timing.enable()
    try:
        g(x)                                 # a new capture, with its marks
        assert list(g._captured) == [key, key + timing.TRACED]
        assert len(g._captured[key + timing.TRACED].made.marks) == 3
    finally:
        timing.disable()
    g(x)                                     # a replay of the capture without marks
    assert len(g._captured) == 2 and list(g._captured)[-1] == key
    assert _graph.capture_key((x,)) == (((4,), torch.float32, CPU),)


def test_counters(untraced, emulated, monkeypatch):
    """graph.captures by owner and jpeg.host_fallbacks count with the
    tracer off too; counters() shows them with kernels.launches, which
    the tracer's reset leaves to kernels.reset_launches()."""
    kernels.reset_launches()
    g = _graph.Graphed(_marked)
    x = torch.arange(4.0)
    g(x)
    g(x)
    g(torch.arange(6.0))
    kernels.launches['rcd_interior'] += 2
    monkeypatch.setattr(jp, 'entropy_encode_device_finalize', lambda pending: None)
    img = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (16, 24, 3), np.uint8))
    data = tt.jpeg.Jpeg().encode_async(img, quality=90).result()
    assert data[:2].tobytes() == b'\xff\xd8'
    c = timing.counters()
    assert c['graph.captures'] == {'_marked': 2, '_jpeg_device_stage': 1, '_scan': 1}
    assert c['jpeg.host_fallbacks'] == 1
    assert c['kernels.launches']['rcd_interior'] == 2
    timing.reset()
    c = timing.counters()
    assert c['graph.captures'] == {} and c['jpeg.host_fallbacks'] == 0
    assert c['kernels.launches']['rcd_interior'] == 2
    kernels.reset_launches()


def test_streaming_spans_and_jpeg_marks(tracer):
    """The executor's spans a batch, numbered, and each JPEG encode's
    marks in a call of its own."""
    proc = _processor(w=64, h=48)
    ex = StreamingExecutor(proc, batch_size=2, jpeg_quality=90, keep_images=False,
                           device_jpeg=True)
    frames = [(f'f{i}', f.numpy()) for i, f in enumerate(_frames(64, 48, 4))]
    results = ex.run(frames)
    assert [r.error for r in results] == [None] * 4
    spans = timing.spans()
    names = [s.name for s in spans]
    for name in ('stream.flush', 'stream.drain', 'stream.jpeg_dispatch'):
        assert sorted(s.attrs['seq'] for s in spans if s.name == name) == [0, 1]
    assert names.count('stream.stack') == 2 and names.count('isp.input') == 2
    assert names.count('jpeg.result') == 4
    assert {s.parent for s in spans if s.name == 'jpeg.result'} == {'stream.drain'}
    assert {s.parent for s in spans if s.name in ('stream.stack', 'isp.input')} == {'stream.flush'}
    flush = {s.attrs['seq']: s for s in spans if s.name == 'stream.flush'}
    drain = {s.attrs['seq']: s for s in spans if s.name == 'stream.drain'}
    # each batch drains after its own flush, in feed order, on the drainer's
    # thread, with its frames' results inside it; flushes on the caller's
    assert all(flush[k].end <= drain[k].start for k in (0, 1))
    assert drain[0].end <= drain[1].start
    assert {s.thread for s in flush.values()} == {threading.get_ident()}
    (drainer,) = {s.thread for s in drain.values()}
    assert drainer != threading.get_ident()
    results_in = [[s for s in spans if s.name == 'jpeg.result' and s.thread == drainer
                   and drain[k].start <= s.start and s.end <= drain[k].end] for k in (0, 1)]
    assert [len(r) for r in results_in] == [2, 2]
    got = timing.marks()
    jpeg_calls = sorted({m.call for m in got if m.name.startswith('jpeg.')})
    assert len(jpeg_calls) == 4
    for c in jpeg_calls:
        assert [m.name for m in got if m.call == c] == ['jpeg.begin', 'jpeg.dct', 'jpeg.scan']


@pytest.mark.parametrize('pace,early', [(0.0, 0), (0.5, 2)], ids=['unpaced', 'paced'])
def test_streaming_counts_early_drains(untraced, pace, early):
    """`stream.early_drains` counts the batches whose results had all
    reached the caller when the next batch's flush began, tracer off.  A
    slow on_result stands in for the card's wait: fed at once, the next
    flush always begins first; with the feed waiting before each batch,
    every batch but the last is back before the next one's flush."""
    proc = _processor(w=64, h=48)
    ex = StreamingExecutor(proc, batch_size=2, jpeg_quality=90, keep_images=False,
                           device_jpeg=True)
    frames = [(f'f{i}', f.numpy()) for i, f in enumerate(_frames(64, 48, 6))]

    def feed():
        for i, f in enumerate(frames):
            if i % 2 == 0:
                time.sleep(pace)
            yield f

    results = ex.run(feed(), on_result=lambda r: time.sleep(0.1))
    assert [r.error for r in results] == [None] * 6
    assert timing.counters()['stream.early_drains'] == early
