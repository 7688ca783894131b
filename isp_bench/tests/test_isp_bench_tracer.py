"""The readers of the program's tracer (isp_bench/tracer.py and the metric
files that use it) on hand-made records, chip_trace.py's traced run of
each cell on the CPU at a small size, and the benchmark's own runs, whose
traced run turns the tracer on and hands its records to the readers."""

from types import SimpleNamespace

import pytest

from isp_bench import bench, spec, tracer
from isp_bench.trace import Activity, Trace
from tpu_darktable_torch.utils import timing

SMALL = {'image_size': [128, 96]}
SEED = 2**31 + 77
CELLS = ['artichoke.stream_jpeg', 'beetroot.rig_rate', 'artichoke.batch_device']
# the per-layer metrics that read the tracer's records
TRACER_METRICS = ['demosaic_card_ms.stream', 'postprocess_card_ms.stream',
                  'denoise_card_ms.stream', 'bilateral_card_ms.stream', 'tonemap_card_ms.stream',
                  'isp_input_ms.stream', 'jpeg_entropy_card_ms.stream', 'drain_hold_ms.rig',
                  'jpeg_result_ms.rig']


def _read(name, ctx):
    return spec.metric_reader(name)(ctx)


def _m(name, call, host, ms, device='cuda:0'):
    return SimpleNamespace(name=name, call=call, host=host, ns=int(ms * 1e6), device=device)


def _s(name, start, end, thread=1, parent=None, **attrs):
    return SimpleNamespace(name=name, thread=thread, start=start, end=end, attrs=attrs,
                           parent=parent)


def _program_call(call, host, t0):
    """One call of 2 frames: ms from the call's start at each mark."""
    at = {'begin': 0, 'decode': 1, 'demosaic': 9, 'postprocess': 12,
          'decode#': 13, 'demosaic#': 21, 'postprocess#': 24, 'bounds': 25,
          'normalize': 26, 'denoise': 46, 'bilateral': 53,
          'normalize#': 54, 'denoise#': 74, 'bilateral#': 81, 'metrics': 82, 'tonemap': 92}
    return [_m(k.rstrip('#'), call, host, t0 + v) for k, v in at.items()]


def _jpeg_call(call, host, t0):
    return [_m('jpeg.begin', call, host, t0), _m('jpeg.dct', call, host, t0 + 10),
            _m('jpeg.scan', call, host, t0 + 70)]


def _ctx():
    """Two window calls (hosts 10.0 and 11.0) and one outside the window
    (12.0), each with its two frames' JPEG encodes dispatched after it."""
    calls = [SimpleNamespace(index=0, t0=9.9, t1=10.1, n=2, first_frame=0),
             SimpleNamespace(index=1, t0=10.9, t1=11.1, n=2, first_frame=2)]
    marks = []
    for k, host in enumerate((10.0, 11.0, 12.0)):
        marks += _program_call(10 * k + 1, host, 1000 * k)
        marks += _jpeg_call(10 * k + 2, host + 0.15, 1000 * k + 100)
        marks += _jpeg_call(10 * k + 3, host + 0.16, 1000 * k + 200)
    spans = [_s('isp.input', 9.95, 9.953), _s('isp.input', 10.95, 10.955),
             _s('isp.input', 11.95, 11.999),
             _s('stream.flush', 9.9, 10.2, seq=0), _s('stream.flush', 10.9, 11.2, seq=1),
             _s('stream.drain', 11.3, 11.5, seq=0), _s('stream.drain', 12.3, 12.5, seq=1),
             _s('jpeg.result', 11.31, 11.33, parent='stream.drain'),
             _s('jpeg.result', 11.35, 11.36, parent='stream.drain'),
             _s('jpeg.result', 12.31, 12.35, parent='stream.drain'),
             _s('jpeg.result', 12.36, 12.38, parent='stream.drain'),
             _s('jpeg.result', 12.36, 12.38, thread=2)]              # another thread's
    frames = [SimpleNamespace(take=take, due=take - 0.01, done=done)
              for take, done in ((9.89, 11.4), (9.89, 11.45), (10.89, 12.4), (10.89, 12.5))]
    return SimpleNamespace(calls=calls, marks=marks, spans=spans, frames=frames, trace=None,
                           window=(9.8, 11.5))


def test_isp_stages_per_frame_from_the_marks():
    ctx = _ctx()
    calls, frames = tracer.isp_calls(ctx)
    assert len(calls) == 2 and frames == 4
    assert _read('demosaic_card_ms.stream', ctx) == pytest.approx(8.0)
    assert _read('postprocess_card_ms.stream', ctx) == pytest.approx(3.0)
    assert _read('denoise_card_ms.stream', ctx) == pytest.approx(20.0)
    assert _read('bilateral_card_ms.stream', ctx) == pytest.approx(7.0)
    # from the last frame's bilateral mark: the sampling, the metrics EMA, the tonemap
    assert _read('tonemap_card_ms.stream', ctx) == pytest.approx(11.0 / 2)


def test_a_stage_between_its_marks_skips_marks_inside_it():
    # RCD's interior mark between decode and demosaic leaves the demosaic reading whole
    ms = [_m('decode', 1, 0, 1), _m('rcd.interior', 1, 0, 1.5), _m('demosaic', 1, 0, 9)]
    assert tracer.stage_ms([ms], ('decode',), 'demosaic') == pytest.approx(8.0)
    assert tracer.stage_ms([ms], ('decode',), 'postprocess') is None


def test_laplacian_closes_the_back_when_it_runs():
    ms = [_m('bilateral', 1, 0, 1), _m('laplacian', 1, 0, 5), _m('metrics', 1, 0, 6),
          _m('tonemap', 1, 0, 9)]
    assert tracer.stage_ms([ms], ('bilateral', 'laplacian'), 'tonemap') == pytest.approx(4.0)
    # a stage's reader is made from its marks, as a metric file makes it
    marks = [_m(name, 1, 0.5, at) for name, at in (('begin', 0), ('bilateral', 1), ('laplacian', 5),
                                                    ('metrics', 6), ('tonemap', 9))]
    ctx = SimpleNamespace(calls=[SimpleNamespace(t0=0, t1=1, n=1)], marks=marks)
    assert tracer.isp_stage(('bilateral',), 'laplacian')(ctx) == pytest.approx(4.0)
    assert _read('tonemap_card_ms.stream', ctx) == pytest.approx(4.0)


def test_jpeg_entropy_of_the_window_calls_frames():
    ctx = _ctx()
    calls, frames = tracer.jpeg_calls(ctx)
    assert len(calls) == 4 and frames == 4            # not the third call's encodes
    assert _read('jpeg_entropy_card_ms.stream', ctx) == pytest.approx(60.0)


def test_mark_table_attributes_each_gap_to_the_mark_that_closes_it():
    t = tracer.mark_table(_ctx())
    assert t['isp']['demosaic'] == pytest.approx(8.0)
    assert t['isp']['decode'] == pytest.approx((1 + 1) / 2)
    assert t['isp']['all'] == pytest.approx(92.0 / 2)
    assert sum(v for k, v in t['isp'].items() if k != 'all') == pytest.approx(t['isp']['all'])
    assert t['jpeg'] == pytest.approx({'jpeg.dct': 10.0, 'jpeg.scan': 60.0, 'all': 70.0})


def test_host_spans_per_frame_and_the_hold():
    ctx = _ctx()
    assert _read('isp_input_ms.stream', ctx) == pytest.approx((3 + 5) / 4)
    assert _read('drain_hold_ms.rig', ctx) == pytest.approx(1100.0)
    # the results inside the window batches' drains, in the drains' thread
    assert _read('jpeg_result_ms.rig', ctx) == pytest.approx((20 + 10 + 40 + 20) / 4)
    lag_flush_hold = [10 + 300 + 1100, 10 + 300 + 1100]
    sums = [lag_flush_hold[0] + 30, lag_flush_hold[1] + 60]
    assert tracer.tail_parts(ctx) == pytest.approx(((sums[0] + sums[1]) / 2, (1570 + 1620) / 2))


def test_readers_are_silent_without_the_tracer():
    for ctx in (SimpleNamespace(calls=_ctx().calls, frames=[], trace=None, window=(0, 1)),
                SimpleNamespace(calls=_ctx().calls, frames=[], trace=None, window=(0, 1),
                                marks=None, spans=None)):
        assert all(_read(name, ctx) is None for name in TRACER_METRICS)
    ctx = SimpleNamespace(calls=_ctx().calls, frames=[], trace=None, window=(0, 1))
    assert tracer.mark_table(ctx) is None and tracer.tail_parts(ctx) is None
    assert tracer.stage_ops(ctx) is None


def test_stage_ops_match_the_slice_to_the_marks_by_their_gaps():
    """The slice holds the marks of the second call only, on the
    profiler's clock; its ops go to the mark that closes their gap."""
    ctx = _ctx()
    second = [m for m in ctx.marks if m.call == 11]
    base = 5e6                                     # us: the profiler's clock
    acts = []
    for m in second:
        t = base + (m.ns - second[0].ns) * 1e-3
        acts.append(Activity('trace_mark_write(unsigned long long*)', 0, t, t + 2))
    acts.append(Activity('cat_copy', 0, base + 2000, base + 7000))        # in demosaic
    acts.append(Activity('wiener', 0, base + 30000, base + 45000))        # in denoise
    acts.append(Activity('clone', 0, base + 93000, base + 94000))         # after the call
    ctx.trace = Trace(device=acts, window=(base - 1, base + 1e5))
    ops = tracer.stage_ops(ctx)                    # ms a frame: the slice holds two
    assert ops['demosaic'] == [('cat_copy', pytest.approx(2.5))]
    assert ops['denoise'] == [('wiener', pytest.approx(7.5))]
    assert ops['outside the marks'] == [('clone', pytest.approx(0.5))]


def test_span_table_counts_the_window_spans_per_frame():
    t = tracer.span_table(_ctx())                  # window (9.8, 11.5), four frames
    assert t['isp.input'] == (2, pytest.approx(8 / 4), pytest.approx(4.0))
    assert t['stream.flush'] == (2, pytest.approx(600 / 4), pytest.approx(300.0))
    assert t['stream.drain'] == (1, pytest.approx(200 / 4), pytest.approx(200.0))
    assert 'jpeg.result' in t and tracer.span_table(SimpleNamespace(frames=[])) is None


@pytest.mark.parametrize('cell', CELLS)
def test_traced_run_of_each_cell_reads_the_tracer(cell):
    """chip_trace.py's run at 128x96 on the CPU: correct, every reading of
    the cell's layers present and positive, the marks' whole calls beside
    the stages, and the tracer off again after."""
    import chip_trace

    r = chip_trace.traced_run(cell, SEED, 1.5, devices=['cpu'], camera_override=SMALL)
    assert r['correct'] is True
    got = r['tracer']['readings']
    want = {'demosaic_card_ms', 'postprocess_card_ms', 'denoise_card_ms', 'bilateral_card_ms',
            'tonemap_card_ms', 'isp_input_ms'}
    if cell == 'artichoke.stream_jpeg':
        want |= {'jpeg_entropy_card_ms'}
    if cell == 'beetroot.rig_rate':
        want |= {'drain_hold_ms', 'jpeg_result_ms'}
        parts, slowest = r['tracer']['tail_parts']
        assert parts == pytest.approx(slowest, rel=0.05)
    assert want <= set(got) and all(v > 0 for v in got.values())
    table = r['tracer']['mark_table']['isp']
    stages = sum(v for k, v in table.items() if k != 'all')
    assert stages == pytest.approx(table['all'])
    assert not timing.tracing()


def test_the_metric_files_are_the_tracer_readings():
    """Each tracer metric of BENCHMARK.json is one file in metrics/ whose
    reader the tracer made, in the cells of PERF.md's table; READINGS
    (what chip_trace.py reads) is worked out from those files."""
    entries = {m['name']: m for m in spec.benchmark()['per_layer']}
    assert set(TRACER_METRICS) <= set(entries)
    assert set(tracer.READINGS) == set(TRACER_METRICS)
    for name in TRACER_METRICS:
        m = entries[name]
        assert m['source'] == 'program_span' and m['unit'] == 'ms' and m['better'] == 'lower'
        assert (spec.HERE / 'metrics' / f'{name}.py').is_file()
        if name.endswith('.rig'):
            want = ['beetroot.rig_rate']
        elif name.startswith('jpeg_'):
            want = ['artichoke.stream_jpeg']
        else:
            want = ['artichoke.stream_jpeg', 'artichoke.batch_device']
        assert m['workloads'] == want, name


@pytest.mark.parametrize('traced', [False, True], ids=['untraced', 'traced'])
def test_the_benchmark_leaves_the_tracer_off(traced):
    """isp_bench/run.py's untraced runs take the program's path with the
    tracer off: no span or mark is recorded.  A traced run turns it on for
    its set-up, window and slice, and off again before it returns."""
    timing.reset()
    r = bench.run('artichoke.batch_device', SEED, 1.0, traced, devices=['cpu'],
                  camera_override=SMALL)
    assert r['correct'] is True
    assert not timing.tracing()
    if traced:
        assert timing.spans() and timing.marks()
    else:
        assert timing.spans() == [] and timing.marks() == []


@pytest.mark.parametrize('cell', CELLS)
def test_traced_run_hands_the_tracer_records_to_the_context(cell, monkeypatch):
    """A traced bench.run hands the tracer's marks and spans to the
    readers' context, and its result line holds each tracer metric of the
    cell; an untraced run's context has neither."""
    seen = []
    real = bench._context

    def context(*args):
        seen.append(real(*args))
        return seen[-1]
    monkeypatch.setattr(bench, '_context', context)
    r = bench.run(cell, SEED, 1.5, True, devices=['cpu'], camera_override=SMALL)
    assert r['correct'] is True
    ctx = seen[-1]
    assert ctx.marks and ctx.spans
    assert {m.name for m in ctx.marks} >= {'begin', 'decode', 'demosaic', 'tonemap'}
    want = [m['name'] for m in spec.metrics_of(cell, 'per_layer') if m['name'] in TRACER_METRICS]
    assert want and all(r['metrics'][name]['value'] > 0 for name in want), r['metrics']
    bench.run(cell, SEED, 1.0, False, devices=['cpu'], camera_override=SMALL)
    assert seen[-1].marks is None and seen[-1].spans is None


def test_chip_trace_needs_a_card(monkeypatch, capsys):
    """Without a card chip_trace.py exits 2 and prints no table: its
    tables are card times."""
    import chip_trace
    import torch
    from isp_bench import env

    monkeypatch.setattr(env, 'setup', lambda: env.CHECKOUT)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert chip_trace.main(['--workload', CELLS[0], '--seed', str(SEED), '--seconds', '1']) == 2
    out, err = capsys.readouterr()
    assert out == '' and 'is_available() is False' in err


@pytest.mark.parametrize('owner,name', [('bench', '_context'), ('drive.Slice', 'start'),
                                        ('drive', '_open_window')])
def test_chip_trace_fails_when_a_wrapped_name_changes(monkeypatch, owner, name):
    """traced_run raises before it runs anything if a harness name it
    wraps is gone or takes other parameters."""
    import chip_trace
    from isp_bench import drive

    target = {'bench': bench, 'drive': drive, 'drive.Slice': drive.Slice}[owner]
    monkeypatch.setattr(target, name, lambda *args, extra=None: None)
    with pytest.raises(RuntimeError, match=name):
        chip_trace.traced_run(CELLS[0], SEED, 1.0, devices=['cpu'], camera_override=SMALL)
    monkeypatch.delattr(target, name)
    with pytest.raises(RuntimeError, match='is None'):
        chip_trace.traced_run(CELLS[0], SEED, 1.0, devices=['cpu'], camera_override=SMALL)
    assert not timing.tracing()
