"""The harness's arithmetic against hand-computed cases: the open loop's
schedule and feed lag, the traced slice after the window, percentiles over
all frames, the interval union, the idle share and its gaps, the roofline
from shapes, the card spans per frame."""

import random
from types import SimpleNamespace

import numpy as np
import pytest

from isp_bench import drive, readers, stats, trace
from isp_bench.trace import Activity, HostRange, Trace


class _Result:
    def __init__(self, name):
        self.name, self.error, self.jpeg = name, None, b''


class _Executor:
    """Takes frames as StreamingExecutor.run does: a batch at a time, then
    `busy` seconds of work before it takes the next frame."""

    def __init__(self, batch, busy):
        self.batch, self.busy = batch, busy

    def run(self, frames, on_result):
        pending = []
        for name, _ in frames:
            pending.append(name)
            if len(pending) == self.batch:
                drive.time.sleep(self.busy)
                for n in pending:
                    on_result(_Result(n))
                pending = []
        for n in pending:
            on_result(_Result(n))


def _recorder():
    return drive.Recorder(keep=1, rng=random.Random(0))


def test_open_loop_due_times_follow_the_rate():
    rec = _recorder()
    pool = np.zeros((8, 3), np.uint8)
    drive.stream(_Executor(4, 0.0), rec, pool, ['a', 'b', 'c', 'd'], 4, seconds=0.35, rate=10.0)
    t0, _ = rec.window
    assert len(rec.take) == 16                     # captures due at 0, .1, .2, .3 s
    for i, due in enumerate(rec.due):
        assert due == pytest.approx(t0 + (i // 4) * 0.1)
    lags = [(rec.take[i] - rec.due[i]) for i in range(0, 16, 4)]
    assert all(0 <= lag < 0.02 for lag in lags)   # a sustained rate: the feed is on time


def test_feed_lag_grows_when_the_entry_falls_behind():
    rec = _recorder()
    pool = np.zeros((8, 3), np.uint8)
    drive.stream(_Executor(2, 0.05), rec, pool, ['a', 'b'], 2, seconds=0.5, rate=40.0)
    firsts = range(0, len(rec.take), 2)
    lags = [rec.take[i] - rec.due[i] for i in firsts]
    assert lags[-1] > lags[1] + 0.1                 # 25 ms apart, 50 ms of work each
    ctx = SimpleNamespace(frames=[SimpleNamespace(take=rec.take[i], due=rec.due[i])
                                  for i in range(len(rec.take))])
    assert readers.feed_lag_ms(ctx) == pytest.approx(
        stats.median([(rec.take[i] - rec.due[i]) * 1e3 for i in range(len(rec.take))]))


def test_closed_loop_window_ends_on_a_whole_batch_and_is_due_when_taken():
    rec = _recorder()
    pool = np.zeros((4, 3), np.uint8)
    drive.stream(_Executor(2, 0.01), rec, pool, ['a', 'b'], 2, seconds=0.1)
    assert len(rec.take) % 2 == 0 and rec.take == rec.due
    assert len(rec.done) == len(rec.take)
    assert rec.pool_idx == [i % 4 for i in range(len(rec.take))]


def test_percentile_is_over_all_frames_not_chunk_medians():
    lat = list(range(1, 101))
    assert stats.percentile(lat, 95) == pytest.approx(np.percentile(lat, 95))
    assert stats.percentile(lat, 50) == pytest.approx(50.5)
    # one slow chunk: the tail sees it, a median of chunk medians would not
    chunks = [[10.0] * 19 + [10.0]] * 4 + [[500.0] * 20]
    flat = [x for c in chunks for x in c]
    assert stats.percentile(flat, 95) == 500.0
    assert stats.median([stats.median(c) for c in chunks]) == 10.0


def test_union_counts_overlapping_work_once():
    assert trace.union([(0, 10), (5, 15), (20, 30), (30, 31)]) == [(0, 15), (20, 31)]
    assert trace.busy_us([(0, 10), (5, 15), (2, 3)]) == 15
    assert trace.idle_gaps([(2, 4), (3, 6), (8, 9)], (0, 10)) == [(0, 2), (6, 8), (9, 10)]


def _trace():
    # one card: a 40 us ISP graph, then two JPEG kernels (one overlapping
    # the other), in a 100 us slice; a second card busy half of it
    tr = Trace(window=(0.0, 100.0))
    tr.device = [Activity('rcd_interior_kernel<true>(float const*)', 0, 10, 30),
                 Activity('elementwise', 0, 30, 50),
                 Activity('jpeg_scan', 0, 60, 80),
                 Activity('jpeg_dct', 0, 70, 90),
                 Activity('elementwise', 1, 0, 50)]
    tr.ranges = [HostRange(trace.ISP_RANGE, 7, 0.0, 9.0), HostRange('feed', 7, 50.0, 58.0),
                 HostRange(trace.SLICE_RANGE, 7, 0.0, 100.0)]
    return tr


def test_idle_share_and_gaps_by_hand():
    tr = _trace()
    # card 0 busy 10-50 and 60-90: 70 of 100 us
    assert trace.idle_share(tr, 0) == pytest.approx(0.3)
    assert trace.idle_share(tr, 1) == pytest.approx(0.5)
    ctx = SimpleNamespace(trace=tr, chips=2)
    assert readers.device_idle_pct(ctx) == pytest.approx(30.0)
    assert readers.device_idle_pct(ctx, devices=(0, 1)) == pytest.approx(40.0)
    b = trace.breakdown(tr, 0)
    assert {n: round(t * 1e6) for n, t in b['device_ops']} == {
        'rcd_interior_kernel<true>(float const*)': 20, 'elementwise': 20, 'jpeg_scan': 20,
        'jpeg_dct': 20}
    assert [g[0] for g in b['idle_gaps']] == [trace.ISP_RANGE, 'feed',
                                              'outside the harness ranges']
    assert [round(g[1] * 1e6) for g in b['idle_gaps']] == [10, 10, 10]


def test_frames_per_s_runs_to_the_last_result_in_the_window():
    # 8 frames done in the window, the last 2 s after its start; one not done
    frames = [SimpleNamespace(done=0.25 * (k + 1)) for k in range(8)] + [SimpleNamespace(done=None)]
    ctx = SimpleNamespace(frames=frames, window=(0.0, 3.0))
    assert readers.frames_per_s(ctx) == pytest.approx(4.0)


def test_roofline_from_shapes():
    tr = _trace()
    work = {'rcd_interior_kernel': {'bytes_per_pixel': 16, 'ops_per_pixel': 200}}
    px = 1000
    ctx = SimpleNamespace(trace=tr, work=work, pixels=px)
    least = max(16 * px / 3.35e12, 200 * px / 67e12) * 1e3          # ms
    assert readers.roofline_pct(ctx) == pytest.approx(100 * least / 20e-3)
    ctx.work = {'nothing_here': work['rcd_interior_kernel']}
    assert readers.roofline_pct(ctx) is None                         # silent, never 0


def test_isp_and_jpeg_card_ms_are_spans_summed_per_frame():
    calls = [SimpleNamespace(n=2, card_ms=100.0, jpeg_ms=150.0),
             SimpleNamespace(n=2, card_ms=140.0, jpeg_ms=130.0),
             SimpleNamespace(n=2, card_ms=None, jpeg_ms=None)]      # no events: left out
    ctx = SimpleNamespace(calls=calls)
    assert readers.isp_card_ms(ctx) == pytest.approx(60.0)
    assert readers.jpeg_card_ms(ctx) == pytest.approx(70.0)
    assert readers.isp_card_ms(SimpleNamespace(calls=[])) is None
    assert readers.jpeg_card_ms(SimpleNamespace(calls=calls[2:])) is None    # silent, never 0


class _Profiler:
    def __init__(self):
        self.log = []

    def start(self):
        self.log.append(('start', drive.clock()))

    def step(self):
        self.log.append(('step', drive.clock()))

    def stop(self):
        self.log.append(('stop', drive.clock()))


@pytest.mark.parametrize('rate', [None, 20.0], ids=['closed', 'open'])
def test_traced_slice_comes_after_the_window(rate):
    rec = _recorder()
    prof = _Profiler()
    tslice = drive.Slice(0.04, 0.08, prof)
    pool = np.zeros((4, 3), np.uint8)
    drive.stream(_Executor(2, 0.01), rec, pool, ['a', 'b'], 2, seconds=0.2, rate=rate,
                 tslice=tslice)
    t0, t1 = rec.window
    (_, started), (_, recorded), (_, stopped) = [e for e in prof.log]
    assert [e[0] for e in prof.log] == ['start', 'step', 'stop']
    assert started >= t1 - 0.01                       # the window is not profiled
    # the load settles first; an open loop's settling and slice take whole
    # capture periods (50 ms), a closed loop's take the seconds given
    settle, seconds = (0.04, 0.08) if rate is None else (0.05, 0.1)
    assert tslice.record_at - started == pytest.approx(settle, abs=0.005)
    assert tslice.end_at - tslice.record_at == pytest.approx(seconds)
    assert recorded >= tslice.record_at
    assert stopped >= tslice.end_at
    if rate is not None:
        assert recorded - tslice.record_at < 0.02     # the slice opens as a capture is due
    after = [t for t in rec.take if t >= started]
    assert after and len(rec.done) == len(rec.take)   # the load goes on through the slice
    if rate is not None:                              # its schedule starts anew
        assert min(rec.due[len(rec.take) - len(after):]) >= started


def test_traced_slice_after_a_batch_window():
    rec = _recorder()
    prof = _Profiler()
    proxy = SimpleNamespace(process_batch=lambda b: drive.time.sleep(0.01), device='cpu')
    pool = np.zeros((4, 3), np.uint8)
    drive.batches(proxy, rec, pool, 2, seconds=0.1, tslice=drive.Slice(0.03, 0.05, prof))
    assert [e[0] for e in prof.log] == ['start', 'step', 'stop']
    assert prof.log[0][1] >= rec.window[1] - 0.02
    assert any(t >= prof.log[1][1] for t in rec.take)


def test_parse_chrome_events():
    events = [
        {'ph': 'X', 'cat': 'kernel', 'name': 'k', 'ts': 10, 'dur': 5,
         'args': {'device': 1, 'correlation': 9}},
        {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaGraphLaunch', 'ts': 8, 'dur': 1,
         'tid': 3, 'args': {'correlation': 9}},                     # host calls: not read
        {'ph': 'X', 'cat': 'user_annotation', 'name': trace.SLICE_RANGE, 'ts': 0, 'dur': 50,
         'tid': 3},
        {'ph': 'i', 'cat': 'kernel', 'name': 'ignored'},
    ]
    tr = trace.parse_chrome(events)
    assert tr.window == (0.0, 50.0)
    assert tr.device == [Activity('k', 1, 10.0, 15.0, 'kernel')]
    assert [r.name for r in tr.ranges] == [trace.SLICE_RANGE]
