"""The load: the harness's proxy around the processor, and the loops that
feed the entry points for a warm-up count or a measured window.

Every `process_batch` call goes through `Proxy`, which stamps it (host
clock and CUDA events around it, inside the `isp_bench.process_batch`
range; `JpegProxy` adds an event after the JPEG launches of its frames),
keeps references to the EMA state before and after it, and keeps
the uint8 output of a sample of the calls, drawn from the seed by
reservoir sampling, for the comparison with the reference.  The loops
stamp each frame when the entry takes it and when its result reaches the
caller; an open loop also knows when each frame was due.
"""

from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .trace import ISP_RANGE, SLICE_RANGE, WAIT_RANGE

clock = time.perf_counter
# seconds of load between the profiler's start and the traced slice: the
# entry catches up with the start's stall (an open loop starts anew)
SETTLE_S = 2.0


@dataclass
class Call:
    """One process_batch call."""

    index: int
    first_frame: int              # global index of its first frame
    n: int
    pool_idx: list
    t0: float
    t1: float
    events: tuple | None
    bounds_in: object
    metrics_in: object
    bounds_out: object
    metrics_out: object
    in_window: bool
    out: object = None            # uint8 output, kept for sampled calls
    jpeg_end: object = None       # CUDA event after the last JPEG launch of its frames
    card_ms: float | None = None  # the card's span of the call, read after the window
    jpeg_ms: float | None = None  # the card's span of its frames' JPEG stages, likewise


@dataclass
class Recorder:
    """What a run saw: its calls, and each frame's stamps (seconds, host
    clock), pool index, and, for frames of sampled calls, its JPEG bytes."""

    keep: int                     # window calls to keep for the comparison
    rng: random.Random
    calls: list = field(default_factory=list)
    pool_idx: list = field(default_factory=list)     # per fed frame
    take: list = field(default_factory=list)         # per fed frame
    due: list = field(default_factory=list)          # per fed frame
    done: list = field(default_factory=list)         # per result, in order
    errors: int = 0
    jpeg: dict = field(default_factory=dict)         # frame index -> bytes
    sampled: list = field(default_factory=list)      # indices of kept window calls
    seen_in_window: int = 0
    in_window: bool = False
    window: tuple = (0.0, 0.0)

    def sample(self, call: Call) -> bool:
        """Reservoir sampling over the window's calls; the first call of
        the run (from the zero state) is always kept."""
        if call.index == 0:
            return True
        if not call.in_window:
            return False
        self.seen_in_window += 1
        if len(self.sampled) < self.keep:
            self.sampled.append(call.index)
            return True
        j = self.rng.randrange(self.seen_in_window)
        if j < self.keep:
            old = self.sampled[j]
            self.calls[old].out = None
            self.sampled[j] = call.index
            return True
        return False

    def kept_calls(self) -> list[Call]:
        return [c for c in self.calls if c.out is not None]

    def call_of_frame(self, i: int) -> Call | None:
        for c in self.calls:
            if c.first_frame <= i < c.first_frame + c.n:
                return c
        return None


def _events():
    if not torch.cuda.is_available():
        return None
    return (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))


class Proxy:
    """Wraps the processor handed to the entry; every attribute but
    process_batch passes through."""

    def __init__(self, processor, rec: Recorder, on_card: bool):
        self._proc = processor
        self._rec = rec
        self._on_card = on_card

    def __getattr__(self, name):
        return getattr(self._proc, name)

    def process_batch(self, batch):
        rec, proc = self._rec, self._proc
        n = int(batch.shape[0]) if getattr(batch, 'ndim', 1) > 1 else 1
        first = sum(c.n for c in rec.calls)
        with torch.profiler.record_function(ISP_RANGE):
            ev = _events() if self._on_card else None
            b_in, m_in = proc.bounds, proc.metrics
            t0 = clock()
            if ev:
                ev[0].record()
            out = proc.process_batch(batch)
            if ev:
                ev[1].record()
            t1 = clock()
        call = Call(len(rec.calls), first, n, rec.pool_idx[first:first + n], t0, t1, ev,
                    b_in, m_in, proc.bounds, proc.metrics, rec.in_window)
        rec.calls.append(call)
        if rec.sample(call):
            call.out = out
        return out


class JpegProxy:
    """Wraps the executor's JPEG encoder; every attribute but encode_async
    passes through.  After each encode_async it records the latest call's
    `jpeg_end` event on the card's stream, so that the card's span from
    the call's end event to it holds its frames' JPEG stages (and their
    orientation transforms, launched between the two)."""

    def __init__(self, jpeg, rec: Recorder):
        self._jpeg = jpeg
        self._rec = rec

    def __getattr__(self, name):
        return getattr(self._jpeg, name)

    def encode_async(self, *args, **kwargs):
        handle = self._jpeg.encode_async(*args, **kwargs)
        call = self._rec.calls[-1] if self._rec.calls else None
        if call is not None and call.events:
            if call.jpeg_end is None:
                call.jpeg_end = torch.cuda.Event(enable_timing=True)
            call.jpeg_end.record()
        return handle


class Slice:
    """The traced slice, after the window, so that no reading of the window
    comes from a profiled program: the profiler starts (CUPTI's start-up,
    seconds long) when the window has closed, the load goes on for `settle`
    seconds, then `seconds` are recorded inside the `isp_bench.slice`
    range.  The trace is written once the entry has returned."""

    def __init__(self, settle: float, seconds: float, profiler):
        self.settle = settle
        self.seconds = seconds
        self.prof = profiler
        self.record_at = float('inf')
        self.up_s = 0.0               # how long the profiler took to start
        self.range = None

    def start(self, period: float | None = None) -> float:
        """Start the profiler (its warm-up step); returns when it is up.
        With an open loop's `period`, the settling and the slice take whole
        periods, so the slice starts as a capture is due and its idle share
        does not depend on where the captures fall in it."""
        t = clock()
        self.prof.start()
        self.up_s = clock() - t
        if period is not None:
            self.settle = math.ceil(self.settle / period) * period
            self.seconds = math.ceil(self.seconds / period) * period
        self.record_at = t + self.up_s + self.settle
        return t + self.up_s

    @property
    def end_at(self) -> float:
        return self.record_at + self.seconds

    def poll(self, now: float):
        if self.range is None and now >= self.record_at:
            self.prof.step()                  # record
            self.range = torch.profiler.record_function(SLICE_RANGE)
            self.range.__enter__()

    def close(self):
        if self.range is not None:
            self.range.__exit__(None, None, None)

    def stop(self):
        self.prof.stop()                      # the trace is written here


def _open_window(rec: Recorder, seconds):
    t_start = clock()
    rec.in_window = seconds is not None
    if rec.in_window:
        rec.window = (t_start, t_start + seconds)
    return t_start, (t_start + seconds if seconds is not None else None)


def stream(executor, rec: Recorder, pool: np.ndarray, names, batch: int, *, seconds=None,
           count=None, rate=None, tslice: Slice | None = None, check_jpeg=True):
    """Feed StreamingExecutor.run: for `count` frames at once (warm-up), or
    for `seconds` (the window), at once (closed loop) or with each batch of
    `batch` frames due at `rate` batches a second (open loop, all frames of
    a capture due together).  A window ends on a whole batch.  With
    `tslice`, the same load goes on after the window for the traced slice,
    its schedule started anew once the profiler is up."""
    n_pool = len(pool)
    t_start, t_end = _open_window(rec, seconds)

    def schedule(t0, t_stop, n_max, on_take=None):
        i = 0
        while True:
            g = len(rec.take)
            due = None
            if n_max is not None and i >= n_max:
                return
            if t_stop is not None and rate is not None:
                due = t0 + (i // batch) / rate
            if i % batch == 0 and t_stop is not None:
                if due is not None:
                    if due >= t_stop:
                        return
                    wait = due - clock()
                    if wait > 0:
                        with torch.profiler.record_function(WAIT_RANGE):
                            time.sleep(wait)
                elif clock() >= t_stop:
                    return
            now = clock()
            if on_take is not None:
                on_take(now)
            rec.take.append(now)
            rec.due.append(now if due is None else due)
            rec.pool_idx.append(g % n_pool)
            yield names[g % len(names)], pool[g % n_pool]
            i += 1

    def wait_until(t):
        # an open loop's schedule ends before its time is up
        if t - clock() > 0:
            with torch.profiler.record_function(WAIT_RANGE):
                time.sleep(t - clock())

    def feed():
        yield from schedule(t_start, t_end, count)
        rec.in_window = False
        if tslice is not None:
            wait_until(t_end)
            t0 = tslice.start(None if rate is None else 1.0 / rate)
            yield from schedule(t0, tslice.end_at, None, tslice.poll)
            wait_until(tslice.end_at)
            tslice.close()

    def on_result(r):
        # device-JPEG results come in the order the frames were fed
        rec.done.append(clock())
        idx = len(rec.done) - 1
        if r.error is not None:
            rec.errors += 1
            return
        call = rec.call_of_frame(idx) if check_jpeg else None
        if call is not None and call.out is not None:
            rec.jpeg[idx] = r.jpeg

    executor.run(feed(), on_result=on_result)
    rec.in_window = False
    if tslice is not None:
        tslice.stop()


def batches(proxy, rec: Recorder, pool: np.ndarray, batch: int, *, seconds=None, count=None,
            tslice: Slice | None = None):
    """Closed loop of process_batch calls on host batches of `batch` frames
    (pool frames in order), each followed by a synchronize: the consumer
    reads its frames on the card.  With `tslice`, the same load goes on
    after the window for the traced slice."""
    n_pool = len(pool)
    groups = pool.reshape(n_pool // batch, batch, -1)
    t_start, t_end = _open_window(rec, seconds)

    def one_batch(now):
        first = len(rec.take)
        for j in range(batch):
            rec.take.append(now)
            rec.due.append(now)
            rec.pool_idx.append((first + j) % n_pool)
        proxy.process_batch(groups[(first // batch) % len(groups)])
        if torch.cuda.is_available():
            torch.cuda.synchronize(proxy.device)
        rec.done.extend([clock()] * batch)

    k = 0
    while (count is not None and k < count) or (t_end is not None and clock() < t_end):
        one_batch(clock())
        k += 1
    rec.in_window = False
    if tslice is not None:
        tslice.start()
        while (now := clock()) < tslice.end_at:
            tslice.poll(now)
            one_batch(now)
        tslice.close()
        tslice.stop()


__all__ = ['SETTLE_S', 'Call', 'JpegProxy', 'Proxy', 'Recorder', 'Slice', 'batches', 'clock', 'stream']
