"""Timing, profiling and the port's tracer (counterpart of
tpu_darktable/utils/timing.py).

Analog of the reference's opt-in CudaTimer (csrc/cuda_utils.h:40-77, used in
laplacian.cu:464-475) and the CUDA-event benchmark harness
(scripts/run_benchmark.py:16-39):

- StageTimer: named wall-clock stages with device fencing: a stage whose
  recorded output is on a card ends with torch.cuda.synchronize() of that
  card; on the CPU the wall clock alone times it.
- benchmark_op: seconds an iteration of an op chained on its own output,
  enqueued back to back and fenced once; on a card the chain is captured
  once as a CUDA graph and its replays are timed (JAX times one jitted
  lax.scan of the chain).
- trace_to: context manager around torch.profiler.

The tracer.  Off by default; `enable()` turns it on, before the program
captures the graphs it should trace.  While it is off, `span` and `mark`
return after one flag check: nothing is recorded, launched or captured.

- Host spans: `with span(name, **attrs):` records (name, thread, start and
  end on time.perf_counter, attrs, the enclosing span's name) into a
  bounded buffer, read by `spans()`.  While a torch profiler records, the
  span is also a `torch.profiler.record_function` range of its name, so it
  shows in the profile beside the device's work (`trace_to`).
- Device marks: `mark(name)` records the device's time where the program
  reaches it on the current stream.  On a card it launches a one-thread
  kernel (csrc/mark.cu) that reads the card's nanosecond clock and appends
  (time, mark id) to the card's ring; on the CPU it writes
  time.perf_counter_ns() into the CPU's ring.  Inside a CUDA graph capture
  the kernel becomes part of the graph and records on every replay.  A
  mark records only inside a traced call (`call(name, device)`, which
  marks `name` first): the batched program and the JPEG encode open one,
  so the programs that reuse their stages elsewhere (the sharded programs
  of parallel/, the piecewise workspaces) stay unmarked.  The host keeps
  its own log of the marks it enqueued, as kernels.launches counts
  launches: a capture keeps its marks in its record (_device.capturing),
  and each replay logs them with the host time of the replay and the call
  it belongs to (`replayed`).  `marks()` reads the rings back once, after
  the work: no synchronisation on the path.
- Counters: `count(name, key)`; `counters()` reads them with
  kernels.launches.

Names recorded by the port (what reads each: PERF.md, section 3):
spans `isp.input`, `graph.replay`, `graph.capture`, `stream.stack`,
`stream.flush`, `stream.jpeg_dispatch`, `stream.drain`, `jpeg.result`,
`jpeg.wait` and StageTimer's stages; marks `begin`, `decode`, `demosaic`,
`rcd.interior`, `postprocess`, `bounds`, `normalize`, `denoise`,
`bilateral`, `lap.pyramids`, `laplacian`, `metrics`, `tonemap` (the
batched program) and `jpeg.begin`, `jpeg.dct`, `jpeg.scan` (a JPEG
encode); counters `graph.captures` (by owner), `jpeg.host_fallbacks` and
`stream.early_drains`.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import NamedTuple

import torch

from .. import _device, kernels

# marks a device's ring keeps, and spans and logged marks the host keeps
CAPACITY = 1 << 20
# what a capture key gains while tracing is on (_graph.Graphed)
TRACED = ('traced',)

_on = False
# .stack: the thread's open spans; .call, .device: its traced call and the
# call's device
_local = threading.local()
_lock = threading.Lock()
_spans: deque = deque(maxlen=CAPACITY)
_log: deque = deque(maxlen=CAPACITY)     # (mark id, name, call, host s, device)
_rings: dict = {}                        # device -> _Ring, kept for good
_ids = itertools.count(1)
_calls = itertools.count(1)
_counts: dict = {'graph.captures': {}, 'jpeg.host_fallbacks': 0, 'stream.early_drains': 0}


class Span(NamedTuple):
    name: str
    thread: int
    start: float          # time.perf_counter seconds
    end: float
    attrs: dict
    parent: str | None    # the enclosing span's name in its thread


class Mark(NamedTuple):
    name: str
    call: int             # the traced call it belongs to
    host: float           # time.perf_counter seconds of its enqueue or replay
    device: torch.device
    ns: int               # the device's clock (the card's %globaltimer, or perf_counter_ns)


def tracing() -> bool:
    return _on


def enable() -> None:
    """Turn the tracer on.  Makes each card's ring (CAPACITY marks, 16
    bytes each) now, outside any capture: a captured mark writes to it on
    every replay, so a ring is never freed."""
    global _on
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            _ring(torch.device('cuda', i))
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Forget the spans and logged marks and zero the tracer's counters (the
    rings' older marks are not read back again).  kernels.launches is the
    kernels' own: kernels.reset_launches() zeroes it."""
    _spans.clear()
    _log.clear()
    with _lock:
        _counts['graph.captures'] = {}
        _counts['jpeg.host_fallbacks'] = 0
        _counts['stream.early_drains'] = 0


# ---- spans ----

class _Span:
    __slots__ = ('name', 'attrs', 'start', 'range', 'parent')

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_local, 'stack', None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        if self.range is not None:
            self.range.__exit__(*exc)
        _local.stack.pop()
        _spans.append(Span(self.name, threading.get_ident(), self.start, end, self.attrs,
                           self.parent))
        return False


_NULL = contextlib.nullcontext()


def span(name: str, **attrs):
    """Context manager: the block as a host span (see the module docstring)."""
    if not _on:
        return _NULL
    return _Span(name, attrs)


def spans() -> list[Span]:
    return list(_spans)


# ---- marks ----

class _Ring:
    """A device's marks: `data` (capacity, 2) int64 rows of (time, id) and
    `count`, the marks ever written."""

    def __init__(self, device):
        self.capacity = CAPACITY
        self.data = torch.zeros((CAPACITY, 2), dtype=torch.int64, device=device)
        self.count = torch.zeros(1, dtype=torch.int64, device=device)


def _ring(device: torch.device) -> _Ring:
    ring = _rings.get(device)
    if ring is None:
        ring = _rings[device] = _Ring(device)
    return ring


def _write_plain(ring: _Ring, mark_id: int) -> None:
    """The mark kernel's plain version, for the CPU."""
    with _lock:
        n = int(ring.count[0])
        ring.data[n % ring.capacity, 0] = time.perf_counter_ns()
        ring.data[n % ring.capacity, 1] = mark_id
        ring.count[0] = n + 1


def mark(name: str) -> None:
    """Record the device's time here (see the module docstring)."""
    if not _on:
        return
    call = getattr(_local, 'call', None)
    if call is None:
        return
    device = _local.device
    mark_id = next(_ids)
    captured = _device.current_capture()
    if captured is not None:
        # a node of the graph under capture: it records on each replay
        captured.marks.append((mark_id, name))
    else:
        _log.append((mark_id, name, call, time.perf_counter(), device))
    if device.type == 'cuda':
        # on the current stream: the capture's, inside one
        ring = _ring(device)
        kernels.launch('trace_mark', device, ring.count, ring.data, ring.capacity, mark_id)
    elif captured is None:
        _write_plain(_ring(device), mark_id)


class _Call:
    __slots__ = ('name', 'device', 'outer')

    def __init__(self, name, device):
        device = torch.device(device)
        if device.type == 'cuda' and device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
        self.name, self.device = name, device

    def __enter__(self):
        self.outer = (getattr(_local, 'call', None), getattr(_local, 'device', None))
        _local.call, _local.device = next(_calls), self.device
        mark(self.name)
        return self

    def __exit__(self, *exc):
        _local.call, _local.device = self.outer
        return False


def call(name: str, device):
    """Context manager: a traced call on `device`, opened by the mark
    `name`; the marks inside it belong to it."""
    if not _on:
        return _NULL
    return _Call(name, device)


def replayed(captured, device: torch.device) -> None:
    """Log the marks of a capture's record (_device.Capture.marks) for one
    replay on `device`, in the calling thread's traced call or a call of
    its own."""
    call_id = getattr(_local, 'call', None) or next(_calls)
    now = time.perf_counter()
    _log.extend((mark_id, name, call_id, now, device) for mark_id, name in captured)


def marks() -> list[Mark]:
    """The logged marks with the device's time of each, in the order of
    the devices' clocks.  Reads each ring back after the work enqueued
    on its device; a logged mark is matched to the newest records of its
    id in the ring (a replay logs and writes the ids of its capture)."""
    found: dict = {}
    for device, ring in _rings.items():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        n = int(ring.count[0])
        slots = torch.arange(max(0, n - ring.capacity), n) % ring.capacity
        rows = ring.data.cpu()[slots].tolist()
        for t, mark_id in rows:
            found.setdefault((device, mark_id), []).append(t)
    logged: dict = {}
    for mark_id, name, call_id, host, device in list(_log):
        logged.setdefault((device, mark_id), []).append((name, call_id, host))
    out = []
    for key, entries in logged.items():
        times = found.get(key, [])
        for (name, call_id, host), t in zip(reversed(entries), reversed(times)):
            out.append(Mark(name, call_id, host, key[0], t))
    out.sort(key=lambda m: (str(m.device), m.ns))
    return out


# ---- counters ----

def count(name: str, key: str | None = None) -> None:
    """Add one to counter `name` (under `key` for a counter by key)."""
    with _lock:
        if key is None:
            _counts[name] += 1
        else:
            _counts[name][key] = _counts[name].get(key, 0) + 1


def counters() -> dict:
    """Every counter, kernels.launches among them, as plain values."""
    with _lock:
        out = {'kernels.launches': dict(kernels.launches)}
        out.update({k: dict(v) if isinstance(v, dict) else v for k, v in _counts.items()})
    return out


# ---- timers ----

def _leaves(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _leaves(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _leaves(v)


def _fence(value):
    """Wait for the device work that produces `value` (a tensor or a tree of
    them); nothing to wait for on the CPU."""
    for x in _leaves(value):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        return


class StageTimer:
    """Named stage timer with device fencing; each stage is also a span.

    >>> timer = StageTimer()
    >>> with timer.stage('demosaic') as st:
    ...     rgb = st.record(rcd_demosaic(bayer, pattern))   # fenced on exit
    >>> timer.print_timings()

    Note: fencing serializes stages, so totals exceed the fused pipeline's
    wall clock - use for per-stage attribution, not throughput numbers.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.timings: list[tuple[str, float]] = []
        self._result = None

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield self
            return
        with span(name):
            t0 = time.perf_counter()
            yield self
            if self._result is not None:
                _fence(self._result)
                self._result = None
        self.timings.append((name, time.perf_counter() - t0))

    def record(self, value):
        """Register the stage's output for fencing (call inside the stage)."""
        self._result = value
        return value

    def print_timings(self):
        total = sum(t for _, t in self.timings)
        for name, t in self.timings:
            print(f'  {name:32s} {t * 1e3:9.2f} ms')
        print(f'  {"total":32s} {total * 1e3:9.2f} ms')

    def reset(self):
        self.timings.clear()


def benchmark_op(fn, x0, iters: int = 10, warmup: int = 2) -> float:
    """Seconds per iteration of `fn`, chained on its own output: `iters`
    calls are enqueued back to back and fenced once.  For a tensor on a
    card the chain is a CUDA graph: the first call runs it eagerly and
    captures it, each warm-up and the timed call are replays.  On the CPU
    the first call is one more eager warm-up."""
    from .._graph import Graphed

    def run(x):
        for _ in range(iters):
            x = fn(x)
        return x

    chained = Graphed(run)
    out = chained(x0)
    for _ in range(warmup):
        out = chained(x0)
    _fence(out)
    t0 = time.perf_counter()
    out = chained(x0)
    _fence(out)
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def trace_to(log_dir: str):
    """torch.profiler trace of the block (CPU, and the card where there is
    one), written to `log_dir`/trace.json (chrome://tracing, Perfetto);
    the tracer's spans show in it as ranges of their names."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


__all__ = ['CAPACITY', 'Mark', 'Span', 'StageTimer', 'benchmark_op', 'call', 'count', 'counters',
           'disable', 'enable', 'mark', 'marks', 'replayed', 'reset', 'span', 'spans', 'trace_to',
           'tracing']
