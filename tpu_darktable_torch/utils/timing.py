"""Per-stage timing and profiling (counterpart of tpu_darktable/utils/timing.py).

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
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from .._graph import Graphed


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
    """Named stage timer with device fencing.

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
    one), written to `log_dir`/trace.json (chrome://tracing, Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))
