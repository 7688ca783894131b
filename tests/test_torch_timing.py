"""utils/timing of the port on the CPU: the stage timer and the chained
benchmark protocol (the cases of tests/test_timing.py)."""

import numpy as np
import torch

from tpu_darktable_torch.utils import StageTimer, benchmark_op, trace_to


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
