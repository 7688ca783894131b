"""The local Laplacian's mark inside the batched program and the two
per-layer metrics of the benchmark that read the stage
(isp_bench/metrics/laplacian_card_ms.stream.py and
laplacian_roofline.stream.py), on the CPU: the marks come from the CPU's
ring, so the readings here are host times, not the card's."""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tpu_darktable_torch as tt
from isp_bench import readers, spec
from tpu_darktable_torch.ops.packed import encode12_float
from tpu_darktable_torch.pipeline.config import Debayer, ImageProcessingSettings, ToneMapper
from tpu_darktable_torch.utils import timing

W, H = 128, 96
LAPLACIAN = ImageProcessingSettings(
    debayer=Debayer.rcd, postprocess=True, enable_denoise=True, enable_bilateral=True,
    enable_laplacian=True, lap_clarity=0.3, tone_mapping=ToneMapper.adaptive_aces)


def _module(name):
    """The metric file's module (its `read` and what it defines)."""
    return spec.metric_reader(name).__globals__


def _frames(n, seed=7):
    rng = np.random.default_rng(seed)
    mosaic = (rng.random((n, H, W)) * 0.8 + 0.1).astype(np.float32)
    return torch.stack([encode12_float(torch.from_numpy(m).reshape(-1)) for m in mosaic])


@pytest.fixture()
def traced_call():
    """One traced call of a batch of 2 through the Laplacian camera's
    processor on the CPU: (its marks, a ctx of that call as the harness
    builds it, with the call's output kept)."""
    timing.reset()
    timing.enable()
    try:
        proc = tt.ImageProcessor((W, H), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                                 LAPLACIAN, device='cpu')
        t0 = time.perf_counter()
        out = proc.process_batch(_frames(2))
        t1 = time.perf_counter()
        marks = timing.marks()
    finally:
        timing.disable()
        timing.reset()
    call = SimpleNamespace(t0=t0, t1=t1, n=2, out=out)
    return marks, SimpleNamespace(calls=[call], marks=marks)


def test_pyramids_mark_lies_between_bilateral_and_laplacian(traced_call):
    marks, _ = traced_call
    back = ['normalize', 'denoise', 'bilateral', 'lap.pyramids', 'laplacian']
    front = ['decode', 'demosaic', 'postprocess']
    assert [m.name for m in marks] == (['begin'] + front * 2 + ['bounds'] + back * 2
                                       + ['metrics', 'tonemap'])
    assert all(a.ns <= b.ns for a, b in zip(marks, marks[1:]))


def test_untraced_and_piecewise_calls_record_no_mark():
    timing.reset()
    proc = tt.ImageProcessor((W, H), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                             LAPLACIAN, device='cpu')
    proc.process_batch(_frames(1))
    assert timing.marks() == []
    timing.enable()
    try:
        # the stage outside a traced call: its mark is one flag check
        from tpu_darktable_torch.ops.laplacian import LaplacianParams, local_laplacian

        local_laplacian(torch.rand(H, W), LaplacianParams(clarity=0.3))
        assert timing.marks() == []
    finally:
        timing.disable()
        timing.reset()


def test_laplacian_metrics_read_the_traced_call(traced_call):
    marks, ctx = traced_call
    ns = {m.name: [] for m in marks}
    for m in marks:
        ns[m.name].append(m.ns)
    want = sum(b - a for a, b in zip(ns['bilateral'], ns['laplacian'])) * 1e-6 / 2
    card_ms = spec.metric_reader('laplacian_card_ms.stream')(ctx)
    assert card_ms == pytest.approx(want) and card_ms > 0
    share = spec.metric_reader('laplacian_roofline.stream')(ctx)
    assert share == pytest.approx(100.0 * _module('laplacian_roofline.stream')['least_ms'](W, H)
                                  / card_ms)
    assert 0.0 < share < 100.0


def test_laplacian_metrics_are_silent_without_marks(traced_call):
    _, ctx = traced_call
    for name in ('laplacian_card_ms.stream', 'laplacian_roofline.stream'):
        assert spec.metric_reader(name)(SimpleNamespace(calls=ctx.calls, marks=None)) is None


def test_laplacian_work_at_twelve_megapixels():
    """4096x3000: 11 levels, the pad 1024, level 0 6144x5048; ~10.3 G
    operations (0.154 ms at 67 TFLOP/s) against 98.3 MB (0.029 ms at
    3.35 TB/s): bound by operations."""
    m = _module('laplacian_roofline.stream')
    work = m['work'](4096, 3000)
    assert work['bytes'] == 8 * 4096 * 3000
    assert work['ops'] == pytest.approx(10.35e9, rel=0.01)
    pk = readers.peaks()
    assert m['least_ms'](4096, 3000) == pytest.approx(
        max(work['ops'] / pk['fp32_flops_per_s'], work['bytes'] / pk['hbm_bytes_per_s']) * 1e3)
    assert m['least_ms'](4096, 3000) == pytest.approx(0.1545, rel=0.01)
    # the count is of the geometry: the same either way round
    assert m['work'](3000, 4096) == work


@pytest.mark.parametrize('size', [(4096, 3000), (2472, 2062), (128, 96)])
@pytest.mark.parametrize('over', [1.0, 1.5, 400.0])
def test_laplacian_roofline_stays_at_or_below_100_at_the_least_time(size, over):
    """Read from marks that put the stage at `over` times its least time:
    the share is 100 / over, never above 100 at or above the least time."""
    m = _module('laplacian_roofline.stream')
    w, h = size
    ms = over * m['least_ms'](w, h)
    marks = [SimpleNamespace(name=name, call=1, host=0.5, ns=at * 1e6, device='cuda:0')
             for name, at in (('begin', 0.0), ('bilateral', 1.0), ('lap.pyramids', 1.0 + ms / 2),
                              ('laplacian', 1.0 + ms), ('tonemap', 2.0 + ms))]
    out = torch.zeros((1, h, w, 3), dtype=torch.uint8)
    ctx = SimpleNamespace(calls=[SimpleNamespace(t0=0.0, t1=1.0, n=1, out=out)], marks=marks)
    share = spec.metric_reader('laplacian_roofline.stream')(ctx)
    assert share == pytest.approx(100.0 / over, rel=1e-4)
    assert share <= 100.0 * (1 + 1e-4)
