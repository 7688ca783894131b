"""The compiled program of the batched entry point (tpu_darktable_torch/
_graph.py) on the CPU: after its first call the batched program copies no
host value to its device (a CUDA graph would replay such a copy from a
host buffer that may have been reused), the capture key, the launch
accounting of capture and replay with a stand-in for the CUDA graph, the
device caches' report to a capture, and that a processor on the CPU runs
its program eagerly without touching torch.cuda.  The card's own checks of
the graphs are in tests/test_torch_cuda.py.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

import tpu_darktable_torch as tt
from tpu_darktable_torch import _device, _graph, kernels
from tpu_darktable_torch.ops.packed import encode12_float
from tpu_darktable_torch.pipeline.config import Debayer, ImageProcessingSettings, ToneMapper

torch.set_num_threads(1)
WB = (1.2, 1.0, 1.1)

# FULL (bench.py's graded configuration) and the settings that change which
# ops the batched program runs: the Laplacian, the other two debayers, the
# other four tonemaps, the general bilateral path (sigma_s 3) and the
# float32 Wiener tile core (denoise_f16 off).
SETTINGS_CASES = {
    'full': {},
    'laplacian': dict(enable_laplacian=True, lap_clarity=0.3),
    'ppg': dict(debayer=Debayer.ppg),
    'bilinear': dict(debayer=Debayer.bilinear),
    'aces': dict(tone_mapping=ToneMapper.aces),
    'reinhard': dict(tone_mapping=ToneMapper.reinhard),
    'linear': dict(tone_mapping=ToneMapper.linear),
    'filmic': dict(tone_mapping=ToneMapper.filmic),
    'sigma_s3': dict(bil_sigma_spatial=3.0),
    'denoise_f32': dict(denoise_f16=False),
}


def case_settings(name: str) -> ImageProcessingSettings:
    full = ImageProcessingSettings(
        debayer=Debayer.rcd, postprocess=True, enable_denoise=True, enable_bilateral=True,
        tone_mapping=ToneMapper.adaptive_aces, tone_gamma=1.5, tone_intensity=2.0,
        light_adapt=0.8, vibrance=0.5)
    return dataclasses.replace(full, **SETTINGS_CASES[name])


def case_frames(w, h, n, seed):
    """(n, w*h*3/2) Packed12 bytes of smooth-plus-noise mosaics."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return torch.stack([encode12_float(torch.from_numpy(np.clip(
        0.4 + 0.3 * np.sin(xx / (9.0 + i)) * np.cos(yy / 7.0) + rng.normal(0, 0.04, (h, w)),
        0, 1).astype(np.float32).reshape(-1))) for i in range(n)])


def _host_copies(monkeypatch) -> list:
    """Record every host value that the port makes into a tensor: calls of
    _device.to_device whose input is not already a tensor on the target
    device, and of torch.tensor / torch.as_tensor / torch.from_numpy on a
    value that is not a tensor."""
    found = []
    real = _device.to_device

    def to_device(values, device, dtype=None):
        if not (isinstance(values, torch.Tensor) and values.device == torch.device(device)):
            found.append(('to_device', type(values).__name__))
        return real(values, device, dtype)

    for name, mod in list(sys.modules.items()):
        if name.startswith('tpu_darktable_torch') and getattr(mod, 'to_device', None) is real:
            monkeypatch.setattr(mod, 'to_device', to_device)
    for fname in ('tensor', 'as_tensor', 'from_numpy'):
        orig = getattr(torch, fname)

        def wrapped(data, *a, _orig=orig, _name=fname, **kw):
            caller = sys._getframe(1).f_code.co_filename
            # _device.constant_on reads its key on the host before its cache
            if not isinstance(data, torch.Tensor) and caller != _device.__file__:
                found.append((_name, f'{caller}:{sys._getframe(1).f_lineno}'))
            return _orig(data, *a, **kw)

        monkeypatch.setattr(torch, fname, wrapped)
    return found


@pytest.mark.parametrize('case', list(SETTINGS_CASES))
def test_batched_program_copies_no_host_value_after_its_first_call(case, monkeypatch):
    """The second call of the batched program (a replay on the card) makes
    no host-to-device copy: each constant comes from a device cache."""
    w, h = 160, 96
    proc = tt.ImageProcessor((w, h), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                             case_settings(case), device='cpu', white_balance=WB)
    frames = case_frames(w, h, 4, seed=3)
    proc.process_batch(frames[:2])
    copies = _host_copies(monkeypatch)
    out = proc.process_batch(frames[2:])
    assert copies == []
    assert out.shape == (2, h, w, 3) and out.dtype == torch.uint8


def test_capture_key_is_shape_dtype_device():
    a, b = torch.zeros(2, 3), torch.zeros((), dtype=torch.int64)
    assert _graph.capture_key((a, b)) == (((2, 3), torch.float32, torch.device('cpu')),
                                          ((), torch.int64, torch.device('cpu')))
    assert _graph.capture_key((a + 1, b)) == _graph.capture_key((a, b))
    assert _graph.capture_key((a[:1], b)) != _graph.capture_key((a, b))
    assert _graph.capture_key((a.double(), b)) != _graph.capture_key((a, b))


class _StandInGraph:
    """Records the capture and counts replays; a replay runs nothing."""
    replays = 0

    def replay(self):
        _StandInGraph.replays += 1


class _StandInCapture:
    def __init__(self, graph, pool):
        self.graph, self.pool = graph, pool

    def __enter__(self):
        _StandInCapture.entered += 1

    def __exit__(self, *exc):
        return False


@pytest.fixture()
def stand_in(monkeypatch):
    """_graph with CPU tensors taken for card tensors and a stand-in for
    torch.cuda's graph, pool and capture."""
    _StandInGraph.replays = 0
    _StandInCapture.entered = 0
    monkeypatch.setattr(_graph, '_on_card', lambda t: isinstance(t, torch.Tensor))
    monkeypatch.setattr(_graph, '_new_pool', lambda: 'pool')
    monkeypatch.setattr(_graph, '_new_graph', _StandInGraph)
    monkeypatch.setattr(_graph, '_capturing', _StandInCapture)
    kernels.reset_launches()
    yield
    kernels.reset_launches()


def test_capture_adds_no_launch_and_each_replay_adds_its_capture(stand_in):
    """First call: eager (its launches count), then a capture that counts
    nothing; a replay adds what the capture recorded and returns clones of
    the static outputs; a new shape captures again."""
    calls = []

    def fn(x, y):
        calls.append(x.shape)
        kernels.count('rcd_interior')
        kernels.count('bilateral_band', 2)
        return x * 2, y + 1

    g = _graph.Graphed(fn)
    x, y = torch.arange(4.0), torch.ones(())
    out = g(x, y)
    assert torch.equal(out[0], x * 2) and len(calls) == 2 and _StandInCapture.entered == 1
    assert kernels.launches['rcd_interior'] == 1 and kernels.launches['bilateral_band'] == 2
    entry = g._captured[_graph.capture_key((x, y))]
    assert entry.made.launches == {'rcd_interior': 1, 'bilateral_band': 2}

    replayed = g(x + 10, y)
    assert len(calls) == 2 and _StandInGraph.replays == 1
    assert torch.equal(entry.inputs[0], x + 10)       # the arguments went to the static buffers
    assert torch.equal(replayed[0], entry.outputs[0])  # the stand-in ran nothing
    assert replayed[0] is not entry.outputs[0] and isinstance(replayed, tuple)
    assert kernels.launches['rcd_interior'] == 2 and kernels.launches['bilateral_band'] == 4
    g(x, y)
    assert kernels.launches['rcd_interior'] == 3 and kernels.launches['wavelet_core'] == 0

    g(torch.arange(6.0), y)   # a new shape: eager, then a second capture
    assert len(calls) == 4 and _StandInCapture.entered == 2 and len(g._captured) == 2
    assert kernels.launches['rcd_interior'] == 4


def test_a_capture_in_one_thread_keeps_the_counts_of_another():
    """While one thread captures (its launches go to its capture record),
    another thread's launches count as usual, and what the capture records
    is its own thread's alone; likewise the device constants a capture
    holds.  Stressed with a short switch interval."""
    import threading

    made, held, errors = [], [], []
    stop = threading.Event()

    def capture():
        try:
            while not stop.is_set():
                with _device.capturing() as record:
                    kernels.count('wavelet_core')
                    kernels.count('wavelet_core')
                    _device.scalar_on(2.0, 'cpu')
                made.append(record.launches)
                held.append(len(record.held))
        except Exception as e:   # reported below
            errors.append(e)

    kernels.reset_launches()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    t = threading.Thread(target=capture)
    try:
        t.start()
        for _ in range(20000):
            kernels.count('rcd_interior')
            _device.scalar_on(3.0, 'cpu')
    finally:
        stop.set()
        t.join(timeout=60)
        sys.setswitchinterval(switch)
    assert not t.is_alive() and errors == [] and made
    assert kernels.launches['rcd_interior'] == 20000 and kernels.launches['wavelet_core'] == 0
    assert all(m == {'wavelet_core': 2} for m in made) and set(held) == {1}
    kernels.reset_launches()


def test_capture_holds_the_device_constants_it_read(stand_in):
    """While a capture runs, the device caches report what they hand out;
    the captured entry keeps it after the caches are cleared."""
    def fn(x):
        return x / _device.scalar_on(3.0, x.device) + _device.constant_on([1.0, 2.0], x.device)

    g = _graph.Graphed(fn)
    x = torch.ones(2)
    g(x)
    held = g._captured[_graph.capture_key((x,))].made.held
    assert len(held) == 2 and held[0].shape == () and held[1].tolist() == [1.0, 2.0]
    _device.clear_caches()
    assert _device.scalar_on(3.0, x.device) is not held[0]
    assert torch.equal(_device.scalar_on(3.0, x.device), held[0])


def test_failed_capture_raises_with_its_cause(stand_in):
    state = {'n': 0}

    def fn(x):
        state['n'] += 1
        if state['n'] == 2:
            raise RuntimeError('operation not permitted when stream is capturing')
        return x + 1

    g = _graph.Graphed(fn)
    with pytest.raises(RuntimeError, match='CUDA graph failed.*not permitted'):
        g(torch.ones(3))
    assert kernels.launches['rcd_interior'] == 0


def test_graphed_exposes_the_stages():
    proc = tt.ImageProcessor((64, 48), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                             case_settings('full'), device='cpu', white_balance=WB)
    assert isinstance(proc._fused, _graph.Graphed)
    assert proc._fused.stages is proc._fused.fn.stages and proc._fused.stages is not None
    old = proc._fused
    proc.update_settings(case_settings('reinhard'))
    assert proc._fused is not old and proc._fused._captured == {}


def test_cpu_processor_never_touches_torch_cuda(monkeypatch):
    """ImageProcessor(device='cpu') runs the batched program eagerly: no
    call reaches torch.cuda (graph, pool, stream, synchronize), and the
    second batch gives what build_pipeline_fn gives."""
    touched = []

    def refuse(name):
        def f(*a, **kw):
            touched.append(name)
            raise AssertionError(f'torch.cuda.{name} called on the CPU path')
        return f

    for name in ('CUDAGraph', 'graph', 'graph_pool_handle', 'synchronize', 'current_stream',
                 'is_available', 'device', 'empty_cache', 'set_sync_debug_mode'):
        monkeypatch.setattr(torch.cuda, name, refuse(name))
    w, h = 128, 96
    s = case_settings('full')
    proc = tt.ImageProcessor((w, h), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12, s,
                             device='cpu', white_balance=WB)
    frames = case_frames(w, h, 4, seed=9)
    proc.process_batch(frames[:2])
    bounds, metrics = proc.bounds.clone(), proc.metrics.clone()
    out = proc.process_batch(frames[2:])
    assert touched == [] and proc._fused._captured == {}
    fn = tt.build_pipeline_fn(s, (w, h), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12, True)
    ref, ref_bounds, ref_metrics = fn(frames[2:], torch.tensor(WB), bounds, metrics,
                                      torch.tensor(s.moving_average))
    assert torch.equal(out, ref) and torch.equal(proc.bounds, ref_bounds)
    assert torch.equal(proc.metrics, ref_metrics)
