"""The compiled programs outside the batched entry point (the workspace
classes, the timing chains, the sharded programs' stages) on the CPU,
through `_graph.Graphed` with an emulated CUDA graph.

The emulation (`emulated`) takes CPU tensors for card tensors and stands in
for torch.cuda's graph: a capture runs the function once on the static
inputs, and a replay runs it again on them, with every non-tensor argument
as it was at the capture.  That is what a CUDA graph does with a Python
number it read: it keeps the capture's value.  So a method that reads a
value its capture key leaves out gives the first value's result on a
replay, and the tests below see it.

Each graphed call is held to: no host value copied on its second call,
the eager result for a new `noise`, `detail` or `eps`, the JAX class's
result for that value (the tolerances of tests/test_torch_denoise.py and
tests/test_torch_piecewise.py), one capture where the shards and bands of
one shape share it, and the settings steps that keep a workspace's graphs.
The card's own checks are in tests/test_torch_cuda.py.
"""

import dataclasses
import functools
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_darktable as td
from tpu_darktable import denoise as jdenoise
from tpu_darktable import local_contrast as jlc

import tpu_darktable_torch as tt
from tpu_darktable_torch import _device, _graph, kernels, parallel
from tpu_darktable_torch.pipeline.config import Debayer
from tpu_darktable_torch.pipeline.streaming import StreamingExecutor
from tpu_darktable_torch.scripts import run_benchmark
from tpu_darktable_torch.utils import timing
from test_torch_graph import WB, _host_copies, case_frames, case_settings

torch.set_num_threads(1)
CPU = torch.device('cpu')
W, H = 128, 96


class _Emulated:
    """A CUDA graph's stand-in: replay runs the captured call again on its
    static inputs and writes the results into the static outputs."""

    def __init__(self):
        self.rerun = self.outputs = None
        self.replays = 0

    def replay(self):
        self.replays += 1
        with _device.capturing():
            new = self.rerun()
        new = (new,) if isinstance(new, torch.Tensor) else new
        for out, value in zip(self.outputs, new):
            out.copy_(value)


def _emulated_record(graph, pool, fn, inputs):
    outputs = fn(*inputs)
    graph.rerun = lambda: fn(*inputs)
    graph.outputs = (outputs,) if isinstance(outputs, torch.Tensor) else tuple(outputs)
    return outputs


@pytest.fixture()
def emulated(monkeypatch):
    """_graph with CPU tensors taken for card tensors and the emulated
    graph; yields the list of graphs made."""
    made = []

    def new_graph():
        made.append(_Emulated())
        return made[-1]

    monkeypatch.setattr(_graph, '_on_card', lambda t: isinstance(t, torch.Tensor))
    monkeypatch.setattr(_graph, '_new_pool', lambda: 'pool')
    monkeypatch.setattr(_graph, '_new_graph', new_graph)
    monkeypatch.setattr(_graph, '_record', _emulated_record)
    kernels.reset_launches()
    yield made
    kernels.reset_launches()


def _rgb(seed, h=H, w=W):
    return torch.from_numpy((0.15 + 0.7 * np.random.default_rng(seed).random((h, w, 3)))
                            .astype(np.float32))


def _mosaic(seed, h=H, w=W):
    return torch.from_numpy((0.2 + 0.6 * np.random.default_rng(seed).random((h, w, 1)))
                            .astype(np.float32))


def _lum(seed):
    return tt.compute_luminance(_rgb(seed))


P = tt.BayerPattern.RGGB
STRONG = tt.LaplacianParams(shadows=0.6, highlights=1.4, clarity=0.3)

NOISE3 = torch.tensor([0.05, 0.04, 0.06])
INPUTS = {'mosaic': _mosaic, 'rgb': _rgb, 'lum': _lum}

# Every graphed method and function of the workspaces, as
# label -> (the owner's maker, its input's kind, a call of it on an input).
WORKSPACE_CALLS = {
    'bilinear5x5_demosaic': (lambda: None, 'mosaic',
                             lambda o, x: tt.bilinear5x5_demosaic(x, P)),
    'Bilinear5x5': (lambda: tt.Bilinear5x5(P), 'mosaic', lambda o, x: o.process(x)),
    'PPG': (lambda: tt.PPG('cpu', (W, H), P), 'mosaic', lambda o, x: o.process(x)),
    'PPG median 2': (lambda: tt.PPG('cpu', (W, H), P, median_threshold=2.0), 'mosaic',
                     lambda o, x: o.process(x)),
    'RCD': (lambda: tt.RCD('cpu', (W, H), P), 'mosaic', lambda o, x: o.process(x)),
    'PostProcess global': (
        lambda: tt.PostProcess('cpu', (W, H), P, color_smoothing_passes=3, green_eq_global=True),
        'rgb', lambda o, x: o.process(x)),
    'PostProcess local': (
        lambda: tt.PostProcess('cpu', (W, H), P, color_smoothing_passes=1, green_eq_local=True,
                               green_eq_threshold=4.0),
        'rgb', lambda o, x: o.process(x)),
    'Wiener.process': (lambda: tt.Wiener('cpu', (W, H)), 'rgb',
                       lambda o, x: o.process(x, 0.05)),
    'Wiener.process f16': (
        lambda: tt.Wiener('cpu', (W, H), spectral_dtype=torch.float16,
                          storage_dtype=torch.float16),
        'rgb', lambda o, x: o.process(x, NOISE3)),
    'Wiener.process_luminance': (lambda: tt.Wiener('cpu', (W, H)), 'rgb',
                                 lambda o, x: o.process_luminance(x, 0.05)),
    'Wiener.process_log_luminance': (lambda: tt.Wiener('cpu', (W, H)), 'rgb',
                                     lambda o, x: o.process_log_luminance(x, 0.075)),
    'Wiener.process_log': (lambda: tt.Wiener('cpu', (W, H), overlap_factor=2), 'rgb',
                           lambda o, x: o.process_log(x, 0.05)),
    'Laplacian.process': (lambda: tt.Laplacian('cpu', (W, H)), 'lum',
                          lambda o, x: o.process(x)),
    'Laplacian.process_rgb strong': (lambda: tt.Laplacian('cpu', (W, H), STRONG), 'rgb',
                                     lambda o, x: o.process_rgb(x)),
    'Bilateral.process': (lambda: tt.Bilateral('cpu', (W, H), sigma_s=2.0, sigma_r=0.2), 'lum',
                          lambda o, x: o.process(x, 0.4)),
    'Bilateral.process_rgb': (lambda: tt.Bilateral('cpu', (W, H), sigma_s=2.0, sigma_r=0.2),
                              'rgb', lambda o, x: o.process_rgb(x, 0.4)),
    'Bilateral.process_log_rgb sigma_s 3': (
        lambda: tt.Bilateral('cpu', (W, H), sigma_s=3.0, sigma_r=0.2), 'rgb',
        lambda o, x: o.process_log_rgb(x, 0.4)),
}


def _graphs_of(owner):
    return tt.debayer._bilinear if owner is None else owner._graphs


@pytest.mark.parametrize('label', list(WORKSPACE_CALLS))
def test_workspace_replay_copies_no_host_value(label, emulated, monkeypatch):
    """The first call runs eagerly and captures; the second, on a new
    input of the same shape, replays (the emulated graph runs the method
    again), copies no host value and equals the eager method on that
    input bit for bit."""
    make, kind, call = WORKSPACE_CALLS[label]
    x1, x2 = INPUTS[kind](1), INPUTS[kind](2)
    owner = make()
    graphs = _graphs_of(owner)
    graphs._captured.clear()
    call(owner, x1)
    assert len(graphs._captured) == 1 and len(emulated) == 1
    copies = _host_copies(monkeypatch)
    out = call(owner, x2)
    assert copies == [] and emulated[0].replays == 1
    monkeypatch.undo()
    eager = make()
    if eager is not None:
        eager._graphs = eager._graphs.fn
        want = call(eager, x2)
    else:
        want = tt.ops.demosaic.bilinear5x5_demosaic(x2, P)
    assert torch.equal(out, want)


# A new value of what a call reads besides its tensors: each method of
# Wiener with a new noise (a tensor argument, as JAX traces it) and eps,
# of Bilateral with a new detail and eps (static, as JAX makes them).
VALUE_CASES = {
    'Wiener.process noise': ('Wiener', 'process', (0.05,), (0.02,)),
    'Wiener.process noise tensor': ('Wiener', 'process', ([0.05, 0.04, 0.06],),
                                    ([0.02, 0.08, 0.03],)),
    'Wiener.process_luminance noise': ('Wiener', 'process_luminance', (0.05,), (0.1,)),
    'Wiener.process_log_luminance noise': ('Wiener', 'process_log_luminance', (0.075,), (0.03,)),
    'Wiener.process_log_luminance eps': ('Wiener', 'process_log_luminance', (0.075, 1e-4),
                                         (0.075, 1e-2)),
    'Wiener.process_log eps': ('Wiener', 'process_log', (0.05, 1e-4), (0.05, 0.05)),
    'Bilateral.process detail': ('Bilateral', 'process', (0.4,), (-0.7,)),
    'Bilateral.process_rgb detail': ('Bilateral', 'process_rgb', (0.4,), (1.2,)),
    'Bilateral.process_log_rgb eps': ('Bilateral', 'process_log_rgb', (0.4, 1e-6),
                                      (0.4, 1e-2)),
}


def _value_args(cls, values, mod):
    """noise lists as tensors of the package `mod` (torch or jnp)."""
    if cls == 'Wiener' and isinstance(values[0], list):
        return (mod.asarray(np.asarray(values[0], np.float32)),) + values[1:]
    return values


@pytest.mark.parametrize('case', list(VALUE_CASES))
def test_new_value_gives_its_own_result(case, emulated):
    """A second call with another value gives the eager result for that
    value bit for bit, and the JAX class's within the class tests' bar
    (2e-5); the noise replays the first capture (one graph), detail and
    eps capture anew."""
    cls, method, first, second = VALUE_CASES[case]
    make = {'Wiener': lambda: tt.Wiener('cpu', (W, H)),
            'Bilateral': lambda: tt.Bilateral('cpu', (W, H), sigma_s=2.0, sigma_r=0.2)}[cls]
    x = _lum(5) if method == 'process' and cls == 'Bilateral' else _rgb(5)
    owner = make()
    getattr(owner, method)(x, *_value_args(cls, first, torch))
    out = getattr(owner, method)(x, *_value_args(cls, second, torch))
    assert len(emulated) == (1 if 'noise' in case else 2)
    eager = make()
    eager._graphs = eager._graphs.fn
    assert torch.equal(out, getattr(eager, method)(x, *_value_args(cls, second, torch)))
    assert not torch.equal(out, getattr(eager, method)(x, *_value_args(cls, first, torch)))
    jax_owner = (jdenoise.Wiener(None, (W, H)) if cls == 'Wiener'
                 else jlc.Bilateral(None, (W, H), sigma_s=2.0, sigma_r=0.2))
    ref = np.asarray(getattr(jax_owner, method)(jnp.asarray(x.numpy()),
                                                *_value_args(cls, second, jnp)))
    assert np.abs(out.numpy() - ref).max() <= 2e-5


def test_a_key_without_the_value_would_replay_the_first_value(emulated, monkeypatch):
    """The emulation's own check: with a capture key that ignores the
    non-tensor arguments, the second value replays the first's result."""
    def fn(x, k):
        return x * k

    monkeypatch.setattr(_graph, 'capture_key',
                        lambda args: tuple(tuple(a.shape) for a in args
                                           if isinstance(a, torch.Tensor)))
    g = _graph.Graphed(fn)
    x = torch.ones(3)
    g(x, 2.0)
    assert torch.equal(g(x, 3.0), x * 2.0)


def test_capture_key_holds_the_values():
    x = torch.zeros(2, 3)
    assert _graph.capture_key((x, 0.5, 'log')) == (((2, 3), torch.float32, CPU),
                                                   (float, 0.5), (str, 'log'))
    assert _graph.capture_key((x, 0.5)) != _graph.capture_key((x, 0.25))
    assert _graph.capture_key((x, 1)) != _graph.capture_key((x, 1.0))
    assert _graph.capture_key((x, P)) != _graph.capture_key((x, tt.BayerPattern.GBRG))


def test_lru_drops_the_oldest_capture(emulated, monkeypatch):
    """Two captures kept: a third key drops the least recently used capture
    (the entry that holds its graph, buffers and constants goes), and that
    key captures again when it comes back."""
    monkeypatch.setattr(_graph, '_MAXSIZE', 2)
    g = _graph.Graphed(lambda x, k: x + k)
    x = torch.zeros(4)
    g(x, 1.0)
    g(x, 2.0)
    g(x, 1.0)                       # 1.0 is now the most recent
    dropped = weakref.ref(g._captured[_graph.capture_key((x, 2.0))])
    g(x, 3.0)
    gc.collect()
    assert [k[1][1] for k in g._captured] == [1.0, 3.0] and dropped() is None
    assert torch.equal(g(x, 2.0), x + 2.0) and len(emulated) == 4
    assert [k[1][1] for k in g._captured] == [3.0, 2.0]


def test_pool_takes_a_new_id_once_its_graphs_are_gone(monkeypatch):
    """One pool id a device while a graph of it lives there; PyTorch
    retires an id whose graphs are all gone, so the next capture on that
    device takes a new one."""
    class Graph:
        pass

    ids = iter(range(10))
    monkeypatch.setattr(_graph, '_new_pool', lambda: next(ids))
    pool = _graph.GraphPool()
    a, b, c = Graph(), Graph(), Graph()
    assert [pool.handle(0, a), pool.handle(0, b), pool.handle(1, c)] == [0, 0, 1]
    del a
    gc.collect()
    assert pool.handle(0, Graph()) == 0          # b still holds device 0's pool
    del b
    gc.collect()
    assert pool.handle(0, Graph()) == 2 and pool.handle(1, c) == 1


def test_single_tensor_and_tuple_outputs(emulated):
    g = _graph.Graphed(lambda x: x * 2)
    h = _graph.Graphed(lambda x: (x * 2, x + 1))
    x = torch.arange(3.0)
    for _ in range(2):
        assert torch.equal(g(x), x * 2)
        a, b = h(x)
        assert torch.equal(a, x * 2) and torch.equal(b, x + 1)


# ---- ImageProcessor: the piecewise path, its workspaces and its pool

def _processor(settings, mesh=None):
    return tt.ImageProcessor((W, H), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12, settings,
                             device='cpu', white_balance=WB, mesh=mesh)


def _piecewise(proc, frame):
    rgb = proc.debayer(proc.load_bytes(frame))
    rgb = proc.process_rgb(rgb, tt.compute_image_bounds([rgb], stride=8))
    return proc.tonemap(rgb, tt.compute_image_metrics([rgb], stride=8))


WORKSPACES = ('rcd_workspace', 'postprocess_workspace', 'wiener_workspace', 'bil_workspace',
              'ppg_workspace')


def test_tone_step_keeps_the_workspaces_and_their_graphs(emulated):
    """update_settings with only a tone field changed keeps every
    workspace and its captures; the next frame replays them all and
    captures nothing; the batched program is rebuilt."""
    proc = _processor(case_settings('full'))
    frames = case_frames(W, H, 2, seed=4)
    _piecewise(proc, frames[0])
    kept = {name: getattr(proc, name) for name in WORKSPACES}
    captured = {name: dict(w._graphs._captured) for name, w in kept.items()}
    assert all(len(captured[n]) == 1 for n in ('rcd_workspace', 'postprocess_workspace',
                                              'wiener_workspace', 'bil_workspace'))
    fused = proc._fused
    n_graphs = len(emulated)
    proc.update_settings(dataclasses.replace(proc.settings, tone_gamma=2.0))
    assert proc._fused is not fused
    for name, workspace in kept.items():
        assert getattr(proc, name) is workspace
        assert workspace._graphs._captured == captured[name]
    out = _piecewise(proc, frames[1])
    assert len(emulated) == n_graphs
    assert sum(g.replays for g in emulated) == 4
    eager = _processor(proc.settings)
    for name in WORKSPACES:
        ws = getattr(eager, name)
        ws._graphs = ws._graphs.fn
    assert torch.equal(out, _piecewise(eager, frames[1]))


def test_settings_step_rebuilds_only_the_changed_workspace():
    """A bilateral step rebuilds the bilateral workspace alone; a denoise
    step (a value the call passes) rebuilds none."""
    proc = _processor(case_settings('full'))
    kept = {name: getattr(proc, name) for name in WORKSPACES}
    proc.update_settings(dataclasses.replace(proc.settings, bil_sigma_spatial=4.0))
    assert [n for n in WORKSPACES if getattr(proc, n) is not kept[n]] == ['bil_workspace']
    kept['bil_workspace'] = proc.bil_workspace
    proc.update_settings(dataclasses.replace(proc.settings, denoise=0.1, bilateral=0.7))
    assert all(getattr(proc, n) is kept[n] for n in WORKSPACES)


def test_processor_graphs_share_one_pool():
    proc = _processor(case_settings('full'))
    pools = {id(getattr(proc, n)._graphs.pool) for n in WORKSPACES} | {id(proc._bilinear.pool)}
    assert pools == {id(proc._fused.pool)} and proc._fused.pool is proc._graph_pool
    proc.update_settings(dataclasses.replace(proc.settings, bil_sigma_spatial=4.0))
    assert proc.bil_workspace._graphs.pool is proc._graph_pool
    sharded = _processor(case_settings('full'), mesh=parallel.make_mesh([CPU] * 2))
    assert all(g.pool is sharded._graph_pool for g in sharded._fused.graphs)


def _refuse_torch_cuda(monkeypatch):
    touched = []

    def refuse(name):
        def f(*a, **kw):
            touched.append(name)
            raise AssertionError(f'torch.cuda.{name} called on the CPU path')
        return f

    for name in ('CUDAGraph', 'graph', 'graph_pool_handle', 'synchronize', 'current_stream',
                 'is_available', 'device', 'empty_cache', 'set_sync_debug_mode'):
        monkeypatch.setattr(torch.cuda, name, refuse(name))
    return touched


CPU_ENTRY_POINTS = {
    'piecewise': lambda: _piecewise(_processor(case_settings('full')),
                                     case_frames(W, H, 1, seed=6)[0]),
    'piecewise ppg': lambda: _piecewise(
        _processor(dataclasses.replace(case_settings('full'), debayer=Debayer.ppg)),
        case_frames(W, H, 1, seed=6)[0]),
    'piecewise bilinear': lambda: _piecewise(
        _processor(dataclasses.replace(case_settings('full'), debayer=Debayer.bilinear)),
        case_frames(W, H, 1, seed=6)[0]),
    'laplacian class': lambda: tt.Laplacian('cpu', (W, H), STRONG).process_rgb(_rgb(3)),
    'sharded processor': lambda: _processor(
        case_settings('full'), mesh=parallel.make_mesh([CPU] * 2)).process_batch(
        case_frames(W, H, 2, seed=6)),
    'benchmark_op': lambda: timing.benchmark_op(lambda x: x * 0.5 + 0.1, _rgb(3), 3, 1),
    'Jpeg.encode': lambda: tt.Jpeg().encode((_rgb(3) * 255).to(torch.uint8), 90,
                                            entropy='device'),
    'Jpeg.encode_async': lambda: tt.Jpeg().encode_async((_rgb(3) * 255).to(torch.uint8),
                                                        90).result(),
    'Jpeg.encode progressive': lambda: tt.Jpeg().encode((_rgb(3) * 255).to(torch.uint8), 90,
                                                        progressive=True),
    'streaming host JPEG': lambda: StreamingExecutor(
        _processor(case_settings('full')), batch_size=2, jpeg_quality=90,
        device_jpeg=False).run([(f'f{i}', f) for i, f in enumerate(case_frames(W, H, 2, 6))]),
}


@pytest.mark.parametrize('entry', list(CPU_ENTRY_POINTS))
def test_cpu_entry_points_never_touch_torch_cuda(entry, monkeypatch):
    """On the CPU every graphed entry point runs eagerly: no call reaches
    torch.cuda (graph, pool, stream, synchronize)."""
    touched = _refuse_torch_cuda(monkeypatch)
    CPU_ENTRY_POINTS[entry]()
    assert touched == []


# ---- the timing chains

def test_benchmark_op_times_replays(emulated):
    """The chain of `iters` calls is captured once; each warm-up and the
    timed call replay it."""
    calls = []

    def op(x):
        calls.append(1)
        return x * 0.5 + 0.1

    dt = timing.benchmark_op(op, _rgb(1), iters=4, warmup=2)
    assert dt > 0 and len(emulated) == 1 and emulated[0].replays == 3
    assert len(calls) == 4 * (2 + 3)   # eager, capture, three replays (each runs the chain)


@functools.lru_cache(maxsize=1)
def _run_benchmark_chains():
    """The (name, op, x0, iters) of every op run_benchmark chains, at
    64x48 on the CPU."""
    chains = []

    def record(name, fn, x0, warmup_iters=2, bench_iters=10):
        chains.append((name, fn, x0, bench_iters))
        return 1.0

    real, run_benchmark.benchmark = run_benchmark.benchmark, record
    try:
        run_benchmark.run_benchmark(None, tt.BayerPattern.RGGB, 1, 2, size=(64, 48),
                                    device='cpu')
    finally:
        run_benchmark.benchmark = real
    return tuple(chains)


def test_run_benchmark_chains_twelve_ops():
    names = [c[0] for c in _run_benchmark_chains()]
    assert len(names) == 12 and 'RCD' in names and 'Green eq' in names


@pytest.mark.parametrize('index', range(12))
def test_run_benchmark_chain_is_capturable(index, emulated, monkeypatch):
    """Each chained op of run_benchmark: the replay of its chain copies no
    host value and equals the eager chain bit for bit."""
    name, fn, x0, iters = _run_benchmark_chains()[index]
    # the graphs made before this chain's: its first run here, if it ran
    # here, replays its JPEG encoder's
    before = len(emulated)

    def chain(x):
        for _ in range(iters):
            x = fn(x)
        return x

    g = _graph.Graphed(chain)
    g(x0)
    copies = _host_copies(monkeypatch)
    out = g(x0)
    assert copies == [] and emulated[before].replays == 1, name
    assert torch.equal(out, chain(x0)), name


# ---- the sharded programs

def _state(settings):
    f32 = dict(dtype=torch.float32)
    return (torch.tensor(WB, **f32), torch.zeros(2, **f32), torch.zeros(5, **f32),
            torch.ones((), **f32))


def test_batch_shards_share_one_capture(emulated, monkeypatch):
    """ImageProcessor(mesh=[cpu] * 4): the four shards of a batch of 8 run
    each stage through one capture (the first shard eager, the other three
    replays), the second batch replays all four and copies no host value,
    and both batches equal the unsharded eager program bit for bit."""
    s = case_settings('full')
    proc = _processor(s, mesh=parallel.make_mesh([CPU] * 4))
    frames = case_frames(W, H, 16, seed=8)
    fn = tt.build_pipeline_fn(s, (W, H), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12, True)
    wb, bounds, metrics, _ = _state(s)
    outs = [proc.process_batch(frames[:8])]
    assert [len(g._captured) for g in proc._fused.graphs] == [1, 1, 1]
    assert [g.replays for g in emulated] == [3, 3, 3]
    copies = _host_copies(monkeypatch)
    outs.append(proc.process_batch(frames[8:]))
    assert copies == [] and [g.replays for g in emulated] == [7, 7, 7]
    monkeypatch.undo()
    for k, out in enumerate(outs):
        alpha = torch.tensor(1.0 if k == 0 else s.moving_average)
        want, bounds, metrics = fn(frames[8 * k:8 * (k + 1)], wb, bounds, metrics, alpha)
        assert torch.equal(out, want)
    assert torch.equal(proc.bounds, bounds) and torch.equal(proc.metrics, metrics)


@pytest.mark.parametrize('algorithm', ['rcd', 'ppg', 'bilinear'])
def test_spatial_demosaic_bands_share_one_capture(algorithm, emulated):
    """Three bands of one block shape: one capture, two replays, each band
    sliced at its own offset outside the graph: equal to the eager bands."""
    from tpu_darktable_torch.parallel import spatial

    spatial._demosaic_block._captured.clear()
    bayer = _mosaic(9, h=384, w=64)[..., 0]
    mesh = parallel.make_mesh([CPU] * 3)
    out = parallel.spatial_shard_map_demosaic(bayer, mesh, P, algorithm)
    assert len(spatial._demosaic_block._captured) == 1 and emulated[0].replays == 2
    n = spatial._demosaic_block
    try:
        spatial._demosaic_block = n.fn
        want = parallel.spatial_shard_map_demosaic(bayer, mesh, P, algorithm)
    finally:
        spatial._demosaic_block = n
    assert torch.equal(out, want)


BAND_CASES = {
    'bands 3': (lambda s: parallel.build_spatial_pipeline_fn(
        s, (256, 192), P, tt.PackedFormat.Packed12, True, parallel.make_mesh([CPU] * 3),
        halo=64), 1),
    'grid 2x3': (lambda s: parallel.build_grid_pipeline_fn(
        s, (256, 192), P, tt.PackedFormat.Packed12, True,
        parallel.make_grid_mesh(2, 3, [CPU] * 6), halo=64), 2),
}


@pytest.mark.parametrize('case', list(BAND_CASES))
def test_band_blocks_share_captures_with_their_own_offsets(case, emulated, monkeypatch):
    """The band programs at 256x192 (3 bands of 64 rows, blocks of 192):
    each of FULL's four per-block steps (front, green eq, back, tonemap)
    captures once for all blocks and replays for the others; a second call
    copies no host value; both calls equal the same program run eagerly
    bit for bit, and the unsharded program within 1 count (a band offset
    frozen into a graph would replay block 0's rows for every block)."""
    s = case_settings('full')
    build, n_frames = BAND_CASES[case]
    frames = case_frames(256, 192, n_frames, seed=10)
    data = frames[0] if n_frames == 1 else frames
    program = build(s)
    state = _state(s)
    first = program(data, *state)
    assert len(emulated) == 4
    assert [g.replays for g in emulated] == [3 * n_frames - 1] * 4
    copies = _host_copies(monkeypatch)
    second = program(data, *state)
    assert copies == []
    monkeypatch.undo()
    eager = build(s)
    want = eager(data, *state)
    for got in (first, second):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    # and the unsharded program's result within tests/test_parallel.py's bars
    ref, ref_bounds, ref_metrics = tt.build_pipeline_fn(
        s, (256, 192), P, tt.PackedFormat.Packed12, True, rcd_strict_alias=False)(
        frames, *state)
    out, bounds, metrics = first
    assert (out.int() - ref.reshape(out.shape).int()).abs().max().item() <= 1
    assert (bounds - ref_bounds).abs().max().item() <= 1e-6
    assert torch.allclose(metrics, ref_metrics, rtol=1e-5, atol=1e-6)


# The band programs' per-device steps between the collectives, each case
# with the steps it runs besides front, back and tonemap: tests/test_parallel.py's
# FULL (green eq) and Laplacian (green eq and the Laplacian's three steps,
# no denoise or bilateral) cases on 8 bands of 32 rows at 96x256 (blocks of
# 160), the Laplacian case on a (camera 2, band 4) grid, and FULL with the
# Laplacian's clarity.  The last is held to the port's unsharded program,
# not to JAX's band program: on the float16 Wiener route the port's LAB is
# 1 ulp from XLA's at a few pixels and the clarity term lifts that into the
# metrics' log mean (tests/test_torch_pipeline.py holds that gap), and JAX's
# own band program there sits 1.7e-5 from JAX's unsharded program, beyond
# the bars below.
_LAP = dict(enable_denoise=False, enable_bilateral=False, enable_laplacian=True, lap_sigma=0.2,
            lap_shadows=1.2, lap_highlights=0.8, lap_clarity=0.15)
GLUE_CASES = {
    'bands 8 full': (dict(), None, 'jax'),
    'bands 8 laplacian': (_LAP, None, 'jax'),
    'grid 2x4 laplacian': (_LAP, (2, 4), 'jax'),
    'bands 8 full laplacian clarity': (dict(enable_laplacian=True, lap_clarity=0.3), None,
                                       'unsharded'),
}


@pytest.mark.parametrize('case', list(GLUE_CASES))
def test_band_glue_replays_and_matches_jax(case, emulated, monkeypatch):
    """Every per-device step of the band program runs through its graph:
    one capture a step for all blocks (and frames), replayed for the
    others; the second call copies no host value; both calls equal the
    program run eagerly bit for bit, and JAX's band program (or the port's
    unsharded program, see above) within tests/test_parallel.py's bars:
    1 uint8 count, bounds atol 1e-6, metrics rtol 1e-5 atol 1e-6."""
    import jax

    from tpu_darktable import parallel as jpar
    from test_torch_parallel import _close, _encode, _port, _settings, _smooth_mosaic
    from test_torch_parallel import _state_j

    kw, grid, against = GLUE_CASES[case]
    h, w = 256, 96
    rng = np.random.default_rng(14)
    n_frames = 1 if grid is None else 2
    data = torch.from_numpy(_encode([_smooth_mosaic(rng, h, w) for _ in range(n_frames)]))
    js = _settings(**kw)
    args = (_port(js), (w, h), P, tt.PackedFormat.Packed12, True)
    jargs = (js, (w, h), td.BayerPattern.RGGB, td.PackedFormat.Packed12, True)
    if grid is None:
        build = lambda: parallel.build_spatial_pipeline_fn(
            *args, parallel.make_mesh([CPU] * 8), halo=64)
        jfn = lambda: jpar.build_spatial_pipeline_fn(*jargs, jpar.make_mesh(), halo=64)
    else:
        build = lambda: parallel.build_grid_pipeline_fn(
            *args, parallel.make_grid_mesh(*grid, [CPU] * 8), halo=64)
        jfn = lambda: jpar.build_grid_pipeline_fn(*jargs, jpar.make_grid_mesh(*grid), halo=64)
    frames = data
    if grid is None:
        data = data[0]
    program = build()
    state = _state(None)
    first = program(data, *state)
    used = {'front', 'back', 'tonemap', 'green_eq'}
    used |= {'lab', 'laplacian', 'lab_modify'} if js.enable_laplacian else set()
    assert {n for n, g in program.graphs.items() if g._captured} == used
    assert all(len(program.graphs[n]._captured) == 1 for n in used)
    copies = _host_copies(monkeypatch)
    second = program(data, *state)
    assert copies == []
    monkeypatch.undo()
    want = build()(data, *state)
    for got in (first, second):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    if against == 'jax':
        ref = jax.jit(jfn())(jnp.asarray(data.numpy()), *_state_j())
    else:
        ref = tt.build_pipeline_fn(*args, rcd_strict_alias=False)(frames, *state)
        ref = (ref[0].reshape(first[0].shape), ref[1], ref[2])
    _close(first[0], ref[0], first[1], ref[1], first[2], ref[2])


# ---- BASELINE's chains (benchmarks/baseline_configs.py), as chip_smoke.py graphs them

def _config2_pass(x):
    from tpu_darktable_torch.ops import demosaic, postprocess, rcd

    y = torch.empty_like(x)
    for i in range(x.shape[0]):
        a = postprocess.postprocess(demosaic.ppg_demosaic(x[i], P), P, color_smoothing_passes=3)
        b = postprocess.postprocess(rcd.rcd_demosaic(x[i], P), P, color_smoothing_passes=3)
        y[i] = (a + b)[..., 1] * 0.5
    return y


def _config3_pass(x):
    y = torch.empty_like(x)
    for i in range(x.shape[0]):
        y[i] = tt.denoise.nlm_denoise(tt.denoise.wavelet_denoise(x[i], 0.05), 0.05)
    return y


_C4_PARAMS = tt.TonemapParameters(gamma=1.5, intensity=2.0, vibrance=0.5)
_C4_METRICS = torch.tensor([-1.5, 0.3, 0.3, 0.35, 0.25])


def _config4_tonemaps(x):
    from tpu_darktable_torch.ops import laplacian, tonemap

    y = laplacian.local_laplacian(x, laplacian.LaplacianParams())
    rgb = torch.stack([y, y, y], dim=-1)
    return (tonemap.reinhard_tonemap(rgb, _C4_METRICS, _C4_PARAMS),
            tonemap.filmic_tonemap(rgb, _C4_PARAMS), tonemap.aces_tonemap(rgb, _C4_PARAMS))


def _config4_pass(x):
    u1, u2, u3 = _config4_tonemaps(x)
    return x + 1e-12 * (u1[..., 0] + u2[..., 0] + u3[..., 0]).to(torch.float32)


def _jax_config_pass(name, x):
    """The JAX package's pass of the config on the same input (numpy)."""
    from tpu_darktable.ops import demosaic as jdm, laplacian as jlp, nlm as jnlm
    from tpu_darktable.ops import postprocess as jpp, rcd as jrcd, tonemap as jtm

    jp = td.BayerPattern.RGGB
    if name == 'config 2':
        def one(m):
            a = jpp.postprocess(jdm.ppg_demosaic(m, jp), jp, color_smoothing_passes=3)
            b = jpp.postprocess(jrcd.rcd_demosaic(m, jp), jp, color_smoothing_passes=3)
            return (a + b)[..., 1] * 0.5
        return np.stack([np.asarray(one(jnp.asarray(m))) for m in x])
    if name == 'config 3':
        return np.stack([np.asarray(jnlm.nlm_denoise(jnlm.wavelet_denoise(jnp.asarray(im), 0.05),
                                                     0.05)) for im in x])
    params = jtm.TonemapParameters(gamma=1.5, intensity=2.0, vibrance=0.5)
    y = jlp.local_laplacian(jnp.asarray(x), jlp.LaplacianParams())
    rgb = jnp.stack([y, y, y], axis=-1)
    return tuple(np.asarray(u) for u in (
        jtm.reinhard_tonemap(rgb, jnp.asarray(_C4_METRICS.numpy()), params),
        jtm.filmic_tonemap(rgb, params), jtm.aces_tonemap(rgb, params)))


# name -> (one pass, its input, passes a chain, the bar against JAX: the
# demosaics' 1e-6 (tests/test_torch_piecewise.py), NLM after the wavelet
# 2e-6 each (tests/test_torch_denoise.py), the tonemaps one uint8 count)
BASELINE_CHAINS = {
    'config 2': (_config2_pass, lambda: torch.from_numpy(
        (np.random.default_rng(0).random((2, 48, 64)) * 0.8).astype(np.float32)), 3, 1e-6),
    'config 3': (_config3_pass, lambda: _rgb(12, 48, 64)[None].repeat(2, 1, 1, 1), 2, 4e-6),
    'config 4': (_config4_pass, lambda: torch.from_numpy(
        (np.random.default_rng(0).random((48, 64)) * 0.8).astype(np.float32)), 2, 1),
}


@pytest.mark.parametrize('name', list(BASELINE_CHAINS))
def test_baseline_chain_is_capturable(name, emulated, monkeypatch):
    """A BASELINE config's chain as one graph: the replay copies no host
    value and equals the eager chain bit for bit; one eager pass is within
    its bar of the JAX package's."""
    fn, make, iters, bar = BASELINE_CHAINS[name]
    x0 = make()

    def chain(x):
        for _ in range(iters):
            x = fn(x)
        return x

    g = _graph.Graphed(chain)
    g(x0)
    copies = _host_copies(monkeypatch)
    out = g(x0)
    assert copies == [] and emulated[0].replays == 1
    monkeypatch.undo()
    assert torch.equal(out, chain(x0))
    if name == 'config 4':
        for got, ref in zip(_config4_tonemaps(x0), _jax_config_pass(name, x0.numpy())):
            assert np.abs(got.numpy().astype(int) - ref.astype(int)).max() <= bar
    else:
        assert np.abs(fn(x0).numpy() - _jax_config_pass(name, x0.numpy())).max() <= bar
