"""The JPEG encoder's compiled programs (the DCT stage and the device
entropy scan, which the JAX package jits) on the CPU, through
`_graph.Graphed` with the emulated CUDA graph of
tests/test_torch_graph_workspaces.py (a replay reruns the captured call on
its static inputs with the capture's non-tensor values).

Each encode is held to: no host value copied on the call that replays,
the eager encode's bytes and the JAX package's `encode_jpeg` bytes bit for
bit (the port's DCT coefficients are JAX's, tests/test_torch_jpeg.py), one
capture a key (a second quality replays the DCT capture with its own
tables), and each of two threads that encode through one `Jpeg` at once
getting its own bytes.  The card's own checks are in
tests/test_torch_cuda.py.
"""

import threading
import time

import numpy as np
import pytest
import torch

from tpu_darktable.ops import jpeg as J

import tpu_darktable_torch as tt
from tpu_darktable_torch import _graph
from tpu_darktable_torch.ops import jpeg as T
from tpu_darktable_torch.pipeline.streaming import StreamingExecutor
from test_torch_graph import _host_copies
from test_torch_graph_workspaces import _Emulated, emulated  # noqa: F401  (a fixture)

torch.set_num_threads(1)

SIZES = {'72x136': (72, 136), 'ragged 75x133': (75, 133)}
SUBSAMPLING = {'444': 0, '422': 1, 'gray': 2}
# restart intervals: none, five MCUs, and the auto choice (none at these sizes)
RESTART = {'off': 0, '5': 5, 'auto': None}


def _image(seed, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / (23 + seed)) * np.cos(yy / 17),
                    128 + 70 * np.cos(xx / 11), 128 + 50 * np.sin((xx + yy) / 31)], -1)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


def _captures(jpeg):
    return len(jpeg._stages.dct._captured), len(jpeg._stages.scan._captured)


def _plain_stages():
    """The encoder's programs run eagerly, whatever the graphs do."""
    stages = T._Stages()
    stages.dct, stages.scan = T._jpeg_device_stage, T._scan
    return stages


def _eager_encode(img, quality, subsampling=1, restart=None):
    return T._encode(_plain_stages(), img, quality, 3, subsampling, False, restart, 'device',
                     None)


@pytest.mark.parametrize('ri', list(RESTART))
@pytest.mark.parametrize('ss', list(SUBSAMPLING))
@pytest.mark.parametrize('size', list(SIZES))
def test_replayed_encode_copies_no_host_value_and_gives_jax_bytes(size, ss, ri, emulated,
                                                                   monkeypatch):
    """The first encode runs both stages eagerly and captures them; the
    second, of another frame, replays both (the emulated graphs rerun
    them), copies no host value, and gives the eager encode's bytes and
    JAX's, bit for bit."""
    h, w = SIZES[size]
    subsampling, restart = SUBSAMPLING[ss], RESTART[ri]
    frames = [torch.from_numpy(_image(seed, h, w)) for seed in (1, 2)]
    jpeg = tt.Jpeg()
    jpeg.encode(frames[0], 90, subsampling=subsampling, restart_interval=restart,
                entropy='device')
    assert _captures(jpeg) == (1, 1) and len(emulated) == 2
    copies = _host_copies(monkeypatch)
    got = jpeg.encode(frames[1], 90, subsampling=subsampling, restart_interval=restart,
                      entropy='device')
    assert copies == [] and [g.replays for g in emulated] == [1, 1]
    monkeypatch.undo()
    eager = T.encode_jpeg(frames[1], 90, subsampling=subsampling, restart_interval=restart,
                          entropy='device')
    np.testing.assert_array_equal(got, eager)
    np.testing.assert_array_equal(got, T.encode_jpeg(
        frames[1], 90, subsampling=subsampling, restart_interval=restart, entropy='host'))
    np.testing.assert_array_equal(got, J.encode_jpeg(
        frames[1].numpy(), 90, subsampling=subsampling, restart_interval=restart))


@pytest.mark.parametrize('ss', list(SUBSAMPLING))
def test_second_quality_replays_the_capture_with_its_own_tables(ss, emulated):
    """Quality 90, then 75 and 94 on the same frame: the quant tables are
    tensor arguments, so the DCT stage replays its one capture, and the
    scan its own (the block shapes are the same); each quality gives its
    eager bytes, and they differ from each other."""
    subsampling = SUBSAMPLING[ss]
    img = torch.from_numpy(_image(3, 72, 136))
    jpeg = tt.Jpeg()
    got = {q: jpeg.encode(img, q, subsampling=subsampling, entropy='device')
           for q in (90, 75, 94)}
    assert _captures(jpeg) == (1, 1) and [g.replays for g in emulated] == [2, 2]
    for q, data in got.items():
        np.testing.assert_array_equal(data, _eager_encode(img, q, subsampling))
    assert len({bytes(d) for d in got.values()}) == 3


@pytest.mark.parametrize('entry', ['encode_async', 'progressive', 'free functions'])
def test_every_encode_entry_replays(entry, emulated, monkeypatch):
    """encode_async, the progressive encode (its DCT stage; the scan is
    numpy, as in JAX) and the free functions replay their captures on the
    second call, with the eager bytes."""
    frames = [torch.from_numpy(_image(seed, 72, 136)) for seed in (4, 5)]
    jpeg = tt.Jpeg()
    calls = {
        'encode_async': lambda x: jpeg.encode_async(x, 90).result(),
        'progressive': lambda x: jpeg.encode(x, 90, progressive=True),
        'free functions': lambda x: T.encode_jpeg_async(x, 92).result(),
    }
    eager = {
        'encode_async': lambda x: T.encode_jpeg(x, 90, entropy='device'),
        'progressive': lambda x: T.encode_jpeg(x, 90, progressive=True),
        'free functions': lambda x: T.encode_jpeg(x, 92, entropy='device'),
    }
    if entry == 'free functions':
        for g in (T._FREE.dct, T._FREE.scan):
            g._captured.clear()
    call = calls[entry]
    call(frames[0])
    copies = _host_copies(monkeypatch)
    got = call(frames[1])
    assert copies == []
    assert [g.replays for g in emulated] == ([1] if entry == 'progressive' else [1, 1])
    monkeypatch.undo()
    np.testing.assert_array_equal(got, eager[entry](frames[1]))


class _Yielding(_Emulated):
    """The emulated graph, sleeping between the copy-in and the replay's
    run: without the wrapper's lock another thread's copy-in lands there."""

    def replay(self):
        time.sleep(0.05)
        super().replay()


def test_two_threads_through_one_jpeg_get_their_own_bytes(emulated, monkeypatch):
    """Two threads encode different frames through one Jpeg at once, each
    three times; every encode gives its own frame's eager bytes.  (With
    the Graphed lock removed, a thread's replay reads the other's frame
    from the shared static buffers, and this fails.)"""
    monkeypatch.setattr(_graph, '_new_graph', lambda: emulated.append(_Yielding()) or emulated[-1])
    frames = [torch.from_numpy(_image(seed, 72, 136)) for seed in (6, 7)]
    want = [_eager_encode(f, 90) for f in frames]
    jpeg = tt.Jpeg()
    jpeg.encode(frames[0], 90, entropy='device')      # eager, then the captures
    start = threading.Barrier(2)
    got = {0: [], 1: []}

    def encode(k):
        start.wait()
        for _ in range(3):
            got[k].append(jpeg.encode(frames[k], 90, entropy='device'))

    threads = [threading.Thread(target=encode, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert _captures(jpeg) == (1, 1) and [g.replays for g in emulated] == [6, 6]
    for k in (0, 1):
        for data in got[k]:
            np.testing.assert_array_equal(data, want[k])


def test_streaming_executor_replays_in_both_modes(emulated):
    """The streaming executor at 64x48, batch 2, in both JPEG modes (host
    mode: two worker threads through one Jpeg): the processor's program
    and the encoder's stages replay, the encoder's graphs sit on the
    processor's pool, and both modes give the eager executor's bytes."""
    from test_torch_streaming import SMALL, _frames, _port_processor

    h, w, n = 48, 64, 6
    frames = _frames(np.random.default_rng(11), h, w, n)
    runs = {}
    for device_jpeg in (True, False):
        proc = _port_processor(SMALL, w, h, n)
        ex = StreamingExecutor(proc, batch_size=2, jpeg_quality=90, jpeg_workers=2,
                               keep_images=False, device_jpeg=device_jpeg)
        assert ex._jpeg._stages.dct.pool is proc._graph_pool
        assert ex._jpeg._stages.scan.pool is proc._graph_pool
        runs[device_jpeg] = {r.name: r.jpeg for r in ex.run(frames)}
        dct, scan = ex._jpeg._stages.dct, ex._jpeg._stages.scan
        # the DCT stage captures both frame orientations (rotate_90 on odd
        # frames); their blocks have one shape, so the scan captures once
        assert len(dct._captured) == 2
        assert len(scan._captured) == (1 if device_jpeg else 0)
    assert all(g.replays for g in emulated)
    proc = _port_processor(SMALL, w, h, n)
    eager = StreamingExecutor(proc, batch_size=2, jpeg_quality=90, keep_images=False,
                              device_jpeg=True)
    eager._jpeg._stages = _plain_stages()
    proc._fused = proc._fused.fn
    want = {r.name: r.jpeg for r in eager.run(frames)}
    assert runs[True] == want and runs[False] == want


def test_failed_capture_raises(emulated, monkeypatch):
    """A capture of the DCT stage that fails raises with its cause; the
    encode does not fall back to the eager stage."""
    def refuse(graph, pool, fn, inputs):
        raise RuntimeError('operation not permitted when stream is capturing')

    monkeypatch.setattr(_graph, '_record', refuse)
    with pytest.raises(RuntimeError, match='capturing _jpeg_device_stage as a CUDA graph'):
        tt.Jpeg().encode(torch.from_numpy(_image(8, 72, 136)), 90)


def test_owners_of_the_graphs():
    """A Jpeg owns its pair on a pool of its own; the free functions share
    one pair; the preview window's encoder is one Jpeg for every preview."""
    from tpu_darktable_torch.scripts.view_raw import jpeg_utils

    a, b = tt.Jpeg(), tt.Jpeg()
    assert a._stages.dct is not b._stages.dct and a._stages.dct.pool is a._stages.scan.pool
    assert a._stages.dct.fn is T._jpeg_device_stage and a._stages.scan.fn is T._scan
    assert T._FREE.dct.pool is T._FREE.scan.pool
    assert isinstance(jpeg_utils._JPEG, tt.Jpeg)


def test_graphs_of_one_pool_replay_one_at_a_time(emulated, monkeypatch):
    """Two threads replay two graphs of one pool at once (as the streaming
    executor's JPEG workers and its main thread do): a replay, from its
    copy-in to the clone of its outputs, never overlaps another replay of
    the pool, since a graph's static outputs may lie in the memory where
    another graph of the pool keeps its intermediates."""
    inside, overlaps = [], []
    real = _graph._Captured.replay

    def replay(self, args):
        overlaps.extend(inside)
        inside.append(self)
        try:
            time.sleep(0.02)
            return real(self, args)
        finally:
            inside.remove(self)

    monkeypatch.setattr(_graph._Captured, 'replay', replay)
    pool = _graph.GraphPool()
    graphs = (_graph.Graphed(lambda x: x * 2, pool), _graph.Graphed(lambda x: x + 1, pool))
    x = torch.arange(4.0)
    for g in graphs:
        g(x)
    start = threading.Barrier(2)
    got = {0: [], 1: []}

    def run(k):
        start.wait()
        for _ in range(5):
            got[k].append(graphs[k](x))

    threads = [threading.Thread(target=run, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert overlaps == [] and [g.replays for g in emulated] == [5, 5]
    assert all(torch.equal(v, x * 2) for v in got[0]) and all(torch.equal(v, x + 1) for v in got[1])
