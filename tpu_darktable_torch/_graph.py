"""The compiled programs of the port (counterpart of tpu_darktable/_jit.py
and of every `jax.jit` of the JAX package), each a `Graphed` owned as
follows:
- `jax.jit(fused)` (pipeline/image_processor.py:337): ImageProcessor's
  batched program;
- `jit_with_static` (debayer.py:31,39,60,93,124, denoise.py:51,
  local_contrast.py:28,77): the workspace classes' methods and the free
  bilinear5x5_demosaic;
- the timing chains (utils/timing.py:89, scripts/run_benchmark.py:45):
  utils.timing.benchmark_op's chain;
- parallel/mesh.py:56, spatial.py:65,78: the per-shard stages of
  sharded_pipeline, the spatial demosaic's band, and every per-device
  step of the band programs (parallel/spatial_pipeline.py, whose body JAX
  compiles as one shard_map program);
- ops/jpeg.py:195 `_jpeg_device_stage` and ops/jpeg_entropy.py:356
  `_entropy_pack_device`: the JPEG encoder's two programs (ops/jpeg.py
  `_Stages`, one pair a Jpeg and one for the free functions).
(run_benchmark.py:36's fence, a jitted sum read on the host, is
torch.cuda.synchronize in utils/timing.py, and utils/aot.py's compile
cache is kernels/_build.py's.)

XLA compiles a function into one executable, cached on its inputs' shapes
and its static arguments, and runs it as one dispatch.  Here `Graphed(fn)`
does the same for a function of CUDA tensors.  The capture key is each
tensor argument's shape, dtype and device and the value of every other
argument (`jit_with_static`'s static kwargs): a Python number the function
uses is frozen into the graph, so it must be in the key, or be passed as
a tensor, which the replay copies in.  The first call for a key runs `fn`
eagerly, which builds the kernels and fills the device caches, and returns
that result; then `fn` is captured at once into a CUDA graph over static
copies of the tensor arguments.  Each later call with that key copies its
tensor arguments into the static buffers, replays the graph on the current
stream and returns clones of its outputs, so nothing a caller holds
changes on the next call.  Arguments with no tensor on a card go straight
to `fn`: the CPU runs the program eagerly.

What a captured graph needs after its capture:
- the device constants it read (the capture's record, _device.capturing,
  keeps them, whatever the caches drop later);
- no host value copied inside `fn` (a replay would read the pinned buffer
  again, which the host allocator may have reused): the ops take their
  constants from the device caches;
- no synchronisation inside `fn`: a capture that fails raises, with no
  eager fallback.

The kernel launch counts (kernels.launches) mean launches that ran: a
capture adds nothing, each replay adds what its capture's record holds.
The tracer's device marks (utils/timing.py) are kept the same way: a
capture's record keeps the marks it made, each replay logs them.  While
the tracer is on, the key that a wrapper looks its captures up by also
holds the tracing state, so a graph captured with marks is never replayed
without the tracer, nor one without marks under it; each replay is a
`graph.replay` span, each capture a `graph.capture` span and a count of
`graph.captures`, under the owner's name (the function's qualname).

The captures of one wrapper sit in a bounded LRU (`_MAXSIZE` keys); a
dropped entry frees its graph, its static buffers and outputs, and the
constants it held.  The graphs of one owner share a memory pool
(`GraphPool`, one pool a device): an `ImageProcessor` gives its batched
program, its workspaces and its sharded stages one pool.  That is safe
because they replay one at a time on one stream, each replay clones its
outputs before any other graph runs, and the static inputs are cloned
outside the pool.  Memory a dropped graph used goes back to the pool, for
the pool's later captures.  A pool with no graph left keeps its memory
reserved until torch.cuda.empty_cache(), or until an allocation outside a
capture finds the card full.

Threads: the streaming executor's JPEG workers call one encoder's graphs
at once, and those graphs share the processor's pool, whose graphs the
main thread replays meanwhile.  A graph's static outputs may lie in the
memory that another graph of its pool uses for its intermediates, so a
replay and the clone of its outputs must not have another graph of the
pool run between them, and two callers of one graph must not share its
static buffers.  So each wrapper takes its pool's lock around the lookup,
the first call and its capture, and a replay's copy-in, replay and clone;
and one capture runs at a time in the process (`_capture_lock`), on its
device's side stream.  The executor's drainer thread holds `_capture_lock`
around each readback of a batch: the readback's copy runs on a stream
from PyTorch's pool, which may be the capture's side stream.  The callers
enqueue on the legacy default stream, so the card runs their replays in
the order the locks let them through.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from collections import OrderedDict
from dataclasses import dataclass

import torch

from . import _device, kernels
from .utils import timing

# the captures a Graphed wrapper keeps (its least recently used goes first)
_MAXSIZE = 8


def _on_card(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_cuda


def _new_pool():
    return torch.cuda.graph_pool_handle()


def _new_graph():
    return torch.cuda.CUDAGraph()


# a side stream a device to capture on (torch.cuda.graph's default is one
# stream, on the device that was current at its first use)
_capture_streams: dict[int, object] = {}
# held by the capture under way: two threads never capture on one stream
_capture_lock = threading.RLock()


@contextlib.contextmanager
def _capturing(graph, pool):
    """Capture into `graph` on the current device's side stream, after the
    work the current stream has enqueued.  Unlike torch.cuda.graph, no
    synchronize and no emptying of the device and host caches first: a
    capture records work without running it, so it needs no wait, and the
    two cost a workspace's first call tens of ms on an H100.  So a
    capture cannot hand the allocator's cached blocks back to the card:
    what its pool needs must be free beside them.  thread_local: a capture
    may start while other threads (the streaming executor's JPEG workers)
    still copy from the card."""
    index = torch.cuda.current_device()
    if index not in _capture_streams:
        _capture_streams[index] = torch.cuda.Stream(index)
    stream = _capture_streams[index]
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin(pool, capture_error_mode='thread_local')
        try:
            yield
        finally:
            graph.capture_end()


def _record(graph, pool, fn, inputs):
    """fn(*inputs) captured into `graph`; its outputs."""
    with _capturing(graph, pool):
        return fn(*inputs)


def capture_key(args) -> tuple:
    """What the compiled program is specialised on: each tensor argument's
    shape, dtype and device, and every other argument's type and value."""
    return tuple((tuple(a.shape), a.dtype, a.device) if isinstance(a, torch.Tensor)
                 else (type(a), a) for a in args)


def _device_index(dev: torch.device) -> int:
    """The index of a CUDA device (-1, which torch.cuda.device takes for no
    device, for the stand-in the CPU tests use)."""
    return dev.index if dev.type == 'cuda' else -1


class GraphPool:
    """The CUDA graph memory pool of the Graphed wrappers that share it: one
    pool id a device, made at the first capture there.  Once every graph
    of a device's pool is gone, PyTorch's allocators hold the id retired
    until an empty_cache, so the next capture there takes a new id."""

    def __init__(self):
        self._ids: dict[int, tuple[object, weakref.WeakSet]] = {}
        # held by a caller of one of the pool's graphs (see the module docstring)
        self.lock = threading.RLock()

    def handle(self, index: int, graph):
        """The pool id for capturing `graph` on CUDA device `index`."""
        pool, graphs = self._ids.get(index, (None, ()))
        if not graphs:
            pool, graphs = _new_pool(), weakref.WeakSet()
            self._ids[index] = (pool, graphs)
        graphs.add(graph)
        return pool


@dataclass
class _Captured:
    graph: object
    inputs: tuple            # the arguments: static buffers for the tensors
    outputs: tuple           # the static outputs the graph writes
    single: bool             # fn returned one tensor, not a tuple
    made: _device.Capture    # its launches, marks and device constants
    device: torch.device     # its device
    index: int               # its CUDA device

    def replay(self, args):
        with torch.cuda.device(self.index):
            for buf, a in zip(self.inputs, args):
                if isinstance(buf, torch.Tensor):
                    buf.copy_(a)
            if self.made.marks:
                timing.replayed(self.made.marks, self.device)
            self.graph.replay()
            out = tuple(t.clone() for t in self.outputs)
        for name, n in self.made.launches.items():
            kernels.count(name, n)
        return out[0] if self.single else out


class Graphed:
    """`fn` (positional arguments: tensors and hashable values -> a tensor
    or a tuple of tensors) captured once per capture key and replayed; see
    the module docstring.  `pool` is the GraphPool its graphs allocate
    from (a new one if None)."""

    def __init__(self, fn, pool: GraphPool | None = None):
        self.fn = fn
        self.stages = getattr(fn, 'stages', None)
        self.pool = GraphPool() if pool is None else pool
        self.owner = getattr(fn, '__qualname__', None) or repr(fn)
        self._captured: OrderedDict[tuple, _Captured] = OrderedDict()

    def __call__(self, *args):
        if not any(_on_card(a) for a in args):
            return self.fn(*args)
        key = capture_key(args)
        if timing.tracing():
            key += timing.TRACED
        with self.pool.lock:
            entry = self._captured.get(key)
            if entry is not None:
                self._captured.move_to_end(key)
                with timing.span('graph.replay', owner=self.owner):
                    return entry.replay(args)
            out = self.fn(*args)
            while len(self._captured) >= _MAXSIZE:
                self._captured.popitem(last=False)
            self._captured[key] = self._capture(args, key)
        return out

    def _capture(self, args, key) -> _Captured:
        inputs = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
        graph = _new_graph()
        device = next(a.device for a in args if _on_card(a))
        index = _device_index(device)
        try:
            with timing.span('graph.capture', owner=self.owner), _capture_lock, \
                    _device.capturing() as made, torch.cuda.device(index):
                outputs = _record(graph, self.pool.handle(index, graph), self.fn, inputs)
        except Exception as e:
            raise RuntimeError(f'capturing {self.owner} as a CUDA graph failed for inputs {key}: '
                               f'{e}') from e
        timing.count('graph.captures', self.owner)
        single = isinstance(outputs, torch.Tensor)
        return _Captured(graph, inputs, (outputs,) if single else tuple(outputs), single, made,
                         device, index)


__all__ = ['GraphPool', 'Graphed', 'capture_key']
