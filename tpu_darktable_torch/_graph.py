"""The compiled program of the batched entry point (counterpart of
tpu_darktable/_jit.py and of `self._fused = jax.jit(fused)` in the JAX
package's ImageProcessor).

XLA compiles a batch into one executable, cached on its inputs' shapes, and
runs it as one dispatch.  Here `Graphed(fn)` does the same for a function
of CUDA tensors: the first call for a key (each tensor argument's shape,
dtype and device) runs `fn` eagerly, which builds the kernels and fills the
device caches, and returns that result; then `fn` is captured at once into
a CUDA graph over static copies of the arguments.  Each later call with
that key copies its arguments into the static buffers, replays the graph
on the current stream and returns clones of its outputs, so nothing a
caller holds changes on the next call.  Arguments on the CPU go straight
to `fn`: the CPU runs the program eagerly.

What a captured graph needs after its capture:
- the device constants it read (_device.device_cache hands them out during
  the capture, and the entry keeps them, whatever the caches drop later);
- no host value copied inside `fn` (a replay would read the pinned buffer
  again, which the host allocator may have reused): the ops take their
  constants from the device caches;
- no synchronisation inside `fn`: a capture that fails raises, with no
  eager fallback.

The kernel launch counts (kernels.launches) mean launches that ran: a
capture adds nothing, each replay adds what its capture recorded.  The
graphs of one wrapper share one memory pool, since they replay one after
another on one stream; the pool and the graphs go with the wrapper.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from . import _device, kernels


def _on_card(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_cuda


def _new_pool():
    return torch.cuda.graph_pool_handle()


def _new_graph():
    return torch.cuda.CUDAGraph()


def _capturing(graph, pool):
    # thread_local: a capture may start while other threads (the streaming
    # executor's JPEG workers) still copy from the card
    return torch.cuda.graph(graph, pool=pool, capture_error_mode='thread_local')


def capture_key(args) -> tuple:
    """What the compiled program is specialised on: each argument's shape,
    dtype and device."""
    return tuple((tuple(a.shape), a.dtype, a.device) for a in args)


def _device_index(args) -> int:
    """The CUDA device of the arguments (-1, which torch.cuda.device takes
    for no device, for the stand-in the CPU tests use)."""
    dev = next(a.device for a in args if _on_card(a))
    return dev.index if dev.type == 'cuda' else -1


@dataclass
class _Captured:
    graph: object
    inputs: tuple            # the static buffers the graph reads
    outputs: tuple           # the static outputs it writes
    held: list               # the device constants it read
    launches: dict           # kernel launches a replay runs, by name
    seconds: float           # host seconds the capture took
    index: int               # its CUDA device

    def replay(self, args):
        with torch.cuda.device(self.index):
            for buf, a in zip(self.inputs, args):
                buf.copy_(a)
            self.graph.replay()
            out = tuple(t.clone() for t in self.outputs)
        kernels.add_launches(self.launches)
        return out


class Graphed:
    """`fn` (positional tensor arguments -> a tuple of tensors) captured
    once per capture key and replayed; see the module docstring."""

    def __init__(self, fn):
        self.fn = fn
        self.stages = getattr(fn, 'stages', None)
        self._captured: dict[tuple, _Captured] = {}
        self._pool = None

    def __call__(self, *args):
        if not any(_on_card(a) for a in args):
            return self.fn(*args)
        key = capture_key(args)
        entry = self._captured.get(key)
        if entry is not None:
            return entry.replay(args)
        out = self.fn(*args)
        self._captured[key] = self._capture(args, key)
        return out

    def _capture(self, args, key) -> _Captured:
        inputs = tuple(a.clone() for a in args)
        if self._pool is None:
            self._pool = _new_pool()
        graph = _new_graph()
        index = _device_index(args)
        t0 = time.perf_counter()
        try:
            with kernels.uncounted() as made, _device.holding() as held, \
                    torch.cuda.device(index), _capturing(graph, self._pool):
                outputs = self.fn(*inputs)
        except Exception as e:
            raise RuntimeError(f'capturing the batched program as a CUDA graph failed for '
                               f'inputs {key}: {e}') from e
        return _Captured(graph, inputs, outputs, held, made, time.perf_counter() - t0, index)


__all__ = ['Graphed', 'capture_key']
