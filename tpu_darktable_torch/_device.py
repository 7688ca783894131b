"""Device resolution for the port's public entry points, the device
constants of its ops, and the record of a CUDA graph capture.

Entry points run on the card unless the caller asks for the CPU.  Asking
for the card where there is none raises: nothing falls back to the CPU.

A constant that an op needs on the device every call (a gain tile, a white
point, a divisor) is made once for each value and device and kept in a
bounded cache (`device_cache`).

A CUDA graph's capture (_graph.py) runs nothing, yet what the program
does while it is captured must be accounted for: the kernel launches it
counts (kernels.count), the tracer's marks it makes (utils/timing.py) and
the device constants it reads, whose raw pointers the graph holds.  So
while a thread captures, all three go to its record (`capturing`), which
the graph keeps: each replay counts the record's launches and logs its
marks, and the constants stay alive after the caches have dropped them.
Only the capturing thread's record is used: a capture in one thread (the
streaming executor's JPEG workers) leaves the counts and marks of what
other threads run meanwhile where they belong.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

# .capture: the record of the capture this thread runs, or None
_local = threading.local()
_caches: list = []


def resolve_device(device=None) -> torch.device:
    """None -> 'cuda'; a CUDA device that is not present raises."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {dev} was requested but torch.cuda.is_available() is False; '
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return dev


def to_device(values, device, dtype=None) -> torch.Tensor:
    """Values (a number, a sequence, an array or a tensor) as a tensor on
    `device`, without making the host wait for the card: host values reach
    a card through pinned memory by a non-blocking copy, where a copy from
    pageable memory would first wait for all the work enqueued before it."""
    dev = torch.device(device)
    t = torch.as_tensor(values, dtype=dtype)
    if dev.type != 'cuda' or t.is_cuda:
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def device_cache(maxsize: int):
    """functools.lru_cache for a function whose result holds tensors on a
    device; each value it returns while the calling thread captures is
    also kept in its record (`capturing`)."""
    def decorate(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            value = cached(*args, **kwargs)
            record = current_capture()
            if record is not None:
                record.held.append(value)
            return value

        wrapper.cache_clear = cached.cache_clear
        wrapper.cache_info = cached.cache_info
        _caches.append(wrapper)
        return wrapper
    return decorate


@dataclass
class Capture:
    """What one thread does while it captures a CUDA graph."""
    launches: dict = field(default_factory=dict)   # kernel launches by name (kernels.count)
    marks: list = field(default_factory=list)      # the tracer's marks: (mark id, name)
    held: list = field(default_factory=list)       # the device constants it read


def current_capture() -> Capture | None:
    """The record of the capture the calling thread runs, if it runs one."""
    return getattr(_local, 'capture', None)


@contextlib.contextmanager
def capturing():
    """Inside the block, what the calling thread launches, marks and reads
    from the device caches goes to the record it yields."""
    outer = current_capture()
    _local.capture = record = Capture()
    try:
        yield record
    finally:
        _local.capture = outer


def clear_caches() -> None:
    """Empty every device cache (what a graph holds stays alive)."""
    for cache in _caches:
        cache.cache_clear()


@device_cache(maxsize=512)
def _constant_on(data: bytes, dtype: str, shape: tuple, device: torch.device) -> torch.Tensor:
    return to_device(np.frombuffer(data, dtype).reshape(shape).copy(), device)


def constant_on(values, device, dtype=None) -> torch.Tensor:
    """Host values as `to_device` makes them, made once for each value,
    type and device.  The result is shared: callers do not write to it."""
    a = torch.as_tensor(values, dtype=dtype).numpy()
    return _constant_on(a.tobytes(), a.dtype.str, a.shape, torch.device(device))


def scalar_on(value: float, device) -> torch.Tensor:
    """float32(value) as a 0-d tensor on `device`, made once.  As a divisor
    it keeps the card's result equal to the CPU's: PyTorch's CUDA division
    by a Python number multiplies by the reciprocal, by a tensor it
    divides."""
    return constant_on(np.float32(value), device)


__all__ = ['Capture', 'capturing', 'clear_caches', 'constant_on', 'current_capture',
           'device_cache', 'resolve_device', 'scalar_on', 'to_device']
