"""Device resolution for the port's public entry points, and the device
constants of its ops.

Entry points run on the card unless the caller asks for the CPU.  Asking
for the card where there is none raises: nothing falls back to the CPU.

A constant that an op needs on the device every call (a gain tile, a white
point, a divisor) is made once for each value and device and kept in a
bounded cache (`device_cache`).  A CUDA graph (_graph.py) holds the raw
pointers of the constants its program read while it was captured, so
while a capture runs every cache reports the values it hands out to the
capturing thread (`holding`), and the graph keeps them alive after the
cache has dropped them.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch

# .held: the values the device caches hand out to this thread while it
# captures, or None
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
    device; each value it returns while a capture runs is also appended to
    the capture's list (`holding`)."""
    def decorate(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            value = cached(*args, **kwargs)
            held = getattr(_local, 'held', None)
            if held is not None:
                held.append(value)
            return value

        wrapper.cache_clear = cached.cache_clear
        wrapper.cache_info = cached.cache_info
        _caches.append(wrapper)
        return wrapper
    return decorate


@contextlib.contextmanager
def holding():
    """Collect the values that the device caches hand out to this thread
    inside the block into the list it yields."""
    outer = getattr(_local, 'held', None)
    _local.held = held = []
    try:
        yield held
    finally:
        _local.held = outer


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


__all__ = ['clear_caches', 'constant_on', 'device_cache', 'holding', 'resolve_device',
           'scalar_on', 'to_device']
