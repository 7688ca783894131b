"""Device resolution for the port's public entry points.

Entry points run on the card unless the caller asks for the CPU.  Asking
for the card where there is none raises: nothing falls back to the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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


@functools.lru_cache(maxsize=64)
def scalar_on(value: float, device) -> torch.Tensor:
    """float32(value) as a 0-d tensor on `device`, made once.  As a divisor
    it keeps the card's result equal to the CPU's: PyTorch's CUDA division
    by a Python number multiplies by the reciprocal, by a tensor it
    divides."""
    return to_device(np.float32(value), device)


__all__ = ['resolve_device', 'scalar_on', 'to_device']
