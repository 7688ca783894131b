"""Plain stand-ins for the measured package's device caches: each value is
made where it is asked for, with no cache and no capture bookkeeping."""

from __future__ import annotations

import functools

import numpy as np
import torch


def to_device(values, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(values, dtype=dtype).to(torch.device(device))


def device_cache(maxsize: int):
    return functools.lru_cache(maxsize=maxsize)


def constant_on(values, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(values, dtype=dtype).to(torch.device(device))


def scalar_on(value: float, device) -> torch.Tensor:
    return constant_on(np.float32(value), device)
