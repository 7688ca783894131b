"""Hand-written Hopper kernels of the port, their launch path and their
launch counts.

Each module here holds one kernel's wrapper and its plain PyTorch version.
A wrapper checks its arguments and runs the plain version for a CPU
tensor; for a CUDA tensor it allocates the outputs and calls `launch` with
the C entry point's arguments in their order.  The entry points are
declared once, in kernels/_build.py `ENTRIES`; their CUDA sources live in
`tpu_darktable_torch/csrc/` and are built at first use.

`launch` is the one place an entry point is called: it refuses a device
that is not CUDA, passes the device's current stream last, raises on a
nonzero cudaError_t and counts the call's launches.  The counts mean
launches that ran: while the calling thread captures a CUDA graph they go
to its capture record (_device.capturing), and each replay counts what
its capture recorded (_graph.py).
"""

from __future__ import annotations

import torch

from .. import _device
from . import _build

# launches by kernel name, of every entry point that counts them
launches: dict[str, int] = {name: 0 for name, e in _build.ENTRIES.items() if e.counts}
# the entry points bound so far
_bound: dict = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def count(name: str, n: int = 1) -> None:
    """Count `n` launches of kernel `name`: in the calling thread's capture
    record while it captures, else in `launches`."""
    record = _device.current_capture()
    if record is None:
        launches[name] += n
    else:
        record.launches[name] = record.launches.get(name, 0) + n


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point `name` with `args` (a tensor passes its data
    pointer) and the current stream of `device`, and count its launches."""
    entry = _build.ENTRIES[name]
    if device.type != 'cuda':
        raise RuntimeError(f'{name}: unsupported device {device}')
    fn = _bound.get(entry)
    if fn is None:
        fn = _bound[entry] = entry.bind(_build.load(entry.source))
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        status = fn(*ptrs, torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with cudaError_t {status}')
    if entry.counts:
        count(name, entry.counts)


__all__ = ['count', 'launch', 'launches', 'reset_launches']
