"""Hand-written Hopper kernels of the port and their launch counts.

Each module here holds one kernel's wrapper and its plain PyTorch version.
A wrapper launches the CUDA kernel for a CUDA tensor and runs the plain
version for a CPU tensor; it adds one to `launches[name]` where it
launches the kernel, and nowhere else.  The CUDA sources live in
`tpu_darktable_torch/csrc/` and are built at first use (kernels/_build.py).

The counts mean launches that ran.  A CUDA graph's capture (_graph.py)
enqueues nothing that runs, so what its wrapper calls count inside the
capture goes to the capture's own dict (`uncounted`), and each replay adds
what its capture recorded (`add_launches`).  The redirection is the
capturing thread's alone: a capture in one thread (the streaming
executor's JPEG workers) leaves the counts of launches that other threads
run meanwhile where they belong.
"""

from __future__ import annotations

import contextlib
import threading

# the dict the calling thread counts into while it captures, if it does
_local = threading.local()


class _Launches(dict):
    """Launch counts by kernel name; inside `uncounted` the calling
    thread reads and writes its capture's dict instead."""

    def __getitem__(self, name):
        made = getattr(_local, 'made', None)
        return super().__getitem__(name) if made is None else made.get(name, 0)

    def __setitem__(self, name, n):
        made = getattr(_local, 'made', None)
        if made is None:
            super().__setitem__(name, n)
        else:
            made[name] = n


launches: dict[str, int] = _Launches({
    'rcd_interior': 0,
    'color_smooth_diffs': 0,
    'bilateral_band': 0,
    'grid_blur_xyz': 0,
    'wavelet_core': 0,
    'nlm_core': 0,
    'wiener_tile_core': 0,
    'bilateral_fused': 0,
    'jpeg_entropy': 0,
})


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@contextlib.contextmanager
def uncounted():
    """What the calling thread counts inside the block goes to the dict
    it yields, by name, and not to `launches`."""
    outer = getattr(_local, 'made', None)
    made: dict[str, int] = {}
    _local.made = made
    try:
        yield made
    finally:
        _local.made = outer


def add_launches(counts: dict[str, int]) -> None:
    for name, n in counts.items():
        launches[name] += n


__all__ = ['add_launches', 'launches', 'reset_launches', 'uncounted']
