"""Hand-written Hopper kernels of the port and their launch counts.

Each module here holds one kernel's wrapper and its plain PyTorch version.
A wrapper launches the CUDA kernel for a CUDA tensor and runs the plain
version for a CPU tensor; it adds one to `launches[name]` where it
launches the kernel, and nowhere else.  The CUDA sources live in
`tpu_darktable_torch/csrc/` and are built at first use (kernels/_build.py).

The counts mean launches that ran.  A CUDA graph's capture (_graph.py)
enqueues nothing that runs, so what its wrapper calls count is taken back
(`uncounted`), and each replay adds what its capture recorded
(`add_launches`).
"""

from __future__ import annotations

import contextlib

launches: dict[str, int] = {
    'rcd_interior': 0,
    'color_smooth_diffs': 0,
    'bilateral_band': 0,
    'grid_blur_xyz': 0,
    'wavelet_core': 0,
    'nlm_core': 0,
    'wiener_tile_core': 0,
    'bilateral_fused': 0,
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@contextlib.contextmanager
def uncounted():
    """Take back the launches counted inside the block; the dict it yields
    holds them, by name, once the block ends."""
    before = dict(launches)
    made: dict[str, int] = {}
    try:
        yield made
    finally:
        made.update({k: n - before[k] for k, n in launches.items() if n != before[k]})
        launches.update(before)


def add_launches(counts: dict[str, int]) -> None:
    for name, n in counts.items():
        launches[name] += n


__all__ = ['add_launches', 'launches', 'reset_launches', 'uncounted']
