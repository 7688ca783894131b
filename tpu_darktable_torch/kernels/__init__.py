"""Hand-written Hopper kernels of the port and their launch counts.

Each module here holds one kernel's wrapper and its plain PyTorch version.
A wrapper launches the CUDA kernel for a CUDA tensor and runs the plain
version for a CPU tensor; it adds one to `launches[name]` where it
launches the kernel, and nowhere else.  The CUDA sources live in
`tpu_darktable_torch/csrc/` and are built at first use (kernels/_build.py).
"""

from __future__ import annotations

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


__all__ = ['launches', 'reset_launches']
