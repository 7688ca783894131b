"""Build the CUDA sources of csrc/ into shared libraries and load them.

Each source is compiled by its own `nvcc` process into a shared library
with a plain C interface, loaded with ctypes.  Builds start together and
run in parallel; a library is named by a hash of its source and flags, so
an unchanged source is not rebuilt.  Nothing here runs at import time.

The build directory is `build/kernels` at the root of the checkout, a
user cache directory for an installed package (`_paths.build_root`), or
TD_TORCH_BUILD_DIR.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from .._paths import build_root

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
# One library a source; bilateral_fused.cu serves kernels/bilateral_band.py too.
SOURCES = {
    'rcd_interior': 'rcd_interior.cu',
    'color_smooth_diffs': 'color_smooth.cu',
    'grid_blur_xyz': 'grid_blur.cu',
    'wavelet_core': 'wavelet.cu',
    'nlm_core': 'nlm.cu',
    'wiener_tile_core': 'wiener_core.cu',
    'bilateral_fused': 'bilateral_fused.cu',
    'jpeg_entropy': 'jpeg_entropy.cu',
    # the tracer's device mark (utils/timing.py), not a kernel of the pipeline
    'trace_mark': 'mark.cu',
}
# --fmad=false: no a*b+c contraction, so the kernels round like their plain
# versions.  Never --use_fast_math: pow/exp/division must stay IEEE.
NVCC_FLAGS = [
    '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
    '-shared', '-Xcompiler', '-fPIC', '--fmad=false', '-Xptxas', '-v',
]

_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return build_root('kernels')


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    default = Path('/usr/local/cuda/bin/nvcc')
    if default.exists():
        return str(default)
    raise RuntimeError('nvcc not found on PATH or under /usr/local/cuda/bin')


def _lib_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f'lib{name}-{digest}.so'


def build(names=None) -> dict[str, float]:
    """Build the named kernels (all by default), one nvcc each, in parallel.

    Returns {name: seconds} for the libraries that were built now; raises
    with the compiler's output if any build fails.
    """
    names = list(SOURCES) if names is None else list(names)
    todo = {n: _lib_path(n) for n in names if not _lib_path(n).exists()}
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_suffix(f'.tmp{os.getpid()}')
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix('.log').write_text(log)
        if proc.returncode != 0:
            failed.append(f'--- {name} (nvcc exit {proc.returncode}) ---\n{log}')
            continue
        tmp.replace(out)
    if failed:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if status != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with cudaError_t {status}')


__all__ = ['NVCC_FLAGS', 'SOURCES', 'build', 'build_dir', 'check', 'load']
