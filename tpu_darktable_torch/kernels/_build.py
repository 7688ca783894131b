"""The C entry points of csrc/, declared once (`ENTRIES`), and the build
and loading of their sources.

Each entry point is declared here with its source, its symbol, its
argument types and what a call counts; `Entry.bind` binds a loaded
library's symbol to that declaration, for the port's own launches
(kernels.launch), for builds of variants of a source and for the host
emulation the tests build.

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
from typing import NamedTuple

from .._paths import build_root

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL, _ULL = ctypes.c_longlong, ctypes.c_ulonglong


class Entry(NamedTuple):
    """One C entry point of csrc/: `int symbol(argtypes...)`, the stream
    last, returning a cudaError_t."""
    source: str               # its file in csrc/
    symbol: str               # its exported name
    argtypes: tuple           # the ctypes type of each argument, the stream last
    counts: int = 1           # launches a call adds to kernels.launches (the tracer's mark: none)

    def bind(self, lib: ctypes.CDLL):
        """The entry point in `lib` (a build of `source`, or of a variant
        or an emulation of it) with its declared signature."""
        fn = getattr(lib, self.symbol)
        fn.argtypes = list(self.argtypes)
        fn.restype = ctypes.c_int
        return fn


_BILATERAL = Entry('bilateral_fused.cu', 'bilateral_fused_launch',
                   (_P, _P, _I, _I, _I, _I, _F, _I, _P))
# Every C entry point, by the name kernels.launch takes and kernels.launches
# counts under: bilateral_band and bilateral_fused are two wrappers of one
# entry point, and the tracer's mark (utils/timing.py) counts nothing.
ENTRIES = {
    'rcd_interior': Entry('rcd_interior.cu', 'rcd_interior_launch', (_P, _P) + (_I,) * 6 + (_P,)),
    'color_smooth_diffs': Entry('color_smooth.cu', 'color_smooth_launch',
                                (_P, _P, _P, _I, _I, _I, _P)),
    'bilateral_band': _BILATERAL,
    'grid_blur_xyz': Entry('grid_blur.cu', 'grid_blur_launch', (_P, _P, _I, _I, _I, _I, _P)),
    'wavelet_core': Entry('wavelet.cu', 'wavelet_launch', (_P,) * 5 + (_I,) * 4 + (_P,)),
    'nlm_core': Entry('nlm.cu', 'nlm_launch', (_P, _P) + (_I,) * 5 + (_F, _P)),
    'wiener_tile_core': Entry('wiener_core.cu', 'wiener_core_launch',
                              (_P,) * 4 + (_I,) * 5 + (_P,)),
    'bilateral_fused': _BILATERAL,
    # lengths, place, emit
    'jpeg_entropy': Entry('jpeg_entropy.cu', 'jpeg_entropy_launch',
                          (_P,) * 4 + (_LL, _LL, _I, _LL) + (_P,) * 7, counts=3),
    # rgb, lab, lum, pixels, clipped_l / lab, lum, rgb, pixels
    'lab_split': Entry('lab.cu', 'lab_split_launch', (_P, _P, _P, _LL, _I, _P)),
    'lab_merge': Entry('lab.cu', 'lab_merge_launch', (_P, _P, _P, _LL, _P)),
    'trace_mark': Entry('mark.cu', 'trace_mark_launch', (_P, _P, _ULL, _LL, _P), counts=0),
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


def _lib_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f'lib{src.stem}-{digest}.so'


def build(sources=None) -> dict[str, float]:
    """Build the named sources of csrc/ (every entry's by default), one
    nvcc each, in parallel.

    Returns {source: seconds} for the libraries that were built now; raises
    with the compiler's output if any build fails.
    """
    if sources is None:
        sources = dict.fromkeys(e.source for e in ENTRIES.values())
    todo = {s: _lib_path(s) for s in sources if not _lib_path(s).exists()}
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for source, out in todo.items():
        tmp = out.with_suffix(f'.tmp{os.getpid()}')
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / source)]
        procs[source] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True), tmp, out)
    seconds, failed = {}, []
    for source, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[source] = time.perf_counter() - t0
        out.with_suffix('.log').write_text(log)
        if proc.returncode != 0:
            failed.append(f'--- {source} (nvcc exit {proc.returncode}) ---\n{log}')
            continue
        tmp.replace(out)
    if failed:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failed))
    return seconds


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source of csrc/, built first if needed."""
    lib = _libs.get(source)
    if lib is None:
        build([source])
        lib = _libs[source] = ctypes.CDLL(str(_lib_path(source)))
    return lib


__all__ = ['CSRC', 'ENTRIES', 'Entry', 'NVCC_FLAGS', 'build', 'build_dir', 'load']
