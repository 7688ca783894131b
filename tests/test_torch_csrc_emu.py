"""The CUDA sources of the port, compiled for the host and run on the CPU.

There is no nvcc here, so each csrc/*.cu is rewritten into C++ against a
small emulation of CUDA (EMU_HEADER below: every block runs its blockDim
threads as fibres with a working __syncthreads(), blocks one after another),
built with g++ -ffp-contract=off (like nvcc --fmad=false) and called
through the same C entry points the wrappers use, each bound through its
declaration in kernels/_build.py `ENTRIES`, which is held against the
sources' prototypes here too.  It checks the kernels'
indexing, halos and arithmetic against their plain versions, bit for bit
(the Wiener tile core, an FFT whose sums cannot run in its plain version's
order, against the function in float64 and against the plain version, each
at a stated tolerance);
it cannot see every race, launch limits or anything the GPU compiler
refuses, which only chip_smoke.py on the card can.
"""

import ctypes
import ctypes.util
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_darktable_torch.kernels._build import CSRC, ENTRIES
from tpu_darktable_torch.kernels.bilateral_band import bilateral_band_plain
from tpu_darktable_torch.kernels.bilateral_fused import bilateral_fused_plain
from tpu_darktable_torch.kernels.color_smooth import color_smooth_diffs_plain
from tpu_darktable_torch.kernels.grid_blur import grid_blur_xyz_plain
from tpu_darktable_torch.kernels.jpeg_entropy import (CHUNK, blocks_per_mcu, jpeg_entropy_plain,
                                                      table_entries)
from tpu_darktable_torch.kernels.lab import lab_merge_plain, lab_split_plain
from tpu_darktable_torch.kernels.nlm import nlm_core_plain
from tpu_darktable_torch.kernels.rcd_interior import RING, rcd_interior_plain
from tpu_darktable_torch.kernels.wavelet import wavelet_core_plain
from tpu_darktable_torch.kernels.wiener_core import _windows, wiener_tile_core_plain
from tpu_darktable_torch.native import jpeg_encode_baseline_native
from tpu_darktable_torch.ops import jpeg as tjpeg
from tpu_darktable_torch.ops.bayer import BayerPattern, site_parities
from tpu_darktable_torch.ops.jpeg_entropy import entropy_encode_device_finalize
from tpu_darktable_torch.ops.wiener import _gaussian_window

import lab_grids

torch.set_num_threads(1)
# CPU emulation of the CUDA subset the csrc/*.cu sources use.  A block's
# threads are ucontext fibres on one OS thread: each runs until it returns or
# reaches __syncthreads(), which yields to the scheduler; the scheduler resumes
# the threads in index order, round after round, so a barrier holds and the
# run is deterministic.  Dynamic shared memory starts as NaN in every block, so
# a read of a value no thread wrote shows.  __syncwarp() yields like
# __syncthreads(); __shfl_sync, __shfl_xor_sync, __shfl_up_sync and
# __ballot_sync pass a value of up to 8 bytes through a per-thread slot
# between two yields (full warps, width 32), so every lane of a warp has to
# reach them together, as the sources' warp-uniform loops do.
EMU_HEADER = r"""#pragma once
#include <cmath>
#include <cstddef>
#include <cstring>
#include <limits>
#include <vector>
#include <algorithm>
#include <functional>
#include <ucontext.h>
using std::min; using std::max;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static
struct dim3 { unsigned x, y, z; dim3(unsigned a=1, unsigned b=1, unsigned c=1): x(a), y(b), z(c) {} };
static dim3 threadIdx(0,0,0), blockIdx(0,0,0), blockDim(1,1,1), gridDim(1,1,1);
static float* emu_smem = nullptr;
typedef void* cudaStream_t;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 0, cudaSuccess = 0, cudaErrorInvalidValue = 1 };
struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
// cp.async (cuda_pipeline_primitives.h) as a plain copy when called, the last zfill bytes
// zero; the source's own __syncthreads() after __pipeline_wait_prior is the
// barrier, so a buffer overwritten before every thread is done reading it shows.
#include <cstring>
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size, size_t zfill = 0) {
  std::memcpy(dst, src, size - zfill);
  std::memset(static_cast<char*>(dst) + (size - zfill), 0, zfill);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
// What cudaFuncSetAttribute returns; a test sets it to see a launcher pass it on.
static int emu_attribute_status = 0;
extern "C" void emu_set_attribute_status(int status) { emu_attribute_status = status; }
template <class F> inline int cudaFuncSetAttribute(F, int, int) { return emu_attribute_status; }
inline int cudaGetLastError() { return 0; }
// The card's nanosecond clock (%globaltimer), which a test sets, and the
// atomics the sources use: blocks and threads run one at a time here.
static unsigned long long emu_clock_ns = 0;
extern "C" void emu_set_clock(unsigned long long ns) { emu_clock_ns = ns; }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  const unsigned long long old = *p; *p = old + v; return old;
}
inline unsigned atomicOr(unsigned* p, unsigned v) { const unsigned old = *p; *p = old | v; return old; }

struct EmuCfg { dim3 grid, block; size_t smem; };
inline EmuCfg emu_cfg(dim3 g, dim3 b, size_t smem = 0, cudaStream_t = nullptr) { return {g, b, smem}; }

struct EmuFibre { ucontext_t ctx; bool done; };
static ucontext_t emu_main;
static std::vector<EmuFibre> emu_fibres;
static std::vector<char> emu_stacks;
static unsigned emu_cur = 0;
static const std::function<void()>* emu_body = nullptr;
inline void __syncthreads() { swapcontext(&emu_fibres[emu_cur].ctx, &emu_main); }
// Every live fibre of the block runs once a round, so a yield is a barrier for
// the threads that reach it together: a warp's, or the block's.
inline void __syncwarp(unsigned = 0xffffffffu) { __syncthreads(); }
static unsigned long long emu_lane_val[1024];
// v of this thread for the value of thread `src` of the block.
template <class T> inline T emu_exchange(T v, unsigned src) {
  static_assert(sizeof(T) <= sizeof(unsigned long long), "a shuffle moves up to 8 bytes");
  std::memcpy(&emu_lane_val[emu_cur], &v, sizeof(T));
  __syncwarp();
  T got;
  std::memcpy(&got, &emu_lane_val[src], sizeof(T));
  __syncwarp();
  return got;
}
template <class T> inline T __shfl_sync(unsigned, T v, int src_lane) {
  return emu_exchange(v, (emu_cur & ~31u) + ((unsigned)src_lane & 31u));
}
template <class T> inline T __shfl_xor_sync(unsigned m, T v, int lane_mask) {
  return __shfl_sync(m, v, (int)((emu_cur & 31u) ^ (unsigned)lane_mask));
}
template <class T> inline T __shfl_up_sync(unsigned, T v, unsigned delta) {
  return emu_exchange(v, (emu_cur & 31u) >= delta ? emu_cur - delta : emu_cur);
}
inline unsigned __ballot_sync(unsigned, int pred) {
  const unsigned first = emu_cur & ~31u;
  emu_lane_val[emu_cur] = pred != 0;
  __syncwarp();
  unsigned bits = 0;
  for (unsigned l = 0; l < 32; ++l) bits |= (unsigned)emu_lane_val[first + l] << l;
  __syncwarp();
  return bits;
}
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline int __clzll(long long x) { return x ? __builtin_clzll((unsigned long long)x) : 64; }
static void emu_entry() {
  (*emu_body)();
  emu_fibres[emu_cur].done = true;
  swapcontext(&emu_fibres[emu_cur].ctx, &emu_main);
}
inline void emu_launch(EmuCfg c, std::function<void()> body) {
  const size_t STACK = 256 * 1024;
  const unsigned nt = c.block.x * c.block.y * c.block.z;
  std::vector<float> buf(c.smem / sizeof(float) + 1);
  emu_smem = buf.data(); gridDim = c.grid; blockDim = c.block; emu_body = &body;
  emu_fibres.resize(nt);
  if (emu_stacks.size() < nt * STACK) emu_stacks.resize(nt * STACK);
  for (unsigned z = 0; z < c.grid.z; ++z) for (unsigned y = 0; y < c.grid.y; ++y)
  for (unsigned x = 0; x < c.grid.x; ++x) {
    std::fill(buf.begin(), buf.end(), std::numeric_limits<float>::quiet_NaN());
    for (unsigned t = 0; t < nt; ++t) {
      EmuFibre& f = emu_fibres[t];
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = emu_stacks.data() + t * STACK;
      f.ctx.uc_stack.ss_size = STACK;
      f.ctx.uc_link = nullptr;
      f.done = false;
      makecontext(&f.ctx, emu_entry, 0);
    }
    for (unsigned live = nt; live > 0;)
      for (unsigned t = 0; t < nt; ++t) {
        if (emu_fibres[t].done) continue;
        emu_cur = t; blockIdx = dim3(x, y, z);
        threadIdx = dim3(t % c.block.x, t / c.block.x % c.block.y, t / (c.block.x * c.block.y));
        swapcontext(&emu_main, &emu_fibres[t].ctx);
        if (emu_fibres[t].done) --live;
      }
  }
}
"""


def _launch(m):
    """`kernel<T...><<<grid, block, smem, stream>>>(args);` -> an emu_launch
    call; C++ itself parses the launch configuration (dim3 or int)."""
    return f'emu_launch(emu_cfg({m.group(2)}), [&]{{ {m.group(1)}({m.group(3)}); }});'


@pytest.fixture(scope='module')
def emu_lib(tmp_path_factory):
    if shutil.which('g++') is None:
        pytest.skip('needs g++ to build the host emulation')
    out = tmp_path_factory.mktemp('emu')
    (out / 'cuda_emu.h').write_text(EMU_HEADER)
    libs = {}
    for cu in sorted(CSRC.glob('*.cu')):
        s = cu.read_text().replace('#include <cuda_runtime.h>', '#include "cuda_emu.h"')
        s = s.replace('#include <cuda_pipeline_primitives.h>', '')
        s = s.replace('extern __shared__ float smem[];', 'float* smem = emu_smem;')
        s = s.replace('asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));', 't = emu_clock_ns;')
        s = re.sub(r'(\w+(?:<[^<>();]*>)?)\s*<<<(.*?)>>>\((.*?)\);', _launch, s, flags=re.S)
        cpp = out / f'{cu.stem}.cpp'
        cpp.write_text(s)
        so = out / f'lib{cu.stem}.so'
        subprocess.run(['g++', '-std=c++17', '-O2', '-ffp-contract=off', '-fno-strict-aliasing',
                        '-shared', '-fPIC',
                        '-o', str(so), str(cpp)], check=True, capture_output=True, timeout=300)
        libs[cu.stem] = ctypes.CDLL(str(so))
    return libs


def _p(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _bound(emu_lib, name):
    """Entry point `name` of the host build of its source, bound through
    the port's declaration of it."""
    entry = ENTRIES[name]
    return entry.bind(emu_lib[Path(entry.source).stem])


# The ctypes type of each C parameter type of a launcher (a pointer: c_void_p).
_C_TYPES = {'int': ctypes.c_int, 'float': ctypes.c_float, 'long long': ctypes.c_longlong,
            'unsigned long long': ctypes.c_ulonglong, 'cudaStream_t': ctypes.c_void_p}


def _prototypes():
    """{symbol: (source, [ctypes type of each parameter])} of every
    `extern "C" int *_launch(...)` in csrc/."""
    out = {}
    for cu in sorted(CSRC.glob('*.cu')):
        for symbol, params in re.findall(r'extern "C" int (\w+_launch)\s*\(([^)]*)\)',
                                         cu.read_text()):
            types = []
            for param in params.split(','):
                decl = ' '.join(re.sub(r'\bconst\b', ' ', param).split())
                types.append(ctypes.c_void_p if '*' in decl else _C_TYPES[decl.rsplit(' ', 1)[0]])
            out[symbol] = (cu.name, types)
    return out


_PROTOTYPES = _prototypes()
_DECLARED = {e.symbol: e for e in ENTRIES.values()}


@pytest.mark.parametrize('symbol', sorted(set(_PROTOTYPES) | set(_DECLARED)))
def test_declared_entry_point_matches_its_prototype(symbol):
    """Every launcher of csrc/ is declared, with its source and with ctypes
    types that match its prototype's parameters type by type, and every
    declared launcher is in csrc/: a changed signature cannot reach the
    card with the old declaration."""
    assert symbol in _PROTOTYPES, f'{symbol} is declared but csrc/ defines no such launcher'
    assert symbol in _DECLARED, f'{symbol} of csrc/ is not declared in kernels/_build.py'
    source, types = _PROTOTYPES[symbol]
    assert _DECLARED[symbol].source == source
    assert list(_DECLARED[symbol].argtypes) == types


@pytest.mark.parametrize('h,w', [
    (28, 60),                # inside one 64x32 tile
    (76, 102), (70, 140),    # two and three tiles each way, ragged right and bottom
    (134, 200),              # five by four tiles, ragged
    (71, 137)])              # odd sizes: the scalar stores
@pytest.mark.parametrize('pattern', ['RGGB', 'BGGR', 'GRBG', 'GBRG'])
def test_rcd_interior_source_on_host(emu_lib, rng, pattern, h, w):
    """Every pattern at sizes from under one tile to several, ragged each
    way: interior (>= RING px from every edge) bit-exact."""
    x = rng.random((h, w)).astype(np.float32)
    out = np.zeros((3, h, w), np.float32)
    rp, bp = site_parities(BayerPattern[pattern])
    fn = _bound(emu_lib, 'rcd_interior')
    assert fn(_p(x), _p(out), h, w, rp[0], rp[1], bp[0], bp[1], None) == 0
    ref = rcd_interior_plain(torch.from_numpy(x), r_par=rp, b_par=bp).numpy()
    r = RING
    np.testing.assert_array_equal(out[:, r:-r, r:-r], ref[:, r:-r, r:-r])


def test_mark_source_on_host(emu_lib):
    """The tracer's mark: each launch appends (the card's clock, its id) at
    the slot its atomicAdd on the count takes, modulo the ring's capacity,
    so the ring keeps the newest marks."""
    capacity = 3
    count = np.zeros(1, np.int64)
    ring = np.full((capacity, 2), -1, np.int64)
    lib = emu_lib['mark']
    fn = _bound(emu_lib, 'trace_mark')
    lib.emu_set_clock.argtypes = [ctypes.c_ulonglong]
    for k in range(5):
        lib.emu_set_clock(10**12 + 1000 * k)
        assert fn(_p(count), _p(ring), capacity, 70 + k, None) == 0
    assert count[0] == 5
    # marks 3 and 4 took slots 0 and 1 again; mark 2 is the oldest left
    np.testing.assert_array_equal(ring, [[10**12 + 3000, 73], [10**12 + 4000, 74],
                                         [10**12 + 2000, 72]])


def test_rcd_interior_source_refuses_non_bayer_sites(emu_lib):
    """R and B sharing a row or a column is no Bayer pattern: the launcher
    returns cudaErrorInvalidValue and launches nothing."""
    x = np.ones((40, 40), np.float32)
    out = np.full((3, 40, 40), -1.0, np.float32)
    fn = _bound(emu_lib, 'rcd_interior')
    assert fn(_p(x), _p(out), 40, 40, 0, 0, 0, 1, None) == 1
    assert fn(_p(x), _p(out), 40, 40, 0, 1, 1, 1, None) == 1
    assert (out == -1.0).all()


# Each source whose launcher asks for dynamic shared memory: the launcher's
# name, and arguments on a small valid input (x (1, 20, 24), out (3, 20, 24),
# thr (1,)) that take the path with the cudaFuncSetAttribute call.
ATTRIBUTE_LAUNCHES = {
    'rcd_interior': ('rcd_interior', lambda x, o, t: (x, o, 20, 24, 0, 0, 1, 1, None)),
    'color_smooth': ('color_smooth_diffs', lambda x, o, t: (o, x, o, 20, 24, 1, None)),
    'wavelet': ('wavelet_core', lambda x, o, t: (x, t, o, o, o, 1, 20, 24, 2, None)),
    'nlm': ('nlm_core', lambda x, o, t: (x, o, 1, 20, 24, 2, 1, 10.0, None)),
    'bilateral_fused': ('bilateral_fused', lambda x, o, t: (x, o, 20, 24, 1, 6, 0.2, 0, None)),
    'wiener_core': ('wiener_tile_core', lambda x, o, t: (x, o, t, o, 16, 1, 1, 1, 1, None)),
}


@pytest.mark.parametrize('lib', sorted(ATTRIBUTE_LAUNCHES))
def test_launcher_returns_attribute_status(emu_lib, rng, lib):
    """Every launcher that asks for dynamic shared memory returns the status
    of cudaFuncSetAttribute when it is not 0 (a refused attribute means a
    launch that never runs), and launches as before when it is 0."""
    assert set(ATTRIBUTE_LAUNCHES) == {cu.stem for cu in CSRC.glob('*.cu')
                                       if 'cudaFuncSetAttribute' in cu.read_text()}
    x = rng.random((1, 20, 24)).astype(np.float32)
    out = np.zeros((3, 20, 24), np.float32)
    thr = np.full(1, 0.1, np.float32)
    name, args = ATTRIBUTE_LAUNCHES[lib]
    fn = _bound(emu_lib, name)
    emu_lib[lib].emu_set_attribute_status(7)
    try:
        assert fn(*args(_p(x), _p(out), _p(thr))) == 7
    finally:
        emu_lib[lib].emu_set_attribute_status(0)
    assert fn(*args(_p(x), _p(out), _p(thr))) == 0


@pytest.mark.parametrize('h,w,n_passes,ties', [
    (28, 60, 3, False),                    # under one tile (124 x 32 at N = 3)
    (32, 124, 3, False),                   # exactly one tile
    (70, 300, 3, False), (97, 260, 3, False),   # ragged each way; an inside block at 97 x 260
    (70, 45, 1, False), (97, 260, 1, False), (97, 260, 2, False),
    (70, 45, 3, False), (70, 45, 5, False), (97, 260, 5, False),
    (70, 140, 32, False), (20, 30, 32, False),  # N = 32: a 66-px tile, the halo wider than the image
    (1, 50, 3, False), (40, 1, 3, False), (1, 1, 2, False),   # one pixel high, wide, both
    (97, 260, 3, True), (45, 70, 5, True), (70, 140, 32, True)])
def test_color_smooth_source_on_host(emu_lib, rng, h, w, n_passes, ties):
    """Tiles and halos at every pass count the wrapper takes (1..32), ragged
    tiles, inside blocks, 1-px images and tie-heavy input (8 levels, a third
    of them exactly 0): bit-exact (-0.0 == +0.0)."""
    if ties:
        d = (rng.integers(-4, 4, (2, h, w)) / 8.0).astype(np.float32)
        d[rng.random((2, h, w)) < 1 / 3] = 0.0
        g = (rng.integers(-1, 7, (h, w)) / 8.0).astype(np.float32)
    else:
        d = (rng.random((2, h, w)) - 0.5).astype(np.float32)
        g = (rng.random((h, w)) - 0.1).astype(np.float32)
    out = np.full_like(d, np.nan)
    fn = _bound(emu_lib, 'color_smooth_diffs')
    assert fn(_p(d), _p(g), _p(out), h, w, n_passes, None) == 0
    ref = color_smooth_diffs_plain(torch.from_numpy(d), torch.from_numpy(g), n_passes=n_passes)
    np.testing.assert_array_equal(out, ref.numpy())


@pytest.mark.parametrize('shape,z_mode', [
    ((6, 70, 45), 'derivative'), ((6, 70, 45), 'gaussian'),
    ((3, 33, 97), 'derivative'), ((9, 40, 64), 'gaussian'),
    ((1, 40, 70), 'derivative'), ((1, 40, 70), 'gaussian'),    # gz = 1: every z tap but the centre cut
    ((2, 33, 97), 'derivative'), ((2, 33, 97), 'gaussian'),
    ((5, 70, 140), 'gaussian'), ((5, 70, 140), 'derivative'),  # ragged tiles each way
    ((51, 40, 64), 'derivative'), ((51, 20, 30), 'gaussian'),  # gz = 51 (sigma_r 0.02)
    ((6, 10, 20), 'derivative'), ((6, 1, 7), 'gaussian'),      # smaller than one tile
    ((6, 64, 128), 'derivative')])                             # whole tiles
def test_grid_blur_source_on_host(emu_lib, rng, shape, z_mode):
    """gz from 1 to 51, ragged tiles each way, grids smaller than one tile,
    both z modes: bit-exact."""
    grid = (rng.random(shape) - 0.3).astype(np.float32)
    out = np.full_like(grid, np.nan)
    fn = _bound(emu_lib, 'grid_blur_xyz')
    assert fn(_p(grid), _p(out), *shape, int(z_mode == 'gaussian'), None) == 0
    ref = grid_blur_xyz_plain(torch.from_numpy(grid), z_mode=z_mode)
    np.testing.assert_array_equal(out, ref.numpy())


@pytest.mark.parametrize('shape,levels', [
    ((3, 70, 96), 4), ((2, 33, 40), 3), ((1, 40, 150), 5), ((1, 20, 30), 6), ((1, 9, 7), 1),
    # 3 x 4 tiles, ragged each way, two inside blocks next to rim blocks: every depth
    *[((2, 150, 200), lv) for lv in range(8)],
    # narrower than the deepest step; exactly one tile; one pixel past a tile each way
    ((1, 9, 7), 7), ((3, 64, 64), 2), ((1, 65, 129), 3), ((1, 1, 1), 2), ((2, 140, 70), 1),
    ((1, 3, 300), 30),
    # two ragged strips of the one-launch levels (steps 8 to 64), then a two-pass level
    ((1, 40, 300), 6), ((2, 21, 530), 7), ((1, 20, 530), 8)])
def test_wavelet_source_on_host(emu_lib, rng, shape, levels):
    """The shared-memory tile of the first levels (inside and rim blocks),
    the one-launch levels after it and the two-pass levels after those,
    against the plain version: bit-exact."""
    x = rng.random(shape).astype(np.float32)
    thr = np.array([0.15, 0.1, 0.2][: shape[0]], np.float32)
    out = np.zeros_like(x)
    cur, tmp = np.zeros_like(x), np.zeros_like(x)
    fn = _bound(emu_lib, 'wavelet_core')
    assert fn(_p(x), _p(thr), _p(out), _p(cur), _p(tmp), *shape, levels, None) == 0
    ref = wavelet_core_plain(torch.from_numpy(x), torch.from_numpy(thr), levels=levels)
    np.testing.assert_array_equal(out, ref.numpy())


@pytest.mark.parametrize('shape,sr,pr', [
    ((3, 40, 48), 3, 1), ((1, 37, 70), 2, 2), ((2, 20, 33), 1, 1),
    # the register kernel (C = 3 and 1 at sr=3, pr=1): an inside block among
    # rim blocks with ragged tiles each way, H and W no multiples of the
    # tile or of a thread's 4 rows, images smaller than one tile
    ((3, 70, 101), 3, 1), ((1, 67, 99), 3, 1), ((3, 9, 13), 3, 1), ((1, 5, 40), 3, 1),
    ((3, 33, 31), 3, 1), ((1, 1, 1), 3, 1),
    # the general kernel beside it: other radii, C = 3 and 4, sr=3 with pr=2
    ((3, 35, 45), 2, 1), ((4, 21, 37), 3, 1), ((1, 41, 39), 3, 2), ((3, 6, 5), 1, 0)])
def test_nlm_source_on_host(emu_lib, rng, shape, sr, pr):
    """Against the plain version: atol 1e-6 (libm expf against torch.exp;
    everything else sums in the same order)."""
    x = rng.random(shape).astype(np.float32)
    inv_h2 = 1.0 / (0.1 * 0.1 * (2 * pr + 1) ** 2 * shape[0])
    out = np.zeros_like(x)
    fn = _bound(emu_lib, 'nlm_core')
    assert fn(_p(x), _p(out), *shape, sr, pr, inv_h2, None) == 0
    ref = nlm_core_plain(torch.from_numpy(x), inv_h2, search_radius=sr, patch_radius=pr)
    assert np.abs(out - ref.numpy()).max() <= 1e-6


@pytest.mark.parametrize('wrapper,h,w,s,gz,sr,z_mode', [
    # as kernels/bilateral_band.py launches it: the derivative z taps
    ('band', 60, 84, 2, 6, 0.2, 'derivative'),     # staged; 1 x 2 ragged 64-px tiles
    ('band', 48, 64, 8, 6, 0.2, 'derivative'),
    ('band', 30, 42, 3, 11, 0.1, 'derivative'),    # s does not divide the tile
    ('band', 20, 24, 1, 6, 0.2, 'derivative'),
    # as kernels/bilateral_fused.py launches it
    ('fused', 60, 84, 2, 6, 0.2, 'gaussian'),
    ('fused', 144, 136, 8, 6, 0.2, 'derivative'),  # three tiles a side, s = 8
    ('fused', 20, 24, 1, 6, 0.2, 'gaussian'),
    ('fused', 70, 66, 2, 51, 0.02, 'derivative'),  # gz 51: the launcher shrinks the tile
    ('fused', 120, 240, 120, 6, 0.2, 'derivative'),  # s too large to stage: reads lum directly
    ('fused', 40, 48, 2, 2, 1.0, 'derivative'),    # gz = 2: one slice cell pair, taps mostly cut
    ('fused', 6, 10, 1, 6, 0.2, 'gaussian'),       # a frame smaller than one tile
    ('fused', 100, 140, 4, 6, 0.2, 'derivative'),  # s = 4, 2 x 3 ragged tiles
])
def test_bilateral_source_on_host(emu_lib, rng, wrapper, h, w, s, gz, sr, z_mode):
    """The one-launch kernel behind both wrappers against the plain version
    each is held to: bit-exact (the kernel sums in the plain version's
    order)."""
    lum = (rng.random((h, w)) * 0.95).astype(np.float32)
    lum[:3, :5] = 0.0   # zero luminance next to the pad: the tent at z = 0 must not leak
    out = np.zeros_like(lum)
    fn = _bound(emu_lib, f'bilateral_{wrapper}')
    assert fn(_p(lum), _p(out), h, w, s, gz, sr, int(z_mode == 'gaussian'), None) == 0
    if wrapper == 'band':
        ref = bilateral_band_plain(torch.from_numpy(lum), s=s, gz=gz, sigma_r=sr)
    else:
        ref = bilateral_fused_plain(torch.from_numpy(lum), s=s, gz=gz, sigma_r=sr, z_mode=z_mode)
    np.testing.assert_array_equal(out, ref.numpy())


def _wiener_core_float64(x, sig2, wf, wi, k):
    """The function itself in float64 through numpy.fft, tile by tile."""
    g, hh, ww = x.shape
    tiles = x.astype(np.float64).reshape(g, hh // k, k, ww // k, k).transpose(0, 1, 3, 2, 4)
    wf2 = np.outer(wf, wf).astype(np.float64)
    wi2 = np.outer(wi, wi).astype(np.float64)
    m = tiles.mean(axis=(-2, -1), keepdims=True)
    spec = np.fft.rfft2((tiles - m) * wf2)
    power = spec.real ** 2 + spec.imag ** 2 + 1e-15
    s2 = np.repeat(sig2.astype(np.float64), g // sig2.size)[:, None, None, None, None]
    y = np.fft.irfft2(spec * (np.maximum(power - s2, 0.0) / power), s=(k, k))
    return (y * wi2 + m * (wf2 * wi2)).transpose(0, 1, 3, 2, 4).reshape(x.shape)


@pytest.mark.parametrize('k,g,n_ty,n_tx,n_sig,offset', [
    (32, 4, 2, 3, 1, 0.0), (16, 12, 3, 2, 3, 0.0), (32, 3, 1, 2, 3, -7.0), (16, 4, 2, 5, 4, -7.0),
    # K = 16, 21 tiles: the last warp holds one pair, and that of a single tile
    (16, 3, 1, 7, 3, 0.0),
    # 18 tiles, 9 warps: the last block is one warp; and an odd count at K = 32
    (32, 2, 3, 3, 2, -3.0), (32, 1, 1, 5, 1, 0.0),
    # one tile; K = 16 over more than one block (72 tiles, 18 warps)
    (32, 1, 1, 1, 1, 0.0), (16, 1, 1, 1, 1, -7.0), (16, 2, 6, 6, 2, 0.0)])
def test_wiener_core_source_on_host(emu_lib, rng, k, g, n_ty, n_tx, n_sig, offset):
    """Against the plain version (dense folded-basis einsums, another order,
    the mean subtracted after the transform) within 2e-6 * max(1, max|x|):
    float32 rounding of sums whose terms reach |x| * sum(wf2); and against
    the function in float64 (numpy.fft) within 2e-8 * max(1, max|x|): the
    kernel's own rounding, an FFT's log2 K^2 additions deep, on outputs that
    the two windows scale down to ~1e-2 |x| (observed 4e-9)."""
    x = (rng.random((g, n_ty * k, n_tx * k)) * 0.5 + offset).astype(np.float32)
    sig2 = (rng.random(n_sig) * 0.01 + 0.002).astype(np.float32)
    wf, wi = _gaussian_window(k, 0.3), _gaussian_window(k, 0.25)
    windows = np.ascontiguousarray(_windows(k, wf.tobytes(), wi.tobytes(),
                                            torch.device('cpu')).numpy())
    out = np.full_like(x, np.nan)
    fn = _bound(emu_lib, 'wiener_tile_core')
    assert fn(_p(x), _p(out), _p(sig2), _p(windows), k, g, n_ty, n_tx, n_sig, None) == 0
    scale = max(1.0, np.abs(x).max())
    exact = _wiener_core_float64(x, sig2, wf, wi, k)
    assert np.abs(out - exact).max() <= 2e-8 * scale
    plain = wiener_tile_core_plain(torch.from_numpy(x), torch.from_numpy(sig2), wf, wi, k=k).numpy()
    assert np.abs(out - plain).max() <= 2e-6 * scale


def _emu_jpeg_entropy(lib, comp_blocks, subsampling, ri, cap_words):
    """csrc/jpeg_entropy.cu's three launches on the host: (words, small),
    every output and scratch buffer first filled with a value no launch
    writes."""
    bpm = blocks_per_mcu(len(comp_blocks), subsampling)
    n_mcu = comp_blocks[1].shape[0] if bpm == 4 else comp_blocks[0].shape[0]
    n_iv = -(-n_mcu // ri)
    n_chunks = n_iv * -(-(ri * bpm) // CHUNK)
    words = np.full(n_iv * cap_words, 0x55555555, np.int32)
    small = np.full(n_iv + 2, -7, np.int64)
    bits = np.full(n_chunks * CHUNK, -7, np.int32)
    scratch = np.full(n_chunks + 2 * n_iv, -7, np.int64)
    blocks = [np.ascontiguousarray(b, np.int16) for b in comp_blocks]
    ptrs = [_p(b) for b in blocks] + [None] * (3 - len(blocks))
    fn = ENTRIES['jpeg_entropy'].bind(lib)
    tables = table_entries()
    assert fn(*ptrs, _p(tables), n_mcu, ri, bpm, cap_words, _p(bits), _p(scratch),
              _p(scratch[n_chunks:]), _p(scratch[n_chunks + n_iv:]), _p(small), _p(words),
              None) == 0
    return words, small


def _huffman_tables():
    H = tjpeg._HUFF
    return tuple((H[('dc', t)][0], H[('dc', t)][1], H[('ac', t)][0], H[('ac', t)][1])
                 for t in (0, 1))


def _check_scan(lib, comp_blocks, subsampling, restart_interval, cap_bytes=None):
    """The kernel against the plain version (the stream's words and the
    small tensor, bit for bit) and, through finalize, against the native
    C++ scan (the body's bytes); returns the kernel's small tensor."""
    bpm = blocks_per_mcu(len(comp_blocks), subsampling)
    n_mcu = comp_blocks[1].shape[0] if bpm == 4 else comp_blocks[0].shape[0]
    ri = restart_interval if restart_interval > 0 else n_mcu
    cap_words = -(-(cap_bytes or max(4096, ri * bpm * 40)) // 4)
    words, small = _emu_jpeg_entropy(lib, comp_blocks, subsampling, ri, cap_words)
    plain_words, plain_small = jpeg_entropy_plain(
        [torch.from_numpy(np.asarray(b, np.int16)) for b in comp_blocks], subsampling, ri, cap_words)
    np.testing.assert_array_equal(small, plain_small.numpy())
    if small[-1]:   # overflow: the stream is not defined, the host encodes
        return small
    np.testing.assert_array_equal(words, plain_words.numpy())
    body = entropy_encode_device_finalize({'stream': torch.from_numpy(words),
                                           'small': torch.from_numpy(small),
                                           'n_iv': -(-n_mcu // ri), 'event': None})
    native = jpeg_encode_baseline_native([np.asarray(b, np.int16) for b in comp_blocks],
                                         subsampling, _huffman_tables(),
                                         restart_interval=restart_interval)
    np.testing.assert_array_equal(body, native)
    return small


def _scene_blocks(rng, h, w, subsampling, quality=90):
    """Quantized blocks of a smooth image with noise, from the port's DCT
    stage on the CPU."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / 23) * np.cos(yy / 17), 128 + 70 * np.cos(xx / 11),
                    128 + 50 * np.sin((xx + yy) / 31)], -1)
    img = np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)
    qy, qc = tjpeg.quality_to_tables(quality)
    return [b.numpy() for b in tjpeg._jpeg_device_stage(
        torch.from_numpy(img), torch.from_numpy(qy.astype(np.float32)),
        torch.from_numpy(qc.astype(np.float32)), subsampling=subsampling, swap_br=False)]


@pytest.mark.parametrize('restart_interval', [0, 5, 16])
@pytest.mark.parametrize('subsampling', [0, 1, 2])
def test_jpeg_entropy_source_on_host(emu_lib, rng, subsampling, restart_interval):
    """A 56x120 scene (4:2:2: 56 MCUs, 224 blocks; 4:4:4 and GRAY: 105
    MCUs): intervals of several chunks (restart interval 0: one interval of
    224 or 315 blocks), intervals shorter than a chunk, and a last interval
    short of MCUs (56 and 105 are no multiples of 5 or 16)."""
    comp_blocks = _scene_blocks(rng, 56, 120, subsampling)
    assert not _check_scan(emu_lib['jpeg_entropy'], comp_blocks, subsampling, restart_interval)[-1]


def _extreme_blocks():
    """DC differences of +-2047, runs of 16, 32 and 48 zeros (one, two and
    three folded ZRLs), a nonzero 63rd coefficient (no EOB), an all-zero AC,
    and AC values of +-1023 (size 10)."""
    b = np.zeros((10, 64), np.int16)
    b[0, 0] = 1023                        # diff 1023 from the interval's 0
    b[1, 0] = -1024                       # diff -2047
    b[1, 63] = 3                          # no EOB
    b[2, 0] = 1023                        # diff 2047; all-zero AC: EOB at once
    b[3, 1], b[3, 18] = 1, -1             # run 16: one ZRL
    b[4, 1], b[4, 34] = 2, -7             # run 32: two ZRLs
    b[5, 1], b[5, 50] = 1, 1023           # run 48: three ZRLs, size 10
    b[6, 2] = -1023
    b[7, 63] = -1                         # a lone last coefficient after a run of 62
    b[8, 1:] = np.where(np.arange(63) % 2, 1023, -1023)   # every AC coefficient, the longest items
    b[9, 0], b[9, 15], b[9, 63] = -1024, 5, -5             # run 47 into the last position
    return b


@pytest.mark.parametrize('restart_interval', [0, 3])
@pytest.mark.parametrize('subsampling', [0, 1, 2])
def test_jpeg_entropy_source_extreme_on_host(emu_lib, subsampling, restart_interval):
    b = _extreme_blocks()
    if subsampling == 2:
        comp_blocks = [b]
    elif subsampling == 1:   # 10 MCUs: Y takes the blocks twice, Cb and Cr once, in other orders
        comp_blocks = [np.concatenate([b, b[::-1]]), b[::-1].copy(), np.roll(b, 3, axis=0)]
    else:
        comp_blocks = [b, b[::-1].copy(), np.roll(b, 3, axis=0)]
    assert not _check_scan(emu_lib['jpeg_entropy'], comp_blocks, subsampling, restart_interval)[-1]


@pytest.mark.parametrize('restart_interval', [0, 4])
def test_jpeg_entropy_source_dense_on_host(emu_lib, rng, restart_interval):
    """Dense random coefficients (a quarter nonzero, |v| < 80) over 90 MCUs
    of 4:4:4: every chunk full of long items."""
    mk = lambda n: (rng.integers(-80, 80, (n, 64)) * (rng.random((n, 64)) < 0.25)).astype(np.int16)
    comp_blocks = [mk(90), mk(90), mk(90)]
    assert not _check_scan(emu_lib['jpeg_entropy'], comp_blocks, 0, restart_interval,
                           cap_bytes=1 << 16)[-1]


@pytest.mark.parametrize('subsampling,restart_interval,cap_bytes', [
    (1, 4, 8), (2, 0, 64), (0, 5, 100)])
def test_jpeg_entropy_source_overflow_on_host(emu_lib, rng, subsampling, restart_interval,
                                              cap_bytes):
    """An interval over its capacity: the overflow flag, each interval's
    bytes and the word count as the plain version reports them."""
    comp_blocks = _scene_blocks(rng, 56, 120, subsampling)
    small = _check_scan(emu_lib['jpeg_entropy'], comp_blocks, subsampling, restart_interval,
                        cap_bytes=cap_bytes)
    assert small[-1] == 1


@pytest.mark.parametrize('prev,dc,ac', [
    (-1024, 1024, 0), (1024, -1024, 0), (0, 0, 1024), (0, 0, -1024),
    (-1024, 1023, 1023)])   # the largest baseline values: no overflow
def test_jpeg_entropy_source_flags_out_of_range(emu_lib, prev, dc, ac):
    """A DC difference over 11 bits or an AC value over 10 is no baseline
    coefficient (the DCT stage never makes one): the kernel reports an
    overflow, so the host encodes the frame."""
    b = np.zeros((6, 64), np.int16)
    b[2, 0], b[3, 0], b[4, 7] = prev, dc, ac
    words, small = _emu_jpeg_entropy(emu_lib['jpeg_entropy'], [b], 2, 6, 1024)
    assert small[-1] == (abs(dc - prev) > 2047 or abs(ac) > 1023)


def test_jpeg_entropy_launcher_refuses_bad_arguments(emu_lib):
    """bpm 2, no MCUs or a restart interval of 0: cudaErrorInvalidValue, and
    nothing launched."""
    fn = _bound(emu_lib, 'jpeg_entropy')
    for n_mcu, ri, bpm in ((4, 1, 2), (0, 1, 1), (4, 0, 1)):
        assert fn(*[None] * 4, n_mcu, ri, bpm, 16, *[None] * 7) == 1


# ---- csrc/lab.cu: the LAB round trip ----
#
# The kernels round as PyTorch's CUDA kernels do: a Python number is float32
# before it meets a tensor, and a division by one is a product by its
# reciprocal, taken in double and rounded to float32.  `_card_split` / `_card_merge` are ops/color.py's chain in
# numpy float32 with that rounding, and with the host's powf (the one the
# host build of the source calls), so the source is held to them bit for bit:
# every branch and every rounding.  The CPU chain (true divisions, PyTorch's
# own pow) is held within LAB_SPLIT_ULPS and LAB_MERGE_ULPS.

_F = np.float32
_libm = ctypes.CDLL(ctypes.util.find_library('m'))
_libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
_libm.powf.restype = ctypes.c_float
_host_powf = np.frompyfunc(_libm.powf, 2, 1)
_DELTA = lab_grids.DELTA


def _pow(x, e):
    return _host_powf(x, _F(e)).astype(np.float32)


def _inv(v):
    return _F(1.0 / v)


def _decode(s):
    return np.where(s <= _F(0.04045), s * _inv(12.92),
                    _pow(np.maximum((s + _F(0.055)) * _inv(1.055), _F(1e-38)), 2.4))


def _encode(v):
    return np.where(v <= _F(0.0031308), _F(12.92) * v,
                    _F(1.055) * _pow(np.maximum(v, _F(1e-38)), 1.0 / 2.4) - _F(0.055))


def _lab_f(t):
    return np.where(t > _F(_DELTA ** 3), _pow(np.maximum(t, _F(0.0)), 1.0 / 3.0),
                    _F(1.0 / (3.0 * _DELTA * _DELTA)) * t + _F(4.0 / 29.0))


def _lab_f_inv(t):
    return np.where(t > _F(_DELTA), t * t * t, _F(3.0 * _DELTA * _DELTA) * (t - _F(4.0 / 29.0)))


def _dot3(m, c):
    return _F(m[0]) * c[0] + _F(m[1]) * c[1] + _F(m[2]) * c[2]


_RGB_TO_XYZ = [[0.4124564, 0.3575761, 0.1804375], [0.2126729, 0.7151522, 0.0721750],
               [0.0193339, 0.1191920, 0.9503041]]
_XYZ_TO_RGB = [[3.2404542, -1.5371385, -0.4985314], [-0.9692660, 1.8760108, 0.0415560],
               [0.0556434, -0.2040259, 1.0572252]]
_WHITE = np.array([0.95047, 1.0, 1.08883], np.float32)


def _card_l(f_y):
    return (_F(116.0) * f_y - _F(16.0)) * _inv(100.0)


def _card_split(rgb, clipped_l):
    with np.errstate(invalid='ignore'):
        lin = [_decode(rgb[:, c]) for c in range(3)]
        f = [_lab_f(_dot3(_RGB_TO_XYZ[c], lin) / _WHITE[c]) for c in range(3)]
        lab = np.stack([_card_l(f[1]), (_F(500.0) * (f[0] - f[1])) * _inv(128.0),
                        (_F(200.0) * (f[1] - f[2])) * _inv(128.0)], -1)
        if not clipped_l:
            return lab, lab[:, 0].copy()
        clipped = [np.minimum(np.maximum(v, _F(0.0)), _F(1.0)) for v in lin]
        return lab, _card_l(_lab_f(_dot3(_RGB_TO_XYZ[1], clipped) / _WHITE[1]))


def _card_merge(lab, lum):
    with np.errstate(invalid='ignore'):
        fy = (lum * _F(100.0) + _F(16.0)) * _inv(116.0)
        fx = (lab[:, 1] * _F(128.0)) * _inv(500.0) + fy
        fz = fy - (lab[:, 2] * _F(128.0)) * _inv(200.0)
        xyz = [_lab_f_inv(f) * _WHITE[c] for c, f in enumerate((fx, fy, fz))]
        return np.stack([np.minimum(np.maximum(_encode(_dot3(_XYZ_TO_RGB[c], xyz)), _F(0.0)),
                                    _F(1.0)) for c in range(3)], -1)


def _ulps_of_one(a, b):
    """|a - b| in float32 ulps of 1.0 (2^-23), NaN against NaN 0, NaN
    against a number inf: the chain's terms are of order 1, so a value near
    0 (a and b are differences of two f values, an sRGB value a sum of
    three XYZ terms) carries their rounding, not its own."""
    d = np.abs(a.astype(np.float64) - b) / 2.0 ** -23
    return np.where(np.isnan(a) & np.isnan(b), 0.0, np.where(np.isnan(d), np.inf, d))


# The kernels against the CPU chain (measured over three seeds of the edge
# grids: 4 for the split, 16.5 for the merge).  The CPU chain divides where
# the card multiplies by a reciprocal (1 ulp apart in ~15% of values) and
# its pow is PyTorch's, not the host's powf (up to 1 ulp).  The split adds
# two such roundings of f values (< 1.3) and scales their difference by
# 500/128; the merge cubes f values up to 1.2, sums three XYZ terms of up to
# 6.4 (|XYZ_TO_RGB| up to 3.24) and encodes with a slope of up to 7 above
# the knee.  Twice the measured maximum:
LAB_SPLIT_ULPS = 8
LAB_MERGE_ULPS = 32


def _emu_split(emu_lib, rgb, clipped_l, offset):
    """The kernel on rgb, with every buffer `offset` floats into its
    allocation (1: no 16-byte alignment, the scalar path)."""
    n = len(rgb)
    src = np.empty(3 * n + offset, np.float32)
    src[offset:] = rgb.reshape(-1)
    lab = np.full(3 * n + offset, -7.0, np.float32)
    lum = np.full(n + offset, -7.0, np.float32)
    fn = _bound(emu_lib, 'lab_split')
    assert fn(_p(src[offset:]), _p(lab[offset:]), _p(lum[offset:]), n, clipped_l, None) == 0
    assert (lab[:offset] == -7.0).all() and (lum[:offset] == -7.0).all()
    return lab[offset:].reshape(n, 3), lum[offset:]


def _emu_merge(emu_lib, lab, lum, offset):
    n = len(lab)
    src = np.empty(3 * n + offset, np.float32)
    src[offset:] = lab.reshape(-1)
    plane = np.empty(n + offset, np.float32)
    plane[offset:] = lum
    out = np.full(3 * n + offset, -7.0, np.float32)
    fn = _bound(emu_lib, 'lab_merge')
    assert fn(_p(src[offset:]), _p(plane[offset:]), _p(out[offset:]), n, None) == 0
    assert (out[:offset] == -7.0).all()
    return out[offset:].reshape(n, 3)


@pytest.mark.parametrize('offset', [0, 1])
@pytest.mark.parametrize('clipped_l', [1, 0])
def test_lab_split_source_on_host(emu_lib, rng, clipped_l, offset):
    """Both planes of lab_split on the edge grid, on the 16-byte path and on
    the scalar one: the card's rounding bit for bit (NaN where it is NaN),
    the CPU chain within LAB_SPLIT_ULPS."""
    rgb = lab_grids.edge_rgb(rng)
    lab, lum = _emu_split(emu_lib, rgb, clipped_l, offset)
    want_lab, want_lum = _card_split(rgb, clipped_l)
    np.testing.assert_array_equal(lab, want_lab)
    np.testing.assert_array_equal(lum, want_lum)
    cpu_lab, cpu_lum = lab_split_plain(torch.from_numpy(rgb), clipped_l=bool(clipped_l))
    assert _ulps_of_one(lab, cpu_lab.numpy()).max() <= LAB_SPLIT_ULPS
    assert _ulps_of_one(lum, cpu_lum.numpy()).max() <= LAB_SPLIT_ULPS


@pytest.mark.parametrize('offset', [0, 1])
def test_lab_merge_source_on_host(emu_lib, rng, offset):
    """lab_merge on the edge grid, on both paths: the card's rounding bit
    for bit, the CPU chain within LAB_MERGE_ULPS."""
    lab, lum = lab_grids.edge_merge(rng, _card_split(lab_grids.edge_rgb(rng), 0)[0])
    out = _emu_merge(emu_lib, lab, lum, offset)
    np.testing.assert_array_equal(out, _card_merge(lab, lum))
    cpu = lab_merge_plain(torch.from_numpy(lab), torch.from_numpy(lum)).numpy()
    assert _ulps_of_one(out, cpu).max() <= LAB_MERGE_ULPS


@pytest.mark.parametrize('n', range(1, 10))
def test_lab_source_tail_on_host(emu_lib, rng, n):
    """1-9 pixels: whole quads, then the last 1-3 pixels one at a time; the
    round trip of the split's LAB with its own L."""
    rgb = rng.uniform(-0.1, 1.2, (n, 3)).astype(np.float32)
    rgb[n // 2] = np.nan
    lab, lum = _emu_split(emu_lib, rgb, 1, 0)
    want_lab, want_lum = _card_split(rgb, 1)
    np.testing.assert_array_equal(lab, want_lab)
    np.testing.assert_array_equal(lum, want_lum)
    np.testing.assert_array_equal(_emu_merge(emu_lib, lab, lab[:, 0].copy(), 0),
                                  _card_merge(lab, lab[:, 0]))


def test_lab_launchers_refuse_no_pixels(emu_lib):
    """No pixels: cudaErrorInvalidValue, and nothing launched."""
    assert _bound(emu_lib, 'lab_split')(None, None, None, 0, 1, None) == 1
    assert _bound(emu_lib, 'lab_merge')(None, None, None, 0, None) == 1
