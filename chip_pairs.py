"""Paired timings of kernels against their earlier sources, on one GPU.

    python3 chip_pairs.py --parent DIR [--out FILE.json]

DIR holds earlier sources, which are no longer in the tree; each section
below runs only where DIR holds its parent source:

    git show 862cd2f:tpu_darktable_torch/csrc/rcd_interior.cu > DIR/rcd_interior.cu
    git show a3c1ad5:tpu_darktable_torch/csrc/wiener_core.cu > DIR/wiener_core.cu
    git show a3c1ad5:tpu_darktable_torch/csrc/bilateral_band.cu > DIR/bilateral_band.cu
    git show deaec77:tpu_darktable_torch/csrc/color_smooth.cu > DIR/color_smooth.cu
    git show deaec77:tpu_darktable_torch/csrc/grid_blur.cu > DIR/grid_blur.cu

(862cd2f: the last commit with the one-pixel-a-thread RCD cascade; a3c1ad5:
the last with the five-launch bilateral chain and the paired-DFT Wiener tile
core; deaec77: the last with the sorting-network colour smoothing and the
shared-ring grid blur).  They are built with the port's nvcc flags and run
in turns with the sources of the tree (earlier, new, new, earlier; three
rounds of 20 launches, CUDA events), so that the card's clock and power
state are shared by both.  Every build is bound through the port's
declaration of its entry point (kernels/_build.py ENTRIES; the five-launch
bilateral source, whose entry point the tree no longer has, through its
own `Entry`):

  - rcd_interior at 4096x3000 RGGB: the new kernel and a few variants of
    it (tile shape, threads a block, blocks an SM; each built from the
    tree's source with a substitution) against the earlier source, with
    each one's max |diff| to the plain version (must be 0);
  - wiener_tile_core on (16, 3072, 4160) slabs at K = 32 (the coset slabs
    of a 4096x3000 plane at overlap 4) and on (12, 1536, 2080) at K = 16;
    the new kernel's error against its plain version, its difference to
    the earlier kernel, and the same turns for a few variants of the new
    source (warps a block and blocks an SM, streaming loads and stores,
    approximate division);
  - the bilateral detail term at 4096x3000 for sigma_s 1, 2, 8 and for
    gz = 51: the five-launch source against the one-launch source that now
    serves both wrappers, and max |diff| between them.
  - color_smooth_diffs at 4096x3000, 3 passes, and grid_blur_xyz on the
    (6, 1001, 1366) grid of sigma_s 3 in both z modes: the tree's source and
    a few variants of it (tile shape, outputs a thread, threads a block)
    against the earlier source, each with its max |diff| to the plain
    version (colour smoothing must be 0, the grid blur <= 1e-6); and the
    tree's colour smoothing at 1 to 5 passes, which splits its time into
    what a pass costs and what staging and the store cost.

Prints the card's name and power limit first, a JSON object last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROUNDS, ITERS = 3, 20

# name -> substitutions on csrc/wiener_core.cu
_W4, _B5 = 'constexpr int WARPS = 4;', 'constexpr int BLOCKS_PER_SM = 5;'
WIENER_VARIANTS = {   # NxM: N warps a block, M blocks an SM
    'warps8x2': [(_W4, 'constexpr int WARPS = 8;'), (_B5, 'constexpr int BLOCKS_PER_SM = 2;')],
    'warps4x4': [(_B5, 'constexpr int BLOCKS_PER_SM = 4;')],
    'warps16x1': [(_W4, 'constexpr int WARPS = 16;'), (_B5, 'constexpr int BLOCKS_PER_SM = 1;')],
    'warps8x3': [(_W4, 'constexpr int WARPS = 8;'), (_B5, 'constexpr int BLOCKS_PER_SM = 3;')],
    'warps4x6': [(_B5, 'constexpr int BLOCKS_PER_SM = 6;')],
    'warps2x10': [(_W4, 'constexpr int WARPS = 2;'), (_B5, 'constexpr int BLOCKS_PER_SM = 10;')],
    'streaming': [
        ('re[i] = ta.valid ? slabs[ta.base + i * row_len + j] : 0.0f;',
         're[i] = ta.valid ? __ldcs(slabs + ta.base + i * row_len + j) : 0.0f;'),
        ('im[i] = tb.valid ? slabs[tb.base + i * row_len + j] : 0.0f;',
         'im[i] = tb.valid ? __ldcs(slabs + tb.base + i * row_len + j) : 0.0f;'),
        ('if (ta.valid) out[ta.base + i * row_len + j] = (re[i] * inv_kk) * w2i + ma * (w2f * w2i);',
         'if (ta.valid) __stcs(out + ta.base + i * row_len + j, (re[i] * inv_kk) * w2i + ma * (w2f * w2i));'),
        ('if (tb.valid) out[tb.base + i * row_len + j] = (im[i] * inv_kk) * w2i + mb * (w2f * w2i);',
         'if (tb.valid) __stcs(out + tb.base + i * row_len + j, (im[i] * inv_kk) * w2i + mb * (w2f * w2i));')],
    'fdividef': [('fmaxf(pa - s2a, 0.0f) / pa', '__fdividef(fmaxf(pa - s2a, 0.0f), pa)'),
                 ('fmaxf(pb - s2b, 0.0f) / pb', '__fdividef(fmaxf(pb - s2b, 0.0f), pb)')],
}

# name -> substitutions on csrc/rcd_interior.cu (64x32 px tiles, 16 warps a
# block, two blocks an SM); tile in px, threads x blocks an SM
_TQX, _TQY = 'constexpr int TQX = 32;', 'constexpr int TQY = 16;'
_T512, _B2 = 'constexpr int THREADS = 512;', 'constexpr int BLOCKS_PER_SM = 2;'
RCD_VARIANTS = {
    'tile64x32_t256x2': [(_T512, 'constexpr int THREADS = 256;')],
    'tile64x32_t384x2': [(_T512, 'constexpr int THREADS = 384;')],
    'tile64x64_t512x1': [(_TQY, 'constexpr int TQY = 32;'), (_B2, 'constexpr int BLOCKS_PER_SM = 1;')],
    'tile64x40_t256x2': [(_TQY, 'constexpr int TQY = 20;'), (_T512, 'constexpr int THREADS = 256;')],
    'tile128x32_t512x1': [(_TQX, 'constexpr int TQX = 64;'), (_B2, 'constexpr int BLOCKS_PER_SM = 1;')],
    'tile32x32_t256x3': [(_TQX, 'constexpr int TQX = 16;'), (_T512, 'constexpr int THREADS = 256;'),
                         (_B2, 'constexpr int BLOCKS_PER_SM = 3;')],
}

# name -> substitutions on csrc/color_smooth.cu (124x32 px tiles at N = 3,
# 256 threads a block, runs of 4 outputs a thread)
_TH, _R4, _T256 = 'constexpr int TH = 32;', 'constexpr int R = 4;', 'constexpr int THREADS = 256;'
CS_VARIANTS = {
    'r8': [(_R4, 'constexpr int R = 8;')],
    'th16': [(_TH, 'constexpr int TH = 16;')],
    'r8_t512': [(_R4, 'constexpr int R = 8;'), (_T256, 'constexpr int THREADS = 512;')],
    't128': [(_T256, 'constexpr int THREADS = 128;')],
}

# name -> substitutions on csrc/grid_blur.cu (64x32 cell tiles: 16 x 8
# threads, 4 x 4 cells a thread, 4 blocks an SM)
_LY, _TXG, _GB4 = 'constexpr int LY = 4;', 'constexpr int TXG = 16;', 'constexpr int BLOCKS_PER_SM = 4;'
GB_VARIANTS = {
    'ly2': [(_LY, 'constexpr int LY = 2;'), (_GB4, 'constexpr int BLOCKS_PER_SM = 8;')],
    'ly3': [(_LY, 'constexpr int LY = 3;'), (_GB4, 'constexpr int BLOCKS_PER_SM = 5;')],
    'tile32x32': [(_TXG, 'constexpr int TXG = 8;'), (_GB4, 'constexpr int BLOCKS_PER_SM = 8;')],
    'bpsm3': [(_GB4, 'constexpr int BLOCKS_PER_SM = 3;')],
}


def variant_sources(src_name, variants, prefix):
    """Write each variant of csrc/src_name into the build directory;
    returns {prefix + name: path}."""
    from tpu_darktable_torch.kernels import _build

    src = (_build.CSRC / src_name).read_text()
    var_dir = _build.build_dir() / 'pairs'
    var_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f'variant {name}: {old!r} is not in the source')
            text = text.replace(old, new)
        path = var_dir / f'{prefix}{name}.cu'
        path.write_text(text)
        jobs[prefix + name] = path
    return jobs


def log(*a):
    print(*a, flush=True)


def nvcc_build(jobs):
    """jobs: {name: source path}.  One nvcc each, in parallel; returns
    {name: CDLL} and logs the ptxas lines."""
    from tpu_darktable_torch.kernels import _build

    out_dir = _build.build_dir() / 'pairs'
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in jobs.items():
        lib = out_dir / f'lib{name}.so'
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, '-o', str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'{name}: nvcc failed\n{text}')
        for ln in text.splitlines():
            if 'registers' in ln or 'spill' in ln:
                log(f'  {name}: {ln.strip()}')
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def event_ms(fn, iters=ITERS):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def turns(old, new):
    """old, new, new, old, ROUNDS times.  Returns the two lists of ms and
    whether new won every pair (each old against the new next to it)."""
    for fn in (old, new):
        for _ in range(3):
            fn()
    t_old, t_new = [], []
    for _ in range(ROUNDS):
        a, b, c, d = event_ms(old), event_ms(new), event_ms(new), event_ms(old)
        t_old += [a, d]
        t_new += [b, c]
    return t_old, t_new, all(n < o for o, n in zip(t_old, t_new))


def summary(ts):
    return dict(median=statistics.median(ts), min=min(ts), max=max(ts))


def kernel_pairs(key, libs, make_run, err_of, tol, result):
    """libs: {'parent', 'new', variants...}; make_run(name, lib) -> a launch;
    err_of(name) -> max |diff| of that source's last output to plain.
    Every source but the parent in turns against the parent."""
    runs = {name: make_run(name, lib) for name, lib in libs.items()}
    for run in runs.values():
        run()
    torch.cuda.synchronize()
    row = {f'{name}_err_vs_plain': err_of(name) for name in libs}
    row['tolerance'] = tol
    for name in libs:
        if name == 'parent':
            continue
        t_old, t_new, won = turns(runs['parent'], runs[name])
        row[name] = dict(parent=summary(t_old), new=summary(t_new), won_every_pair=won)
        log(f'{key} {name}: parent {summary(t_old)} new {summary(t_new)} won every pair: {won}')
    log(f'{key}: ' + json.dumps({a: b for a, b in row.items() if not isinstance(b, dict)}))
    result[key] = row
    bad = {name: row[f'{name}_err_vs_plain'] for name in libs
           if not row[f'{name}_err_vs_plain'] <= tol}
    if bad:
        raise AssertionError(f'{key} sources off their plain version: {bad}')


def rcd_pairs(libs, dev, result):
    """libs: {'parent', 'new', variants...} -> CDLL of an RCD source."""
    from tpu_darktable_torch.kernels._build import ENTRIES
    from tpu_darktable_torch.kernels.rcd_interior import RING, rcd_interior_plain

    h, w = 3000, 4096
    gen = torch.Generator(device=dev).manual_seed(13)
    x = torch.rand((h, w), generator=gen, device=dev) * 0.9
    stream = torch.cuda.current_stream().cuda_stream
    outs = {name: torch.empty((3, h, w), device=dev) for name in libs}

    def make_run(name, lib):
        fn = ENTRIES['rcd_interior'].bind(lib)

        def run():
            status = fn(x.data_ptr(), outs[name].data_ptr(), h, w, 0, 0, 1, 1, stream)
            if status != 0:
                raise RuntimeError(f'rcd_interior {name}: cudaError_t {status}')
        return run

    r = RING
    plain = rcd_interior_plain(x, r_par=(0, 0), b_par=(1, 1))[:, r:-r, r:-r]
    kernel_pairs('rcd_interior', libs, make_run,
                 lambda name: (outs[name][:, r:-r, r:-r] - plain).abs().max().item(), 0.0, result)


def old_tables(k, wf, wi, dev):
    """The earlier Wiener launcher's (4, K) table: cos, sin, wf, wi."""
    ang = 2.0 * np.pi * np.arange(k, dtype=np.float64) / k
    cs, sn = np.cos(ang), np.sin(ang)
    cs[np.abs(cs) < 1e-12] = 0.0
    sn[np.abs(sn) < 1e-12] = 0.0
    return torch.as_tensor(np.stack([cs.astype(np.float32), sn.astype(np.float32), wf, wi]),
                           device=dev)


def wiener_pairs(libs, dev, result):
    from tpu_darktable_torch.kernels._build import ENTRIES
    from tpu_darktable_torch.kernels.wiener_core import wiener_tile_core_plain
    from tpu_darktable_torch.ops.wiener import _gaussian_window

    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(11)
    for k, shape, n_sig in ((32, (16, 3072, 4160), 1), (16, (12, 1536, 2080), 3)):
        # log-luminance-like values: smooth in [-3, 0] plus noise
        x = (torch.rand(shape, generator=gen, device=dev) * 0.2
             - 3.0 * torch.rand((shape[0], 1, 1), generator=gen, device=dev))
        sig2 = torch.full((n_sig,), 0.075 ** 2, device=dev)
        wf = _gaussian_window(k, 0.3)
        windows = torch.as_tensor(np.stack([wf, wf]), device=dev)
        tables = old_tables(k, wf, wf, dev)
        outs = {name: torch.empty_like(x) for name in libs}

        def call(name):
            fn = ENTRIES['wiener_tile_core'].bind(libs[name])
            tab = tables if name == 'parent' else windows

            def run():
                status = fn(x.data_ptr(), outs[name].data_ptr(), sig2.data_ptr(), tab.data_ptr(),
                            k, shape[0], shape[1] // k, shape[2] // k, n_sig, stream)
                if status != 0:
                    raise RuntimeError(f'{name}: cudaError_t {status}')
            return run

        runs = {name: call(name) for name in libs}
        for run in runs.values():
            run()
        torch.cuda.synchronize()
        plain = wiener_tile_core_plain(x, sig2, wf, wf, k=k)
        scale = max(1.0, x.abs().max().item())
        row = {'shape': list(shape), 'tolerance': 2e-6 * scale}
        for name in libs:
            row[f'{name}_err_vs_plain'] = (outs[name] - plain).abs().max().item()
        row['new_vs_parent'] = (outs['new'] - outs['parent']).abs().max().item()
        del plain
        for name in libs:
            if name == 'parent':
                continue
            t_old, t_new, won = turns(runs['parent'], runs[name])
            row[name] = dict(parent=summary(t_old), new=summary(t_new), won_every_pair=won)
            log(f'wiener_tile_core K={k} {name}: parent {summary(t_old)} new {summary(t_new)} '
                f'won every pair: {won}')
        log(f'wiener_tile_core K={k}: ' + json.dumps({a: b for a, b in row.items()
                                                      if not isinstance(b, dict)}))
        result[f'wiener_k{k}'] = row
        if not row['new_err_vs_plain'] <= row['tolerance']:
            raise AssertionError(f'new kernel off its plain version: {row}')


def bilateral_pairs(libs, dev, result):
    from tpu_darktable_torch.kernels._build import ENTRIES, Entry
    from tpu_darktable_torch.ops.bilateral import compute_grid_size

    h, w = 3000, 4096
    gen = torch.Generator(device=dev).manual_seed(12)
    lum = torch.rand((h, w), generator=gen, device=dev) * 0.95
    stream = torch.cuda.current_stream().cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    band = Entry('bilateral_band.cu', 'bilateral_band_launch',
                 (p, p, p, p, i, i, i, i, ctypes.c_float, p)).bind(libs['band'])
    fused = ENTRIES['bilateral_fused'].bind(libs['fused'])
    cases = [(s, compute_grid_size(w, h, float(s), 0.2)[2], 0.2) for s in (1, 2, 8)]
    cases.append((2, 51, 0.02))
    for s, gz, sr in cases:
        ga = torch.empty((gz, h // s + 1, w // s + 1), device=dev)
        gb = torch.empty_like(ga)
        o_band, o_fused = torch.empty_like(lum), torch.empty_like(lum)

        def run_band():
            if band(lum.data_ptr(), o_band.data_ptr(), ga.data_ptr(), gb.data_ptr(), h, w, s, gz,
                    sr, stream) != 0:
                raise RuntimeError('bilateral_band launch failed')

        def run_fused():
            if fused(lum.data_ptr(), o_fused.data_ptr(), h, w, s, gz, sr, 0, stream) != 0:
                raise RuntimeError('bilateral_fused launch failed')

        t_old, t_new, won = turns(run_band, run_fused)
        diff = (o_band - o_fused).abs().max().item()
        key = f'bilateral_s{s}_gz{gz}'
        result[key] = dict(five_launch=summary(t_old), one_launch=summary(t_new),
                           won_every_pair=won, max_abs_diff=diff)
        log(f'{key}: five-launch {summary(t_old)} one-launch {summary(t_new)} '
            f'won every pair: {won}; max |diff| {diff:g}')
        del ga, gb


def color_smooth_pairs(libs, dev, result):
    from tpu_darktable_torch.kernels._build import ENTRIES
    from tpu_darktable_torch.kernels.color_smooth import color_smooth_diffs_plain

    h, w, n = 3000, 4096, 3
    gen = torch.Generator(device=dev).manual_seed(14)
    d = torch.rand((2, h, w), generator=gen, device=dev) - 0.5
    g = torch.rand((h, w), generator=gen, device=dev) - 0.1
    stream = torch.cuda.current_stream().cuda_stream
    outs = {name: torch.empty_like(d) for name in libs}

    def make_run(name, lib):
        fn = ENTRIES['color_smooth_diffs'].bind(lib)

        def run():
            status = fn(d.data_ptr(), g.data_ptr(), outs[name].data_ptr(), h, w, n, stream)
            if status != 0:
                raise RuntimeError(f'color_smooth {name}: cudaError_t {status}')
        return run

    plain = color_smooth_diffs_plain(d, g, n_passes=n)
    kernel_pairs('color_smooth_diffs', libs, make_run,
                 lambda name: (outs[name] - plain).abs().max().item(), 0.0, result)
    # What a pass costs against what staging and the store cost: the tree's
    # source at 1 to 5 passes.
    fn = ENTRIES['color_smooth_diffs'].bind(libs['new'])

    def passes(k):
        if fn(d.data_ptr(), g.data_ptr(), outs['new'].data_ptr(), h, w, k, stream) != 0:
            raise RuntimeError(f'color_smooth new at {k} passes: launch failed')

    by_n = {k: event_ms(lambda k=k: passes(k)) for k in range(1, 6)}
    log('color_smooth_diffs ms by passes: ' + json.dumps(by_n))
    result['color_smooth_diffs']['ms_by_passes'] = by_n


def grid_blur_pairs(libs, dev, result):
    from tpu_darktable_torch.kernels._build import ENTRIES
    from tpu_darktable_torch.kernels.grid_blur import grid_blur_xyz_plain

    shape = (6, 1001, 1366)
    gen = torch.Generator(device=dev).manual_seed(15)
    grid = torch.rand(shape, generator=gen, device=dev) - 0.3
    stream = torch.cuda.current_stream().cuda_stream
    outs = {name: torch.empty_like(grid) for name in libs}
    for z_mode in ('derivative', 'gaussian'):
        z_gauss = int(z_mode == 'gaussian')

        def make_run(name, lib):
            fn = ENTRIES['grid_blur_xyz'].bind(lib)

            def run():
                status = fn(grid.data_ptr(), outs[name].data_ptr(), *shape, z_gauss, stream)
                if status != 0:
                    raise RuntimeError(f'grid_blur {name}: cudaError_t {status}')
            return run

        plain = grid_blur_xyz_plain(grid, z_mode=z_mode)
        kernel_pairs(f'grid_blur_xyz_{z_mode}', libs, make_run,
                     lambda name: (outs[name] - plain).abs().max().item(), 1e-6, result)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--parent', required=True, help='directory with the earlier sources')
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('chip_pairs: needs one GPU', file=sys.stderr)
        return 2
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(smi)
    from tpu_darktable_torch.kernels import _build

    parent = Path(args.parent)
    csrc = _build.CSRC
    jobs = {}
    if (parent / 'rcd_interior.cu').exists():
        jobs.update({'rcd_parent': parent / 'rcd_interior.cu',
                     'rcd_new': csrc / 'rcd_interior.cu'})
        jobs.update(variant_sources('rcd_interior.cu', RCD_VARIANTS, 'rcd_'))
    if (parent / 'wiener_core.cu').exists():
        jobs.update({'parent': parent / 'wiener_core.cu', 'new': csrc / 'wiener_core.cu'})
        jobs.update(variant_sources('wiener_core.cu', WIENER_VARIANTS, ''))
    if (parent / 'bilateral_band.cu').exists():
        jobs.update({'band': parent / 'bilateral_band.cu', 'fused': csrc / 'bilateral_fused.cu'})
    if (parent / 'color_smooth.cu').exists():
        jobs.update({'cs_parent': parent / 'color_smooth.cu', 'cs_new': csrc / 'color_smooth.cu'})
        jobs.update(variant_sources('color_smooth.cu', CS_VARIANTS, 'cs_'))
    if (parent / 'grid_blur.cu').exists():
        jobs.update({'gb_parent': parent / 'grid_blur.cu', 'gb_new': csrc / 'grid_blur.cu'})
        jobs.update(variant_sources('grid_blur.cu', GB_VARIANTS, 'gb_'))
    if not jobs:
        print(f'chip_pairs: {parent} holds no parent source', file=sys.stderr)
        return 2
    libs = nvcc_build(jobs)
    dev = torch.device('cuda')
    result = {'card': smi, 'rounds': ROUNDS, 'launches_a_timing': ITERS}
    if 'rcd_parent' in libs:
        rcd_pairs({k[4:]: v for k, v in libs.items() if k.startswith('rcd_')}, dev, result)
    if 'parent' in libs:
        wiener_pairs({k: v for k, v in libs.items()
                      if not k.startswith(('rcd_', 'cs_', 'gb_')) and k not in ('band', 'fused')},
                     dev, result)
    if 'band' in libs:
        bilateral_pairs(libs, dev, result)
    if 'cs_parent' in libs:
        color_smooth_pairs({k[3:]: v for k, v in libs.items() if k.startswith('cs_')}, dev, result)
    if 'gb_parent' in libs:
        grid_blur_pairs({k[3:]: v for k, v in libs.items() if k.startswith('gb_')}, dev, result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
