"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. card name and power limit (nvidia-smi), torch and CUDA versions;
     build every kernel of csrc/ (one nvcc each, in parallel).
  2. each hand kernel against its plain PyTorch version on the card, at the
     FULL path's shapes (4096x3000): max abs error against the stated
     tolerance, kernel / plain time by CUDA events, and the bound (the
     least time the card could take: bytes over 3.35 TB/s or operations
     over 33.5 T/s, whichever is larger).
  3. the RCD golden cases of tests/goldens/pipeline_goldens.npz on the card
     (1 uint8 count).
  4. one FULL frame at 1024x768 on the card against the same on the CPU
     (the plain versions): 1 count.
  5. the graded FULL configuration at full width through ImageProcessor:
     4096x3000 RGGB Packed12 with white balance, 3 batches of 4 synthetic
     frames; the launch counts are zeroed just before and read just after,
     and each kernel must have launched exactly BATCH * N_BATCHES = 12
     times: the path runs each kernel once a frame (RCD interior, the
     3-pass colour smoothing and the bilateral detail term each in one
     wrapper call), so a frame that skipped one would show here.  Prints ms per frame,
     frames per second, per-stage ms and peak device memory.
Then one JSON line with the kernels, and the result JSON as the last line.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
# H100 SXM float32 outside the tensor cores is 67 TFLOP/s counting an FMA
# as two operations.  The kernels build with --fmad=false, so each counted
# operation is one instruction: half that rate.
FP32_OPS_PER_S = 67e12 / 2
W, H = 4096, 3000
BATCH, N_BATCHES = 4, 3
WB = (1.2, 1.0, 1.1)
REPO = Path(__file__).resolve().parent


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters=20, warmup=5):
    """Mean ms of fn() over `iters` calls after `warmup`, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def full_settings():
    from tpu_darktable_torch.pipeline.config import Debayer, ImageProcessingSettings, ToneMapper

    # bench.py's graded FULL configuration; the rest are the defaults.
    return ImageProcessingSettings(
        debayer=Debayer.rcd, postprocess=True, enable_denoise=True, enable_bilateral=True,
        tone_mapping=ToneMapper.adaptive_aces, tone_gamma=1.5, tone_intensity=2.0,
        light_adapt=0.8, vibrance=0.5)


def synthetic_frames(w, h, n, seed):
    """Packed12 bytes of smooth-plus-noise mosaics, encoded by the port."""
    from tpu_darktable_torch.ops.packed import encode12_float

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        base = 0.35 + 0.3 * np.sin(xx / (37.0 + 5 * i)) * np.cos(yy / 53.0)
        m = np.clip(base + rng.normal(0, 0.03, (h, w)), 0, 1).astype(np.float32)
        out.append(encode12_float(torch.from_numpy(m.reshape(-1))))
    return torch.stack(out)


# ---------------------------------------------------------------- phase 1

def phase_card_and_build():
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(smi)
    log(f'torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}')
    from tpu_darktable_torch.kernels import _build

    t0 = time.perf_counter()
    seconds = _build.build()
    log(f'kernels built in {time.perf_counter() - t0:.1f} s (per kernel: '
        + ', '.join(f'{k} {v:.1f} s' for k, v in seconds.items()) + ')')
    for name in _build.SOURCES:
        lib = _build._lib_path(name)
        ptxas = [ln for ln in lib.with_suffix('.log').read_text().splitlines() if 'registers' in ln]
        log(f'  {name}: ' + ' | '.join(s.strip() for s in ptxas))
    return smi


# ---------------------------------------------------------------- phase 2

def phase_kernels(dev):
    """Each kernel vs its plain version at the FULL path's shapes."""
    from tpu_darktable_torch.kernels.bilateral_band import bilateral_band, bilateral_band_plain
    from tpu_darktable_torch.kernels.color_smooth import color_smooth_diffs, color_smooth_diffs_plain
    from tpu_darktable_torch.kernels.rcd_interior import RING, rcd_interior, rcd_interior_plain
    from tpu_darktable_torch.ops import color, packed, rcd, white_balance
    from tpu_darktable_torch.ops.bayer import BayerPattern, site_parities
    from tpu_darktable_torch.ops.bilateral import compute_grid_size

    frame = synthetic_frames(W, H, 1, seed=3)[0].to(dev)
    mosaic = packed.decode12_float(frame.reshape(H, W * 3 // 2))
    mosaic = white_balance.apply_white_balance(mosaic, torch.tensor(WB, device=dev),
                                               BayerPattern.RGGB)
    rgb = rcd.rcd_demosaic(mosaic, BayerPattern.RGGB)
    g = rgb[..., 1].contiguous()
    diffs = torch.stack((rgb[..., 0] - g, rgb[..., 2] - g))
    lum = color.rgb_to_lab(torch.clamp(rgb, 0.0, 1.0))[..., 0].contiguous()
    rp, bp = site_parities(BayerPattern.RGGB)
    _, _, gz = compute_grid_size(W, H, 2.0, 0.2)
    px = H * W
    out = []

    def record(name, source, replaces, k_fn, p_fn, err_fn, tol, n_bytes, n_ops):
        k_out, p_out = k_fn(), p_fn()
        torch.cuda.synchronize()
        err = err_fn(k_out, p_out)
        log(f'{name}: max_abs_err {err:.3g} (tolerance {tol:g})')
        if not err <= tol:
            raise AssertionError(f'{name} disagrees with its plain version: {err} > {tol}')
        ms, plain_ms = cuda_ms(k_fn), cuda_ms(p_fn, iters=5)
        b_ms, b_by = bound(n_bytes, n_ops)
        log(f'{name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})')
        out.append(dict(name=name, route='cuda', source=source, replaces=replaces,
                        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=None))

    r = RING
    # ~200 float ops a pixel through the 12 steps (tallied from the source);
    # one read of the mosaic, three planes written.
    record('rcd_interior', 'tpu_darktable_torch/csrc/rcd_interior.cu',
           'tpu_darktable/kernels/rcd_interior.py:226',
           lambda: rcd_interior(mosaic, r_par=rp, b_par=bp),
           lambda: rcd_interior_plain(mosaic, r_par=rp, b_par=bp),
           lambda a, b: (a - b)[:, r:-r, r:-r].abs().max().item(), 1e-5,
           4 * px + 12 * px, 200 * px)
    # 3 passes x 2 planes x (25 compare-exchanges = 50 min/max + 4) a pixel;
    # two diff planes and g read once, two planes written.
    record('color_smooth_diffs', 'tpu_darktable_torch/csrc/color_smooth.cu',
           'tpu_darktable/kernels/color_smooth.py:91',
           lambda: color_smooth_diffs(diffs, g, n_passes=3),
           lambda: color_smooth_diffs_plain(diffs, g, n_passes=3),
           lambda a, b: (a - b).abs().max().item(), 0.0,
           12 * px + 8 * px, 3 * 2 * 54 * px)
    # the algorithm: ~27 ops a pixel to splat, 3 x 5 taps x 2 ops a grid
    # cell (1.5 cells a pixel at s=2, gz=6), ~22 to slice; lum read once,
    # l_diff written once.
    record('bilateral_band', 'tpu_darktable_torch/csrc/bilateral_band.cu',
           'tpu_darktable/kernels/bilateral_band.py:169',
           lambda: bilateral_band(lum, s=2, gz=gz, sigma_r=0.2),
           lambda: bilateral_band_plain(lum, s=2, gz=gz, sigma_r=0.2),
           lambda a, b: (a - b).abs().max().item(), 1e-5,
           4 * px + 4 * px, (27 + 45 + 22) * px)
    return out


# ---------------------------------------------------------------- phase 3

def golden_input(size, ids):
    from tpu_darktable_torch.ops.bayer import PackedFormat
    from tpu_darktable_torch.ops.packed import encode

    w, h = size
    rng = np.random.default_rng(1234)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    mosaic = np.clip(0.4 + 0.25 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
                     + rng.normal(0, 0.04, (h, w)).astype(np.float32), 0, 1)
    return encode(torch.from_numpy(mosaic.reshape(-1).astype(np.float32)),
                  PackedFormat.Packed12_IDS if ids else PackedFormat.Packed12)


def phase_goldens(dev):
    import tpu_darktable_torch as tt
    from tpu_darktable_torch.pipeline.config import ImageProcessingSettings

    goldens = np.load(REPO / 'tests' / 'goldens' / 'pipeline_goldens.npz')
    dn = dict(enable_denoise=True, enable_bilateral=True)
    plain = dict(enable_denoise=False, enable_bilateral=False)
    cases = {
        'rcd_reinhard': ((96, 64), 'RGGB', False, dn),
        'rcd_reinhard_ids': ((96, 64), 'RGGB', True, dn),
        'rcd_bggr': ((96, 64), 'BGGR', False, plain),
        'rcd_grbg': ((96, 64), 'GRBG', False, plain),
        'rcd_4to3_aspect': ((320, 240), 'RGGB', False, dn),
    }
    for name, (size, pattern, ids, extra) in cases.items():
        settings = ImageProcessingSettings(
            tone_intensity=2.0, tone_gamma=1.2, light_adapt=0.8, vibrance=0.3,
            debayer=tt.Debayer.rcd, tone_mapping=tt.ToneMapper.reinhard, postprocess=True, **extra)
        proc = tt.ImageProcessor(size, tt.BayerPattern[pattern],
                                 tt.PackedFormat.Packed12_IDS if ids else tt.PackedFormat.Packed12,
                                 settings, device=dev, white_balance=WB)
        out = proc.process(golden_input(size, ids), 'x').cpu().numpy()
        d = int(np.abs(out.astype(int) - goldens[name].astype(int)).max())
        log(f'golden {name}: max |diff| {d} count(s)')
        if d > 1:
            raise AssertionError(f'golden {name} off by {d} counts')


# ---------------------------------------------------------------- phase 4

def phase_card_vs_cpu(dev):
    import tpu_darktable_torch as tt

    w, h = 1024, 768
    frames = synthetic_frames(w, h, 1, seed=5)
    outs = []
    for d in (dev, torch.device('cpu')):
        proc = tt.ImageProcessor((w, h), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                                 full_settings(), device=d, white_balance=WB)
        outs.append(proc.process_batch(frames).cpu().numpy().astype(int))
    d = int(np.abs(outs[0] - outs[1]).max())
    log(f'card vs cpu at {w}x{h}: max |diff| {d} count(s), {(outs[0] != outs[1]).mean():.2e} of values differ')
    if d > 1:
        raise AssertionError(f'card and CPU differ by {d} counts')


# ---------------------------------------------------------------- phase 5

def phase_full(dev):
    import tpu_darktable_torch as tt
    from tpu_darktable_torch import kernels

    proc = tt.ImageProcessor((W, H), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                             full_settings(), device=dev, white_balance=WB)
    batches = [synthetic_frames(W, H, BATCH, seed=100 + b).to(dev) for b in range(N_BATCHES)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launches()
    times = []
    for b in batches:
        t0 = time.perf_counter()
        out = proc.process_batch(b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(kernels.launches)

    log(f'FULL launches: {launches}')
    for name, n in launches.items():
        if n != BATCH * N_BATCHES:
            raise AssertionError(f'kernel {name} launched {n} times on the main path, '
                                 f'expected one a frame ({BATCH * N_BATCHES})')
    if tuple(out.shape) != (BATCH, H, W, 3) or out.dtype != torch.uint8:
        raise AssertionError(f'FULL output {tuple(out.shape)} {out.dtype}')
    if not (torch.isfinite(proc.bounds).all() and torch.isfinite(proc.metrics).all()):
        raise AssertionError('non-finite EMA state')
    if out.float().std().item() < 1.0:
        raise AssertionError('FULL output is flat')
    steady = sum(times[1:]) / (len(times) - 1)
    log(f'FULL {W}x{H} batch {BATCH}: batch seconds {[round(t, 4) for t in times]}; '
        f'{steady / BATCH * 1e3:.2f} ms/frame, {BATCH / steady:.2f} frames/s (batches 2..{N_BATCHES}); '
        f'peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    log(f'FULL bounds {proc.bounds.tolist()} metrics {proc.metrics.tolist()}')
    stage_ms(dev, batches[0][0])
    return launches


def stage_ms(dev, frame_bytes):
    """Per-stage ms of one FULL frame, each stage timed alone by CUDA events."""
    from tpu_darktable_torch.ops import bilateral, color, packed, postprocess, rcd, tonemap
    from tpu_darktable_torch.ops import white_balance, wiener
    from tpu_darktable_torch.ops.bayer import BayerPattern
    from tpu_darktable_torch.pipeline.util import normalize_image

    s = full_settings()
    wb = torch.tensor(WB, device=dev)
    rows = frame_bytes.reshape(H, W * 3 // 2)
    decode = lambda: white_balance.apply_white_balance(packed.decode12_float(rows), wb,
                                                       BayerPattern.RGGB)
    mosaic = decode()
    demosaic = lambda: rcd.rcd_demosaic(mosaic, BayerPattern.RGGB)
    strips = lambda: rcd._rcd_edge_strips(mosaic, BayerPattern.RGGB, True)
    rgb = demosaic()
    post = lambda: postprocess.postprocess(rgb, BayerPattern.RGGB, 3, True)
    rgb = post()
    bounds = tonemap.compute_image_bounds(rgb)
    norm = normalize_image(rgb, bounds)

    def denoise():
        lab, lum = color.rgb_to_lab_with_clipped_l(norm)
        den = wiener.wiener_denoise(torch.log(torch.clamp(lum, min=1e-4))[..., None], s.denoise,
                                    32, s.denoise_overlap, spectral_dtype=torch.float16,
                                    storage_dtype=torch.float16)[..., 0]
        return color.lab_modify_luminance(lab, torch.exp(den + 1e-4))

    dn = denoise()

    def bil():
        lab = color.rgb_to_lab(dn)
        out = bilateral.bilateral_process(lab[..., 0], s.bil_sigma_spatial,
                                          s.bil_sigma_luminance, s.bilateral)
        return color.lab_modify_luminance(lab, out)

    bl = bil()
    metrics = tonemap.compute_image_metrics(bl)
    params = tonemap.TonemapParameters(s.tone_gamma, s.tone_intensity, s.light_adapt, s.vibrance)
    tone = lambda: tonemap.aces_tonemap(bl, params, metrics)
    parts = [('decode+wb', decode), ('rcd', demosaic), ('rcd edge strips (plain, in rcd)', strips),
             ('postprocess', post),
             ('wiener (lab in/out)', denoise), ('bilateral (lab in/out)', bil),
             ('adaptive aces + vibrance', tone)]
    res = {name: cuda_ms(fn, iters=3, warmup=1) for name, fn in parts}
    log('FULL per-stage ms (one frame): '
        + ', '.join(f'{k} {v:.3f}' for k, v in res.items())
        + f'; sum without the strips {sum(res.values()) - res[parts[2][0]]:.3f}')


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script needs one GPU',
              file=sys.stderr)
        return 2
    import tpu_darktable_torch  # noqa: F401  (fails where the repo is absent)

    dev = torch.device('cuda')
    smi = phase_card_and_build()
    kern = phase_kernels(dev)
    phase_goldens(dev)
    phase_card_vs_cpu(dev)
    launches = phase_full(dev)
    for k in kern:
        k['launches'] = launches[k['name']]
    keys = ['name', 'route', 'source', 'replaces', 'launches', 'max_abs_err', 'ms', 'plain_ms',
            'bound_ms', 'bound_by', 'library_ms']
    print(json.dumps({'kernels': [{key: k[key] for key in keys} for k in kern]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
