"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. card name and power limit (nvidia-smi), torch and CUDA versions;
     build every kernel of csrc/ (one nvcc each, in parallel) and log each
     one's registers and spills as ptxas prints them.
  2. each hand kernel against its plain PyTorch version on the card, at the
     shapes of its path (4096x3000, RCD interior in all four patterns and on
     a ragged 2998x4002 frame, bit for bit; the general bilateral grid of sigma_s 3,
     (6, 1001, 1366); the Wiener tile core on the K=32, overlap-4 coset
     slabs of the 12 MP log-L plane, (16, 3072, 4160)): max abs error
     against the stated tolerance, kernel / plain time by CUDA events, the
     time of PyTorch library calls computing the same function where there
     are such (conv3d for the grid blur, the two dense matmuls for the
     Wiener core), NLM also on one plane (C = 1), the wavelet also at 5 and
     7 levels and timed at every depth from 0 to 8, and the bound (the least time the card could take: bytes
     over 3.35 TB/s or operations over 33.5 T/s, whichever is larger).
     bilateral_band and bilateral_fused are two wrappers of one source
     (csrc/bilateral_fused.cu); the Wiener core's error is printed for both
     of its shapes.  The LAB round trip's two kernels (csrc/lab.cu) on the
     denoise stage's input and back with the bilateral stage's new plane,
     bit for bit with their plain versions on the card.
  3. the RCD golden cases of tests/goldens/pipeline_goldens.npz on the card
     (1 uint8 count).
  4. one FULL frame at 1024x768 on the card against the same on the CPU
     (the plain versions): 1 count.
  5. the graded FULL configuration at full width through ImageProcessor:
     4096x3000 RGGB Packed12 with white balance, 3 batches of 4 synthetic
     frames; the launch counts are zeroed just before and read just after:
     the path runs each of its three kernels once a frame (RCD interior,
     the 3-pass colour smoothing and the bilateral detail term each in one
     wrapper call; its Wiener stage takes the separable float16 route of the
     default denoise_f16, as the JAX package's FULL does), so each must show
     exactly BATCH * N_BATCHES = 12, the LAB round trip's two kernels 24
     (once a luminance stage: denoise, bilateral), and the other kernels 0.  ImageProcessor
     captures its batched program as a CUDA graph on the first call (eager)
     and replays it for the other two, so the counts are 4 eager, then 4 and
     4 replayed.  The same 3 batches go in turns through an eager copy of
     build_pipeline_fn and the graphed processor (eager, graphed, graphed,
     eager), each turn from the first batch's EMA state; every batch of
     every turn must equal the first eager turn bit for bit (uint8, bounds,
     metrics).  Prints ms per frame of each turn, frames per second, peak
     device memory and what the graph keeps allocated.  A fifth turn,
     graphed with utils.timing's tracer on (a capture of its own), must
     equal them bit for bit and hold every mark of each call; it prints
     its capture seconds (the tracer's graph.capture span) and each
     stage's card ms a frame under the graph (the marks).  After phase
     10's profiling, the card's busy time and idle share of one batch of
     4 replayed and eager.
  6. BASELINE config 3: wavelet then NLM denoise of 8 frames of 4096x3000
     RGB from the FULL front end, a warm-up pass then a timed pass with
     exactly 8 launches of each kernel; finite output with a lower std than
     its input.  Prints ms per frame, frames per second and peak memory.
     Then the config's chain of 2 passes as benchmarks/baseline_configs.py
     jits it (_bench_chained), as one CUDA graph: its first call eager and
     captured, its replay bit for bit with the eager chain and launching 8
     of each kernel a pass, ms a frame by CUDA events in turns (eager,
     graphed, graphed, eager).  BASELINE config 2 the same way: PPG and RCD,
     each with 3 colour-smoothing passes, of 8 mosaics of 4096x3000, 3
     passes: 8 rcd_interior and 16 color_smooth_diffs launches a pass.
  7. FULL with bil_sigma_spatial = 3, the general bilateral path, through
     ImageProcessor at 4096x3000, 2 batches of 4: 8 grid_blur_xyz launches,
     16 of each LAB kernel and no bilateral_band; card vs CPU at 1024x768 (1 count); one
     bilateral_denoise of a 12 MP plane (2 grid_blur_xyz launches).
  8. the Wiener routes at full width: wiener_denoise on the tile-core
     route (FULL's with denoise_f16 off) against the separable einsums in
     float32 (bar 1e-3) and with float16 storage (printed, no bar) on the
     12 MP log-L plane (C=1) and on a 3-channel frame, and their times in
     turns (separable float16, tile core, tile core, separable float16;
     three rounds); then FULL for one batch of 4 through a local copy of
     its back-end loop on the separable float16 route, its bilateral detail
     term taken through kernels.bilateral_fused (the same source as the
     pipeline's bilateral_band), against process_batch: within 1 count (0
     expected: the same function from the same kernel source), 4 launches
     of bilateral_fused; and FULL with denoise_f16 off through process_batch
     (the tile core's pipeline path: 4 wiener_tile_core launches) against
     the default: no value may move by more than 1 count.
  9. the piecewise entry point at 4096x3000: load_bytes -> debayer ->
     process_rgb -> tonemap with bounds and metrics from a fused run of the
     same frame, equal to the fused output within 1 count, one launch of
     each of FULL's three kernels, 4 of lab_split and 2 of lab_merge (the
     workspaces split twice a stage); its first call runs eagerly and captures
     each workspace's graph (the capture seconds and the GiB the processor's
     pool keeps reserved are printed); then 3 frames in turns through an
     eager copy and the graphed processor (eager, graphed, graphed, eager),
     every frame bit for bit with the first eager turn (after phase 10, the
     card's busy time and idle share of one frame each way); then the PPG and
     bilinear debayers and the linear and filmic tonemaps through the
     piecewise chain, card vs CPU at 1024x768 (1 count).
 10. JPEG and streaming (BASELINE config 5): the native host scan must have
     built.  On one FULL frame of config 5's scene at 4096x3000: the DCT
     stage on the card equals the same stage on the CPU coefficient for
     coefficient at 4:2:2, 4:4:4 and gray; at 4:2:2, quality 90 and the auto
     restart interval the device entropy (no overflow at its default
     capacity), the native host scan, encode_jpeg_async and the CPU encode
     give the same bytes; progressive card == CPU.  Times: the DCT stage by
     CUDA events; the device entropy (dispatch to result), the host native
     scan, both whole encodes and progressive by the host clock; bytes a
     frame; the peak device memory of one device-entropy encode; and no call
     in process_batch (of a batch on the card or on the host) or in
     encode_jpeg_async may make the host wait for the card (CUDA sync
     debugging).  The entropy scan's kernel (csrc/jpeg_entropy.cu) on the
     frame turned to 3000x4096 (the stream cell's shape): equal to its
     plain version, 3 launches a call, both timed in turns beside the
     bound.  Then config 5 (benchmarks/baseline_configs.py:158-215):
     StreamingExecutor(batch 2, quality 90, keep_images=False), a warm-up
     of 2 frames and 32 timed, once with device JPEG and once with 2 host
     workers, the EMA reset between: no errors, every result FF D8, equal
     bytes frame for frame, 34 launches of each of FULL's three kernels and
     68 of each LAB kernel a run (and 102 of the scan kernel with device JPEG, 0 with host); s/frame, frames/s, MB/frame, and FULL's process_batch ms/frame
     alone in the same call.  Last, the card's busy time and idle share
     (torch.profiler) of the DCT stage, the device entropy, one FULL batch
     of 2 and 2 streamed frames in each mode.
 11. config 4 and the local Laplacian (run after phase 9, its profiling
     after phase 10's).  BASELINE config 4 (benchmarks/baseline_configs.py
     :141-156): local_laplacian with the default parameters on a 4096x3000
     plane of uniform values times 0.8, then Reinhard, filmic and ACES of
     the stacked RGB with that config's parameters and metrics: ms/frame
     and the Laplacian alone by CUDA events after a warm-up, peak memory,
     and (after phase 10) device ops a frame and the card's idle share;
     the config's chain of 2 passes as one CUDA graph against the eager
     chain, as phase 6 runs config 3.
     local_laplacian card vs CPU at 4096x3000 with neutral parameters (pad
     32: bit for bit) and with shadows 0.6, highlights 1.4, clarity 0.3
     (the full pad 1024: 1e-3 in under 0.5% of the elements), with the
     non-neutral time and peak memory.  FULL with enable_laplacian and
     lap_clarity 0.3 (golden rcd_linear_lap's local contrast) at 4096x3000,
     3 batches of 4: ms/frame over batches 2-3, peak memory, 12 launches of
     each of FULL's three kernels and 36 of each LAB kernel, no host wait in process_batch (CUDA sync
     debugging); card vs CPU at 1024x768 fused and piecewise (1 count).
 12. the command-line tools of tpu_darktable_torch/scripts/ on the card:
     run_benchmark in process at its default 4096x3000 (warm-up 1, 3
     iterations: every op's iterations/s, each chain a CUDA graph captured
     on its first call and replayed, as utils/timing.benchmark_op runs it;
     the JPEG op timed by the host), then the pure functions of
     test_debayer (RCD), test_bilateral (sigma_s 2 and 3), test_wiener (rgb
     and log_luminance, the Wiener class: the tile core) and test_laplacian
     on a synthetic 4096x3000 frame; launch counts read around each call,
     at least one launch each of rcd_interior, color_smooth_diffs,
     bilateral_band, grid_blur_xyz and wiener_tile_core, finite outputs;
     the four image tools card vs CPU at 1024x768 (RCD and the bilateral
     term 1e-5, the Wiener class 2e-5, the Laplacian through its LAB round
     trip one uint8 count).
 13. the sharded programs of parallel/ on meshes of the card repeated: the
     beetroot rig (12 cameras, 2472x2062 Packed12_IDS, its per-camera
     rotations) through ImageProcessor(mesh=make_mesh([cuda] * 4)) against
     the unsharded processor (bit for bit expected, 1 count at most, EMA
     state within the test bars); build_spatial_pipeline_fn on one FULL
     frame of artichoke's settings at 4096x3000 on 3 row bands (band 1000,
     halo 64) and build_grid_pipeline_fn on 2 frames over a (camera 2,
     band 3) mesh, each against build_pipeline_fn(..., rcd_strict_alias=
     False): 1 count, bounds atol 1e-6, metrics rtol 1e-5 atol 1e-6.  Each
     launches rcd_interior, color_smooth_diffs and bilateral_band once a
     band block of a frame (launch counts zeroed just before its first
     call), replays bit for bit with its first call, makes the host wait
     for the card nowhere (CUDA sync debugging, on the replays), and is
     timed replayed against its unsharded program replayed from its CUDA
     graph by CUDA events (the rig's unsharded processor: its capture
     seconds, peak memory and the memory its graph keeps reserved are
     printed; the rig's sharded stages: one capture each for the four
     shards).  With more than one card, the 3 bands also run over distinct
     cards (1 count).
 14. the viewer's controller (scripts/view_raw/pipeline_ui.py) on the card
     with matplotlib and Pillow blocked: a synthetic 4096x3000 frame in a
     temporary artichoke/ directory (the camera found by the directory
     name) through process_current, update_setting('tone_gamma', 2.0),
     apply_preset('reinhard'), rotate (the frame turns) and reset, with at
     least one launch of each of FULL's three kernels, printing after each
     step the workspaces that captured anew (the tone step may capture
     nothing) and the GiB the controller keeps reserved; then 3 frames in
     turns through an eager copy of the controller and the graphed one,
     bit for bit; encode_jpeg_bytes on the card gives FF D8 .. FF D9; the
     controller on the card against the same on the CPU at 1024x768 (1
     count).
After each phase, the GiB the caching allocator keeps reserved once the
phase's processors and graphs are gone.
Then one JSON line with FULL's graphed and eager numbers, config 2's and
config 3's and the piecewise frame's, one with the
JPEG numbers, one with the Laplacian's, one
with the command-line tools', one with the sharded programs' and the
viewer's, one with the kernels, the card's name and power limit, and the
result JSON as the last line.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
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
# FULL runs each of these once a frame and none of the other kernels (its
# Wiener stage takes the separable float16 route of the default denoise_f16),
FULL_KERNELS = ('rcd_interior', 'color_smooth_diffs', 'bilateral_band')
# and the LAB round trip's two kernels once a luminance stage of a frame:
# denoise and bilateral, and the local Laplacian where it is on.
LAB_KERNELS = ('lab_split', 'lab_merge')
WB = (1.2, 1.0, 1.1)
REPO = Path(__file__).resolve().parent


def log(*args):
    print(*args, flush=True)


def full_launches(frames, stages=2, full_kernels=FULL_KERNELS, **others):
    """The launches of `frames` frames of a FULL program with `stages`
    luminance stages: each of `full_kernels` once a frame, each LAB kernel
    once a stage, `others` as given, every other kernel 0."""
    from tpu_darktable_torch import kernels

    want = dict.fromkeys(kernels.launches, 0)
    want.update({k: frames for k in full_kernels}, **{k: stages * frames for k in LAB_KERNELS})
    want.update(others)
    return want


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


def chained_case(label, fn, x0, iters, per_pass=None, frames=1, timing_iters=2):
    """A BASELINE chain as benchmarks/baseline_configs.py:_bench_chained jits
    it: `iters` calls of fn on its own output, run eagerly and as one CUDA
    graph (its first call eager, then the capture; later calls replay).
    The graph's first and replayed outputs must equal the eager chain's bit
    for bit, and one replay must launch `per_pass` (kernel -> launches a
    pass) times iters.  ms of a pass by CUDA events in turns: eager,
    graphed, graphed, eager."""
    from tpu_darktable_torch import kernels
    from tpu_darktable_torch._graph import Graphed

    def chain(x):
        for _ in range(iters):
            x = fn(x)
        return x

    graphed = Graphed(chain)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = graphed(x0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    kernels.reset_launches()
    replayed = graphed(x0)
    torch.cuda.synchronize()
    total = {k: v for k, v in kernels.launches.items() if v}
    launches = {k: v / iters for k, v in total.items()}
    want = chain(x0)
    if not (torch.equal(first, want) and torch.equal(replayed, want)):
        raise AssertionError(f'{label}: the graphed chain differs from the eager chain')
    del first, replayed, want
    if per_pass is not None and total != {k: n * iters for k, n in per_pass.items()}:
        raise AssertionError(f'{label}: a replay of {iters} passes launched {total}, expected '
                             f'{per_pass} a pass')
    ms = {}
    for turn, f in (('eager 1', chain), ('graphed 1', graphed), ('graphed 2', graphed),
                    ('eager 2', chain)):
        ms[turn] = cuda_ms(lambda: f(x0), iters=timing_iters, warmup=1) / iters / frames
    report = dict(ms_per_frame=ms, first_call_s=first_s, launches_per_pass=launches)
    log(f'{label} as one graph of a {iters}-pass chain ({frames} frame(s) a pass), bit for bit '
        f'with the eager chain; ms/frame in turns: '
        + ', '.join(f'{k} {v:.3f}' for k, v in ms.items())
        + f'; first call (eager + capture) {first_s:.2f} s; '
        f'launches a pass {launches}')
    return report


WORKSPACES = ('rcd_workspace', 'ppg_workspace', 'postprocess_workspace', 'wiener_workspace',
              'bil_workspace')


def ungraphed(proc):
    """proc with its graphs taken out: its workspaces and batched program
    run eagerly (the eager copy that a graphed processor is held to)."""
    from tpu_darktable_torch._graph import Graphed

    for name in WORKSPACES:
        ws = getattr(proc, name)
        ws._graphs = ws._graphs.fn
    if isinstance(proc._fused, Graphed):
        proc._fused = proc._fused.fn
    return proc


def workspace_captures(proc):
    """name -> (the workspace object's id, its capture keys) of a
    processor's workspaces."""
    return {n: (id(getattr(proc, n)), tuple(getattr(proc, n)._graphs._captured))
            for n in WORKSPACES}


def reserved_gib():
    """What the caching allocator keeps reserved once its free blocks are
    returned: the pools of the graphs alive, and live tensors."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 2**30


def in_turns(runs, inputs):
    """Each (label, run) of `runs` over every input in turn, timed by the
    host clock to a synchronize: label -> (outputs, seconds)."""
    turns = {}
    for label, run in runs:
        outs, times = [], []
        for x in inputs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(run(x))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        turns[label] = (outs, times)
    return turns


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


def synthetic_frames(w, h, n, seed, ids=False):
    """Packed12 (or Packed12_IDS) bytes of smooth-plus-noise mosaics,
    encoded by the port."""
    from tpu_darktable_torch.ops.packed import encode12_float

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        base = 0.35 + 0.3 * np.sin(xx / (37.0 + 5 * i)) * np.cos(yy / 53.0)
        m = np.clip(base + rng.normal(0, 0.03, (h, w)), 0, 1).astype(np.float32)
        out.append(encode12_float(torch.from_numpy(m.reshape(-1)), ids_format=ids))
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
    log(f'kernels built in {time.perf_counter() - t0:.1f} s (per source: '
        + ', '.join(f'{k} {v:.1f} s' for k, v in seconds.items()) + ')')
    for source in dict.fromkeys(e.source for e in _build.ENTRIES.values()):
        lib = _build._lib_path(source)
        ptxas = [ln for ln in lib.with_suffix('.log').read_text().splitlines()
                 if 'registers' in ln or 'spill' in ln]
        log(f'  {source}: ' + ' | '.join(s.strip() for s in ptxas))
    return smi


# ---------------------------------------------------------------- phase 2

def phase_kernels(dev):
    """Each kernel vs its plain version at the shapes of its path."""
    from tpu_darktable_torch.kernels.bilateral_band import bilateral_band, bilateral_band_plain
    from tpu_darktable_torch.kernels.bilateral_fused import bilateral_fused, bilateral_fused_plain
    from tpu_darktable_torch.kernels.color_smooth import color_smooth_diffs, color_smooth_diffs_plain
    from tpu_darktable_torch.kernels.grid_blur import (W_DERIV, W_GAUSS, grid_blur_xyz,
                                                       grid_blur_xyz_plain)
    from tpu_darktable_torch.kernels.lab import lab_merge, lab_merge_plain, lab_split, lab_split_plain
    from tpu_darktable_torch.kernels.nlm import nlm_core, nlm_core_plain
    from tpu_darktable_torch.kernels.rcd_interior import RING, rcd_interior, rcd_interior_plain
    from tpu_darktable_torch.kernels.wavelet import wavelet_core, wavelet_core_plain
    from tpu_darktable_torch.ops import bilateral, color, packed, postprocess, rcd, tonemap
    from tpu_darktable_torch.ops import white_balance
    from tpu_darktable_torch.ops.bayer import BayerPattern, site_parities
    from tpu_darktable_torch.ops.bilateral import compute_grid_size
    from tpu_darktable_torch.pipeline.util import normalize_image

    frame = synthetic_frames(W, H, 1, seed=3)[0].to(dev)
    mosaic = packed.decode12_float(frame.reshape(H, W * 3 // 2))
    mosaic = white_balance.apply_white_balance(mosaic, torch.tensor(WB, device=dev),
                                               BayerPattern.RGGB)
    rgb = rcd.rcd_demosaic(mosaic, BayerPattern.RGGB)
    g = rgb[..., 1].contiguous()
    diffs = torch.stack((rgb[..., 0] - g, rgb[..., 2] - g))
    lum = color.rgb_to_lab(torch.clamp(rgb, 0.0, 1.0))[..., 0].contiguous()
    _, _, gz = compute_grid_size(W, H, 2.0, 0.2)
    px = H * W
    out = []

    def record(name, source, replaces, k_fn, p_fn, err_fn, tol, n_bytes, n_ops,
               also=(), library=None):
        """`also`: further (kernel, plain) pairs held to the same tolerance;
        `library`: one PyTorch call computing the same function, timed only."""
        errs = []
        for kf, pf in ((k_fn, p_fn), *also):
            k_out, p_out = kf(), pf()
            torch.cuda.synchronize()
            errs.append(err_fn(k_out, p_out))
            del k_out, p_out
        err = max(errs)
        log(f'{name}: max_abs_err {err:.3g} (tolerance {tol:g}; by shape: '
            + ', '.join(f'{e:.3g}' for e in errs) + ')')
        if not err <= tol:
            raise AssertionError(f'{name} disagrees with its plain version: {err} > {tol}')
        ms, plain_ms = cuda_ms(k_fn), cuda_ms(p_fn, iters=5)
        library_ms = None if library is None else cuda_ms(library)
        b_ms, b_by = bound(n_bytes, n_ops)
        log(f'{name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms} ms, '
            f'bound {b_ms:.4f} ms ({b_by})')
        out.append(dict(name=name, route='cuda', source=source, replaces=replaces,
                        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=library_ms))

    r = RING

    def rcd_pair(x, pattern):
        rp_, bp_ = site_parities(pattern)
        return (lambda: rcd_interior(x, r_par=rp_, b_par=bp_),
                lambda: rcd_interior_plain(x, r_par=rp_, b_par=bp_))

    ragged = mosaic[1:2999, 3:4005].contiguous()   # 2998x4002: no tile size divides it
    # ~200 float ops a pixel through the 12 steps (tallied from the source);
    # one read of the mosaic, three planes written.  Bit for bit (tolerance
    # 0) in every pattern and on the ragged frame.
    record('rcd_interior', 'tpu_darktable_torch/csrc/rcd_interior.cu',
           'tpu_darktable/kernels/rcd_interior.py:226',
           *rcd_pair(mosaic, BayerPattern.RGGB),
           lambda a, b: (a - b)[:, r:-r, r:-r].abs().max().item(), 0.0,
           4 * px + 12 * px, 200 * px,
           also=[rcd_pair(mosaic, BayerPattern[p]) for p in ('BGGR', 'GRBG', 'GBRG')]
           + [rcd_pair(ragged, BayerPattern.RGGB)])
    # What the function needs, not what a sorting network does: a 3x3
    # median is med3(max of the column minima, med3 of the column medians,
    # min of the column maxima), and a pixel's right-hand two columns are its
    # right neighbour's first two, so a pixel sorts one new column (6
    # min/max) and selects with 2 + 2 + 4 + 4, plus 3 for the recurrence:
    # 21 operations a pixel, plane and pass.  Two diff planes and g read
    # once, two planes written: bytes bind it.
    log(f'color_smooth_diffs: the 25-compare-exchange network would count 3 x 2 x 54 = 324 '
        f'operations a pixel ({bound(0, 324 * px)[0]:.4f} ms); the bound counts 3 x 2 x 21 = 126')
    record('color_smooth_diffs', 'tpu_darktable_torch/csrc/color_smooth.cu',
           'tpu_darktable/kernels/color_smooth.py:91',
           lambda: color_smooth_diffs(diffs, g, n_passes=3),
           lambda: color_smooth_diffs_plain(diffs, g, n_passes=3),
           lambda a, b: (a - b).abs().max().item(), 0.0,
           12 * px + 8 * px, 3 * 2 * 21 * px)
    # the algorithm: ~27 ops a pixel to splat, 3 x 5 taps x 2 ops a grid
    # cell (1.5 cells a pixel at s=2, gz=6), ~22 to slice; lum read once,
    # l_diff written once.  One source serves this wrapper and
    # bilateral_fused below; the plain version on the card differs by ~1e-7
    # because PyTorch's CUDA division by a scalar multiplies by the reciprocal.
    log('bilateral_band and bilateral_fused: two wrappers, one source '
        '(tpu_darktable_torch/csrc/bilateral_fused.cu)')
    record('bilateral_band', 'tpu_darktable_torch/csrc/bilateral_fused.cu',
           'tpu_darktable/kernels/bilateral_band.py:169',
           lambda: bilateral_band(lum, s=2, gz=gz, sigma_r=0.2),
           lambda: bilateral_band_plain(lum, s=2, gz=gz, sigma_r=0.2),
           lambda a, b: (a - b).abs().max().item(), 1e-5,
           4 * px + 4 * px, (27 + 45 + 22) * px)
    # The same function with either z blur: the same bytes and operations.
    _, _, gz8 = compute_grid_size(W, H, 8.0, 0.2)
    fused_pair = lambda s_, gz_, zm: (
        lambda: bilateral_fused(lum, s=s_, gz=gz_, sigma_r=0.2, z_mode=zm),
        lambda: bilateral_fused_plain(lum, s=s_, gz=gz_, sigma_r=0.2, z_mode=zm))
    record('bilateral_fused', 'tpu_darktable_torch/csrc/bilateral_fused.cu',
           'tpu_darktable/kernels/bilateral_fused.py:142',
           *fused_pair(2, gz, 'derivative'),
           lambda a, b: (a - b).abs().max().item(), 1e-6,
           4 * px + 4 * px, (27 + 45 + 22) * px,
           also=[fused_pair(2, gz, 'gaussian'), fused_pair(8, gz8, 'derivative')])

    # The denoise path's input: the FULL front end, normalized (config 3).
    rgb_n = postprocess.postprocess(rgb, BayerPattern.RGGB, 3, green_eq_global_enabled=True)
    rgb_n = normalize_image(rgb_n, tonemap.compute_image_bounds(rgb_n))
    planes = rgb_n.permute(2, 0, 1).contiguous()
    inv_h2 = 1.0 / (0.05 * 0.05 * 9 * 3)
    # Per pixel and offset (49 at sr=3): d2 3C = 9, the separable 3x3 box
    # sum 6, the weight 3 (negate, multiply, exp), acc and wsum 2C + 1 = 7:
    # 25; plus C divides.  Three planes read once and written once.
    # Also held to the tolerance: one plane alone (C = 1, the luminance call).
    plane1 = planes[:1].contiguous()
    record('nlm_core', 'tpu_darktable_torch/csrc/nlm.cu', 'tpu_darktable/kernels/nlm.py:87',
           lambda: nlm_core(planes, inv_h2), lambda: nlm_core_plain(planes, inv_h2),
           lambda a, b: (a - b).abs().max().item(), 1e-5,
           24 * px, (49 * 25 + 3) * px,
           also=[(lambda: nlm_core(plane1, 3 * inv_h2), lambda: nlm_core_plain(plane1, 3 * inv_h2))])
    log(f'nlm_core on one plane (C = 1): {cuda_ms(lambda: nlm_core(plane1, 3 * inv_h2)):.4f} ms')
    thr = torch.full((3,), 3.0 * 0.05, device=dev)
    # Per level, pixel and channel: two 5-tap blurs (9 ops each), the
    # detail 1, the shrink 5 (abs, subtract, max, sign, multiply), the
    # residual 1: 25, x 4 levels + the final add, x 3 channels.
    record('wavelet_core', 'tpu_darktable_torch/csrc/wavelet.cu',
           'tpu_darktable/kernels/wavelet.py:117',
           lambda: wavelet_core(planes, thr, levels=4),
           lambda: wavelet_core_plain(planes, thr, levels=4),
           lambda a, b: (a - b).abs().max().item(), 1e-6,
           24 * px, 3 * (4 * 25 + 1) * px,
           also=[(lambda lv=lv: wavelet_core(planes, thr, levels=lv),
                  lambda lv=lv: wavelet_core_plain(planes, thr, levels=lv)) for lv in (5, 7)])
    # What a level costs: in the shared-memory tile (the first ones) and as
    # two passes through HBM (the differences further up).
    sweep = {lv: cuda_ms(lambda: wavelet_core(planes, thr, levels=lv), iters=10, warmup=2)
             for lv in range(9)}
    log('wavelet_core ms by levels: ' + ', '.join(f'{lv}: {t:.4f}' for lv, t in sweep.items()))
    # The LAB round trip of the luminance stages (csrc/lab.cu) on the denoise
    # stage's input, and back with the bilateral stage's new plane: bit for
    # bit with the plain chain on the card (the split's two planes: the L of
    # the clipped values, FULL's denoise, and L itself, its bilateral).  28
    # bytes a pixel each way (12 in, 16 out; 16 in, 12 out); ~70 and ~60
    # float operations a pixel with each powf counted as one: bytes bind.
    pair_err = lambda a, b: max((x - y).abs().max().item() for x, y in zip(a, b))
    split_pair = lambda cl: (lambda: lab_split(rgb_n, clipped_l=cl),
                             lambda: lab_split_plain(rgb_n, clipped_l=cl))
    no_tpu_kernel = 'none: the JAX package leaves the round trip to XLA'
    record('lab_split', 'tpu_darktable_torch/csrc/lab.cu', no_tpu_kernel, *split_pair(True),
           pair_err, 0.0, 28 * px, 70 * px, also=[split_pair(False)])
    lab, l_clip = lab_split(rgb_n, clipped_l=True)
    new_l = bilateral.bilateral_process(l_clip, 2.0, 0.2, 0.4)
    record('lab_merge', 'tpu_darktable_torch/csrc/lab.cu', no_tpu_kernel,
           lambda: lab_merge(lab, new_l), lambda: lab_merge_plain(lab, new_l),
           lambda a, b: (a - b).abs().max().item(), 0.0, 28 * px, 60 * px)
    del lab, l_clip, new_l
    record_wiener_core(dev, record, rgb_n)
    # The general path's grid: sigma_s = 3 does not divide 4096.
    gx3, gy3, gz3 = compute_grid_size(W, H, 3.0, 0.2)
    op = bilateral._windowed(H, W, gx3, gy3, 3.0, dev)
    g_z = bilateral._z_coords(lum, 0.2, gz3)[0]
    grid = torch.stack([op.splat(torch.clamp(1.0 - torch.abs(g_z - z), min=0.0) / 9.0)
                        for z in range(gz3)])
    log(f'general-path grid at sigma_s 3: {tuple(grid.shape)}')
    cells = grid.numel()
    # The same function as one cuDNN call: a 5x5x5 outer-product kernel,
    # zero padding 2.  TF32 off, so cuDNN convolves in float32.
    torch.backends.cudnn.allow_tf32 = False
    w3 = (torch.tensor(W_DERIV)[:, None, None] * torch.tensor(W_GAUSS)[None, :, None]
          * torch.tensor(W_GAUSS)[None, None, :]).to(dev)[None, None]
    conv = lambda: torch.nn.functional.conv3d(grid[None, None], w3, padding=2)[0, 0]
    log('library yardstick of grid_blur_xyz: one conv3d, torch.backends.cudnn.allow_tf32 = False; '
        f'max |diff| to the kernel {(grid_blur_xyz(grid) - conv()).abs().max().item():.3g}')
    # Per cell: x and y 5 taps (9 ops each), z derivative 4 taps (7 ops);
    # the grid read once and written once.
    record('grid_blur_xyz', 'tpu_darktable_torch/csrc/grid_blur.cu',
           'tpu_darktable/kernels/grid_blur.py:62',
           lambda: grid_blur_xyz(grid), lambda: grid_blur_xyz_plain(grid),
           lambda a, b: (a - b).abs().max().item(), 1e-6,
           8 * cells, 25 * cells,
           also=[(lambda: grid_blur_xyz(grid, z_mode='gaussian'),
                  lambda: grid_blur_xyz_plain(grid, z_mode='gaussian'))],
           library=conv)
    return out


def radix2_fft_ops(n):
    """Float operations of one n-point complex FFT as csrc/wiener_core.cu
    runs it: 4 a butterfly, and a twiddle costs 0 (1, -i), 4 ((+-1 - i) /
    sqrt 2) or 6."""
    ops, half = 0, n // 2
    while half >= 1:
        for j in range(half):
            turn32 = j * (n // (2 * half)) * (32 // n)
            ops += (n // (2 * half)) * (4 + (0 if turn32 in (0, 8) else 4 if turn32 in (4, 12) else 6))
        half //= 2
    return ops


def record_wiener_core(dev, record, rgb_n):
    """wiener_tile_core on the coset slabs FULL's log-L plane gives it (K=32,
    overlap 4, C=1: (16, 3072, 4160)), and on K=16, overlap 2, C=3 slabs of
    a 1024x768 crop, against the dense folded-basis einsums."""
    from tpu_darktable_torch.kernels.wiener_core import (folded_bases, wiener_tile_core,
                                                         wiener_tile_core_plain)
    from tpu_darktable_torch.ops import color, wiener

    def slabs_of(x, k, ov):
        xr, n_ty, n_tx = wiener._reflect_pad(x, k, ov)
        return wiener._coset_slabs(xr, k, ov, n_ty, n_tx)

    k = 32
    log_l = torch.log(torch.clamp(color.rgb_to_lab_with_clipped_l(rgb_n)[1], min=1e-4))
    slabs = slabs_of(log_l[..., None], k, 4)
    sig2 = torch.full((1,), 0.075 ** 2, device=dev)
    wf, wi = wiener._gaussian_window(k, 0.3), wiener._gaussian_window(k, 0.3)
    small = slabs_of(rgb_n[:768, :1024], 16, 2)
    sig2_3 = torch.tensor([0.05, 0.03, 0.04], device=dev) ** 2
    w16 = wiener._gaussian_window(16, 0.3)
    log(f'wiener_tile_core slabs {tuple(slabs.shape)} (K=32, overlap 4, C=1) and '
        f'{tuple(small.shape)} (K=16, overlap 2, C=3); max |x| {slabs.abs().max().item():.3f}')
    n_tiles = slabs.numel() // (k * k)
    # The library yardstick: the two dense products of the plain version as
    # torch.matmul calls on tile-major operands, TF32 off.
    torch.backends.cuda.matmul.allow_tf32 = False
    ana3, syn3, _, _, n_rep = folded_bases(k, wf, wi, dev)
    ana_t = ana3.reshape(-1, k * k).t().contiguous()
    syn = syn3.reshape(-1, k * k).contiguous()
    g = slabs.shape[0]
    tiles = (slabs.reshape(g, -1, k, slabs.shape[2] // k, k).permute(0, 1, 3, 2, 4)
             .reshape(n_tiles, k * k).contiguous())
    spec = torch.matmul(tiles, ana_t)[:, : 2 * n_rep].contiguous()

    def two_matmuls():
        torch.matmul(tiles, ana_t)
        torch.matmul(spec, syn)

    # Tolerance: the kernel windows (t - m) and runs an FFT; the plain
    # version transforms t with dense bases and subtracts m * a0 afterwards,
    # so the two differ by float32 rounding of sums whose terms reach
    # max|t| * sum(wf2): 2e-6 * max(1, max|t|).
    tol = 2e-6 * max(1.0, slabs.abs().max().item())
    # Operations the function needs, whatever the kernel does: a real 2-D
    # transform of N = K^2 points forward and inverse by FFT, 2.5 N log2 N
    # each way, plus ~24 K^2 for the mean, both windows and the gain: 75,776
    # a tile at K=32, under the 8 bytes a pixel, so the function is bound by
    # bytes.  (As run: two tiles ride one complex transform, four passes of
    # K radix-2 FFTs with the trivial twiddles written out, the split and
    # gain with K + 2 divisions a lane, windows and mean ~12 a pixel; logged
    # below, not part of the bound.)
    need_ops = 5 * k * k * int(np.log2(k * k)) + 24 * k * k
    split_ops = 4 + 6 + 14 * (k + 2) / (2 * k)   # a complex value: split, apply, its share of gains
    run_ops = round((4 * k * radix2_fft_ops(k) + k * k * split_ops) / 2 + 12 * k * k)
    log(f'wiener_tile_core operations a tile: {need_ops} needed (5 N log2 N count), {run_ops} as '
        f'run ({radix2_fft_ops(k)} a {k}-point complex FFT); '
        f'as run {n_tiles * run_ops / FP32_OPS_PER_S * 1e3:.4f} ms at the peak rate')
    record('wiener_tile_core', 'tpu_darktable_torch/csrc/wiener_core.cu',
           'tpu_darktable/kernels/wiener_core.py:70',
           lambda: wiener_tile_core(slabs, sig2, wf, wi, k=k),
           lambda: wiener_tile_core_plain(slabs, sig2, wf, wi, k=k),
           lambda a, b: (a - b).abs().max().item(), tol,
           8 * slabs.numel(), n_tiles * need_ops,
           also=[(lambda: wiener_tile_core(small, sig2_3, w16, w16, k=16),
                  lambda: wiener_tile_core_plain(small, sig2_3, w16, w16, k=16))],
           library=two_matmuls)
    log(f'library yardstick of wiener_tile_core: torch.matmul ({n_tiles}, {k * k}) x '
        f'({k * k}, {2 * n_rep + 1}) and ({n_tiles}, {2 * n_rep}) x ({2 * n_rep}, {k * k}), '
        'torch.backends.cuda.matmul.allow_tf32 = False')


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

def phase_card_vs_cpu(dev, settings, label='FULL'):
    import tpu_darktable_torch as tt

    w, h = 1024, 768
    frames = synthetic_frames(w, h, 1, seed=5)
    outs = []
    for d in (dev, torch.device('cpu')):
        proc = tt.ImageProcessor((w, h), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                                 settings, device=d, white_balance=WB)
        outs.append(proc.process_batch(frames).cpu().numpy().astype(int))
    d = int(np.abs(outs[0] - outs[1]).max())
    log(f'{label} card vs cpu at {w}x{h}: max |diff| {d} count(s), '
        f'{(outs[0] != outs[1]).mean():.2e} of values differ')
    if d > 1:
        raise AssertionError(f'card and CPU differ by {d} counts')


# ---------------------------------------------------------------- phase 5

def full_turn(run, batches):
    """One pass of a FULL program over the batches from the first batch's
    EMA state: each batch's (uint8, bounds, metrics) and host seconds (to a
    synchronize).  run(k, batch) -> (uint8, bounds, metrics)."""
    outs, times = [], []
    for k, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(run(k, b))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return outs, times


def phase_full(dev):
    """FULL through ImageProcessor (its batched program captured as a CUDA
    graph on the first call and replayed after) and through an eager copy
    of build_pipeline_fn, in turns: eager, graphed, graphed, eager.  The
    second turn is the main path's run (launch counts and peak memory).
    Then one more graphed turn with the tracer on (a capture of its own):
    bit for bit with the rest, its capture seconds the tracer's
    graph.capture span and each stage's card ms a frame its marks."""
    import tpu_darktable_torch as tt
    from tpu_darktable_torch import kernels
    from tpu_darktable_torch.utils import timing

    s = full_settings()
    proc = tt.ImageProcessor((W, H), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                             s, device=dev, white_balance=WB)
    fn = tt.build_pipeline_fn(s, (W, H), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12, True)
    batches = [synthetic_frames(W, H, BATCH, seed=100 + b).to(dev) for b in range(N_BATCHES)]
    f32 = dict(dtype=torch.float32, device=dev)
    wb = torch.tensor(WB, **f32)

    def eager(k, b):
        if k == 0:
            eager.state = (torch.zeros(2, **f32), torch.zeros(5, **f32))
        alpha = torch.full((), 1.0 if k == 0 else s.moving_average, **f32)
        out, bounds, metrics = fn(b, wb, *eager.state, alpha)
        eager.state = (bounds, metrics)
        return out, bounds, metrics

    def graphed(k, b):
        if k == 0:
            proc.bounds = proc.metrics = None
        return proc.process_batch(b), proc.bounds, proc.metrics

    turns = {'eager 1': full_turn(eager, batches)}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    turns['graphed 1'] = full_turn(graphed, batches)
    launches = dict(kernels.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30  # before the checks allocate
    torch.cuda.empty_cache()
    # what the processor keeps reserved: its graph's pool, static buffers and outputs
    graph_gib = (torch.cuda.memory_reserved() - base) / 2**30
    turns['graphed 2'] = full_turn(graphed, batches)
    turns['eager 2'] = full_turn(eager, batches)
    timing.reset()
    timing.enable()
    try:
        turns['traced 1'] = full_turn(graphed, batches)
        marks, spans = timing.marks(), timing.spans()
    finally:
        timing.disable()
    out = turns['graphed 1'][0][-1][0]
    times = turns['graphed 1'][1]

    log(f'FULL launches: {launches}')
    want = full_launches(BATCH * N_BATCHES)
    if launches != want:
        raise AssertionError(f'the FULL path launched {launches}, expected {want}')
    if tuple(out.shape) != (BATCH, H, W, 3) or out.dtype != torch.uint8:
        raise AssertionError(f'FULL output {tuple(out.shape)} {out.dtype}')
    if not (torch.isfinite(proc.bounds).all() and torch.isfinite(proc.metrics).all()):
        raise AssertionError('non-finite EMA state')
    if out.float().std().item() < 1.0:
        raise AssertionError('FULL output is flat')
    steady = sum(times[1:]) / (len(times) - 1)
    log(f'FULL {W}x{H} batch {BATCH}: batch seconds {[round(t, 4) for t in times]}; '
        f'{steady / BATCH * 1e3:.2f} ms/frame, {BATCH / steady:.2f} frames/s (batches 2..{N_BATCHES}); '
        f'peak device memory {peak_gib:.2f} GiB')
    log(f'FULL bounds {proc.bounds.tolist()} metrics {proc.metrics.tolist()}')

    # the graphed program against the eager copy, bit for bit, every batch
    ref = turns['eager 1'][0]
    for label, (outs, _) in turns.items():
        for k, (got, want) in enumerate(zip(outs, ref)):
            names = [n for n, a, b in zip(('uint8', 'bounds', 'metrics'), got, want)
                     if not torch.equal(a, b)]
            if names:
                raise AssertionError(f'FULL {label} batch {k + 1}: {names} differ from the eager '
                                     'program (bit for bit expected)')
    def ms_per_frame(label, t):
        t = t[1:] if label.endswith('1') else t   # a program's first turn: batches 2..N
        return sum(t) / (len(t) * BATCH) * 1e3

    report = dict(
        peak_gib=peak_gib, graph_reserved_gib=graph_gib,
        batch_seconds={k: v[1] for k, v in turns.items()},
        ms_per_frame={k: ms_per_frame(k, v[1]) for k, v in turns.items()},
        traced=traced_stages(marks, spans))
    log(f'FULL graphed vs eager in turns (eager, graphed, graphed, eager, then graphed with the '
        f'tracer on), bit for bit in every batch (uint8, bounds, metrics); ms/frame (the first '
        f'turn of each program over batches 2..{N_BATCHES}, the second over all): '
        + ', '.join(f'{k} {v:.2f}' for k, v in report['ms_per_frame'].items())
        + f'; peak {peak_gib:.2f} GiB, {graph_gib:.2f} GiB kept reserved by the graphed processor')
    log(f'FULL traced turn: capture {report["traced"]["capture_s"]} s (graph.capture); card ms '
        f'a frame from the mark before, batches 2..{N_BATCHES} (replays): '
        + ', '.join(f'{k} {v:.3f}' for k, v in report['traced']['card_ms'].items()))
    return launches, report


def traced_stages(marks, spans):
    """The traced FULL turn's capture seconds (its graph.capture spans) and
    each mark's card ms a frame from the mark before it in its call, over
    the replayed calls (all but the first, eager call), with their sum as
    'all'.  Every call must hold the first call's marks, begin to tonemap."""
    calls = {}
    for m in marks:
        calls.setdefault(m.call, []).append(m)
    calls = [calls[k] for k in sorted(calls)]
    names = [m.name for m in calls[0]]
    if len(calls) != N_BATCHES or names[0] != 'begin' or names[-1] != 'tonemap' \
            or any([m.name for m in c] != names for c in calls):
        raise AssertionError(f'FULL traced turn: {len(calls)} calls, marks {names}')
    card_ms = {}
    for c in calls[1:]:
        for a, b in zip(c, c[1:]):
            card_ms[b.name] = card_ms.get(b.name, 0.0) + (b.ns - a.ns) * 1e-6
    frames = BATCH * (N_BATCHES - 1)
    card_ms = {k: v / frames for k, v in card_ms.items()}
    card_ms['all'] = sum(card_ms.values())
    return dict(capture_s=[round(x.end - x.start, 4) for x in spans if x.name == 'graph.capture'],
                card_ms=card_ms)


def profile_full(dev):
    """The card's busy time and idle share of one FULL batch of 4, replayed
    from its graph and eager, after phase 10's profiling."""
    import tpu_darktable_torch as tt

    s = full_settings()
    proc = tt.ImageProcessor((W, H), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                             s, device=dev, white_balance=WB)
    fn = tt.build_pipeline_fn(s, (W, H), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12, True)
    batch = synthetic_frames(W, H, BATCH, seed=100).to(dev)
    f32 = dict(dtype=torch.float32, device=dev)
    state = (torch.tensor(WB, **f32), torch.zeros(2, **f32), torch.zeros(5, **f32),
             torch.ones((), **f32))
    proc.process_batch(batch)   # the eager first call and the capture
    report = {'full_graphed_batch_4': device_busy(lambda: proc.process_batch(batch)),
              'full_eager_batch_4': device_busy(lambda: fn(batch, *state))}
    for label, r in report.items():
        log(f'profile of {label}: {r}')
    return report


# ---------------------------------------------------------------- phase 6

def front_end_raw(dev, batch):
    """decode, WB, RCD, postprocess of a (B, n_bytes) batch -> (B, H, W, 3),
    as the pipeline's first loop."""
    from tpu_darktable_torch.ops import packed, postprocess, rcd, white_balance
    from tpu_darktable_torch.ops.bayer import BayerPattern

    wb = torch.tensor(WB, device=dev)
    rgb = torch.empty((batch.shape[0], H, W, 3), dtype=torch.float32, device=dev)
    for i in range(batch.shape[0]):
        mosaic = white_balance.apply_white_balance(
            packed.decode12_float(batch[i].reshape(H, W * 3 // 2)), wb, BayerPattern.RGGB)
        rgb[i] = postprocess.postprocess(rcd.rcd_demosaic(mosaic, BayerPattern.RGGB),
                                         BayerPattern.RGGB, 3, green_eq_global_enabled=True)
    return rgb


def front_end(dev, n, seed):
    """n frames of demosaiced RGB as FULL hands them to its denoise stage:
    decode, WB, RCD, postprocess, then normalize by the set's bounds."""
    from tpu_darktable_torch.ops import tonemap
    from tpu_darktable_torch.pipeline.util import normalize_image

    rgb = front_end_raw(dev, synthetic_frames(W, H, n, seed).to(dev))
    return normalize_image(rgb, tonemap.compute_image_bounds(rgb))


def phase_denoise(dev):
    """BASELINE config 3: wavelet then NLM denoise (sigma 0.05) on 8 frames
    of 4096x3000 demosaiced RGB, one frame at a time."""
    from tpu_darktable_torch import denoise, kernels

    n = 8
    rgb = front_end(dev, n, seed=300)
    out = torch.empty_like(rgb)

    def one_pass():
        for i in range(n):
            out[i] = denoise.nlm_denoise(denoise.wavelet_denoise(rgb[i], 0.05), 0.05)

    one_pass()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    one_pass()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30  # before the checks allocate
    log(f'config 3 launches: {launches}')
    if launches['wavelet_core'] != n or launches['nlm_core'] != n:
        raise AssertionError(f'config 3 launched wavelet_core {launches["wavelet_core"]} and '
                             f'nlm_core {launches["nlm_core"]} times, expected {n} each')
    if not torch.isfinite(out).all():
        raise AssertionError('config 3 output is not finite')
    s_in, s_out = rgb.std().item(), out.std().item()
    if not s_out < s_in:
        raise AssertionError(f'config 3 output std {s_out} is not below the input std {s_in}')
    log(f'config 3 (wavelet + NLM) {W}x{H}x3 batch {n}: {seconds / n * 1e3:.2f} ms/frame, '
        f'{n / seconds:.2f} frames/s; std {s_in:.5f} -> {s_out:.5f}; '
        f'peak device memory {peak_gib:.2f} GiB')
    del out

    def denoise_pass(x):
        y = torch.empty_like(x)
        for i in range(x.shape[0]):
            y[i] = denoise.nlm_denoise(denoise.wavelet_denoise(x[i], 0.05), 0.05)
        return y

    # as benchmarks/baseline_configs.py chains it: 2 passes
    report = chained_case(f'config 3 (wavelet + NLM) {W}x{H}x3 batch {n}', denoise_pass, rgb, 2,
                          per_pass={'wavelet_core': n, 'nlm_core': n}, frames=n)
    report.update(eager_pass_ms_per_frame=seconds / n * 1e3, peak_gib=peak_gib)
    return launches, report


def phase_config2(dev):
    """BASELINE config 2 (benchmarks/baseline_configs.py:107-123): PPG and
    RCD demosaic, each with 3 colour-smoothing passes, of 8 mosaics of
    4096x3000, chained 3 passes as one graph against the eager chain: 8
    rcd_interior and 16 color_smooth_diffs launches a pass."""
    from tpu_darktable_torch.ops import demosaic, postprocess, rcd
    from tpu_darktable_torch.ops.bayer import BayerPattern

    n, p = 8, BayerPattern.RGGB
    mosaics = torch.from_numpy(
        (np.random.default_rng(0).random((n, H, W)) * 0.8).astype(np.float32)).to(dev)

    def demosaic_pass(x):
        y = torch.empty_like(x)
        for i in range(x.shape[0]):
            a = postprocess.postprocess(demosaic.ppg_demosaic(x[i], p), p, color_smoothing_passes=3)
            b = postprocess.postprocess(rcd.rcd_demosaic(x[i], p), p, color_smoothing_passes=3)
            y[i] = (a + b)[..., 1] * 0.5   # one plane fed back, as the config chains it
        return y

    return chained_case(f'config 2 (PPG + RCD + postprocess) {W}x{H} batch {n}', demosaic_pass,
                        mosaics, 3, per_pass={'rcd_interior': n, 'color_smooth_diffs': 2 * n},
                        frames=n, timing_iters=1)


# ---------------------------------------------------------------- phase 7

def phase_general_bilateral(dev):
    """FULL with bil_sigma_spatial = 3 (3 does not divide 4096): the general
    bilateral path through ImageProcessor, 2 batches of 4; then card vs
    CPU at 1024x768, and one bilateral_denoise of a 12 MP plane."""
    import tpu_darktable_torch as tt
    from tpu_darktable_torch import kernels
    from tpu_darktable_torch.ops import bilateral, color

    settings = dataclasses.replace(full_settings(), bil_sigma_spatial=3.0)
    proc = tt.ImageProcessor((W, H), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                             settings, device=dev, white_balance=WB)
    n_batches = 2
    batches = [synthetic_frames(W, H, BATCH, seed=400 + b).to(dev) for b in range(n_batches)]
    torch.cuda.synchronize()
    kernels.reset_launches()
    times = []
    for b in batches:
        t0 = time.perf_counter()
        out = proc.process_batch(b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(kernels.launches)
    log(f'general bilateral launches: {launches}')
    n = BATCH * n_batches
    want = full_launches(n, full_kernels=('rcd_interior', 'color_smooth_diffs'), grid_blur_xyz=n)
    if launches != want:
        raise AssertionError(f'general bilateral launched {launches}, expected {want}')
    if tuple(out.shape) != (BATCH, H, W, 3) or out.float().std().item() < 1.0:
        raise AssertionError(f'general bilateral output {tuple(out.shape)} is wrong or flat')
    log(f'FULL with sigma_s 3 (general bilateral) {W}x{H} batch {BATCH}: batch seconds '
        f'{[round(t, 4) for t in times]}; {times[-1] / BATCH * 1e3:.2f} ms/frame (batch 2)')

    phase_card_vs_cpu(dev, settings, label='general bilateral')

    lum = color.compute_luminance(front_end(dev, 1, seed=500)[0])
    kernels.reset_launches()
    t0 = time.perf_counter()
    den = bilateral.bilateral_denoise(lum, 3.0, 0.2, 1.0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if kernels.launches['grid_blur_xyz'] != 2 or not torch.isfinite(den).all():
        raise AssertionError(f'bilateral_denoise: {kernels.launches["grid_blur_xyz"]} grid blur '
                             'launches (expected 2) or non-finite output')
    log(f'bilateral_denoise of a {W}x{H} plane: {ms:.2f} ms (first call), std '
        f'{lum.std().item():.5f} -> {den.std().item():.5f}')
    stage = {f'sigma_s {s:g}': cuda_ms(lambda: bilateral.bilateral_process(lum, s, 0.2, 0.4),
                                       iters=3, warmup=1)
             for s in (3.0, 2.0)}
    log(f'bilateral_process alone on a {W}x{H} plane, ms: {stage} '
        '(3: general path with grid_blur_xyz; 2: fast path, bilateral_band in one launch)')
    return launches


# ---------------------------------------------------------------- phase 8

def phase_wiener_route(dev):
    """The Wiener routes at full width: the tile core against the separable
    einsums; then FULL for one batch through process_batch (the separable
    float16 route) against a local copy of its back end, and against FULL
    with denoise_f16 off (the tile core)."""
    import statistics

    import tpu_darktable_torch as tt
    from tpu_darktable_torch import kernels
    from tpu_darktable_torch.kernels.bilateral_fused import bilateral_fused
    from tpu_darktable_torch.ops import bilateral, color, tonemap, wiener
    from tpu_darktable_torch.pipeline.util import normalize_image

    s = full_settings()
    rgb = front_end(dev, 1, seed=600)[0]
    log_l = torch.log(torch.clamp(color.rgb_to_lab_with_clipped_l(rgb)[1], min=1e-4))[..., None]
    f16 = dict(spectral_dtype=torch.float16, storage_dtype=torch.float16)
    for label, x, sig in (('log-L plane (C=1)', log_l, s.denoise),
                          ('RGB frame (C=3)', rgb, [0.05, 0.03, 0.04])):
        tile_fn = lambda: wiener.wiener_denoise(x, sig, 32, s.denoise_overlap, use_separable=False)
        f16_fn = lambda: wiener.wiener_denoise(x, sig, 32, s.denoise_overlap, **f16)
        f32_fn = lambda: wiener.wiener_denoise(x, sig, 32, s.denoise_overlap)
        tile = tile_fn()
        d32 = (tile - f32_fn()).abs().max().item()
        d16 = (tile - f16_fn()).abs().max().item()
        del tile
        log(f'wiener_denoise {W}x{H} {label}, tile-core route vs separable: max |diff| '
            f'{d32:.3g} (float32, bar 1e-3), {d16:.3g} (float16 storage: the storage rounding '
            f'itself, no bar)')
        if not d32 <= 1e-3:
            raise AssertionError(f'wiener tile-core route differs from the separable route by '
                                 f'{d32} on the {label}')
        # in turns: separable f16, tile core, tile core, separable f16
        t_sep, t_tile = [], []
        for _ in range(3):
            a, b = cuda_ms(f16_fn, iters=3, warmup=1), cuda_ms(tile_fn, iters=3, warmup=1)
            c, d = cuda_ms(tile_fn, iters=3, warmup=1), cuda_ms(f16_fn, iters=3, warmup=1)
            t_sep += [a, d]
            t_tile += [b, c]
        won = all(t < o for o, t in zip(t_sep, t_tile))
        log(f'wiener_denoise {W}x{H} {label} ms in turns: tile core median '
            f'{statistics.median(t_tile):.3f} ({min(t_tile):.3f}-{max(t_tile):.3f}), separable '
            f'float16 storage median {statistics.median(t_sep):.3f} ({min(t_sep):.3f}-'
            f'{max(t_sep):.3f}), separable float32 {cuda_ms(f32_fn, iters=3, warmup=1):.3f}; '
            f'tile core won every pair: {won}')
        if not won:
            raise AssertionError(f'the tile-core route lost a pair on the {label}')
    del rgb, log_l

    # FULL, one batch of 4: the back end of pipeline/image_processor.py copied
    # here on the separable float16 route, its bilateral detail term through
    # kernels.bilateral_fused (one source with the pipeline's bilateral_band),
    # against process_batch.  The only pipeline-shaped path of bilateral_fused.
    batch = synthetic_frames(W, H, BATCH, seed=100).to(dev)
    proc = tt.ImageProcessor((W, H), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12, s,
                             device=dev, white_balance=WB)
    ref = proc.process_batch(batch)
    rgb = front_end_raw(dev, batch)
    bounds = tonemap.compute_image_bounds(rgb[:, ::8, ::8], stride=1)
    _, _, gz = bilateral.compute_grid_size(W, H, s.bil_sigma_spatial, s.bil_sigma_luminance)
    norm = -s.bilateral * s.bil_sigma_luminance * 4.0
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    samples = []
    for i in range(BATCH):
        x = normalize_image(rgb[i], bounds)
        lab, l_clip = color.rgb_to_lab_with_clipped_l(x)
        den = wiener.wiener_denoise(torch.log(torch.clamp(l_clip, min=1e-4))[..., None], s.denoise,
                                    32, s.denoise_overlap, **f16)[..., 0]
        x = color.lab_modify_luminance(lab, torch.exp(den + 1e-4))
        lab = color.rgb_to_lab(x)
        lum = lab[..., 0].contiguous()
        l_diff = bilateral_fused(lum, s=int(s.bil_sigma_spatial), gz=gz,
                                 sigma_r=s.bil_sigma_luminance)
        rgb[i] = color.lab_modify_luminance(lab, torch.clamp(lum + norm * l_diff, min=0.0))
        samples.append(rgb[i, ::8, ::8])
    metrics = tonemap.compute_image_metrics(torch.stack(samples), stride=1)
    params = tonemap.TonemapParameters(s.tone_gamma, s.tone_intensity, s.light_adapt, s.vibrance)
    out = tonemap.aces_tonemap(rgb, params, metrics)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.launches)
    log(f'local back-end copy launches: {launches}')
    if launches['bilateral_fused'] != BATCH or launches['wiener_tile_core'] != 0 \
            or launches['bilateral_band'] != 0:
        raise AssertionError(f'the local back-end copy launched {launches}')
    if out.shape != ref.shape or out.dtype != torch.uint8:
        raise AssertionError(f'local back-end copy output {tuple(out.shape)} {out.dtype}')
    diff = (out.to(torch.int16) - ref.to(torch.int16)).abs()
    log(f'FULL {W}x{H} batch {BATCH} (process_batch, separable float16 route, bilateral_band) '
        f'against the local back-end copy (bilateral_fused): max |diff| {diff.max().item()} '
        f'count(s), {(diff > 0).float().mean().item():.3e} of values differ; back end + '
        f'tonemap {seconds / BATCH * 1e3:.2f} ms/frame')
    if diff.max().item() > 1:
        raise AssertionError(f'the local back-end copy differs from process_batch by '
                             f'{diff.max().item()} counts')
    del rgb, out

    # The tile core's pipeline path: FULL with denoise_f16 off.
    tile_proc = tt.ImageProcessor((W, H), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                                  dataclasses.replace(s, denoise_f16=False), device=dev,
                                  white_balance=WB)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    tiled = tile_proc.process_batch(batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    tile_launches = dict(kernels.launches)
    log(f'FULL with denoise_f16 off launches: {tile_launches}')
    want = full_launches(BATCH, wiener_tile_core=BATCH)
    if tile_launches != want:
        raise AssertionError(f'FULL with denoise_f16 off launched {tile_launches}, expected {want}')
    diff = (tiled.to(torch.int16) - ref.to(torch.int16)).abs()
    over_1 = (diff > 1).float().mean().item()
    log(f'FULL {W}x{H} batch {BATCH} with denoise_f16 off (wiener_tile_core) against the default '
        f'(separable float16 route): max |diff| {diff.max().item()} count(s), '
        f'{(diff > 0).float().mean().item():.3e} of values differ, {over_1:.3e} by more than 1; '
        f'{seconds / BATCH * 1e3:.2f} ms/frame (first batch)')
    if over_1 != 0.0:
        raise AssertionError(f'{over_1} of FULL\'s values move by more than 1 count between the '
                             'Wiener routes')
    return dict(bilateral_fused=launches['bilateral_fused'],
                wiener_tile_core=tile_launches['wiener_tile_core'])


# ---------------------------------------------------------------- phase 9

def piecewise(proc, data):
    """One frame through the piecewise entry point, carrying its own bounds
    and metrics as the fused path computes them (stride 8)."""
    import tpu_darktable_torch as tt

    rgb = proc.load_image(data)
    rgb = proc.process_rgb(rgb, tt.compute_image_bounds([rgb], stride=8))
    return proc.tonemap(rgb, tt.compute_image_metrics([rgb], stride=8))


def phase_piecewise(dev):
    """The piecewise entry point at 4096x3000 with FULL's settings and the
    fused run's bounds and metrics: the first frame (eager, then each
    workspace's capture) within 1 count of the fused output with one
    launch of each of FULL's kernels; then 3 frames in turns through an
    eager copy and the graphed processor (eager, graphed, graphed, eager),
    every frame bit for bit with the first eager turn."""
    import tpu_darktable_torch as tt
    from tpu_darktable_torch import kernels

    s = full_settings()
    mk = lambda size, settings, d: tt.ImageProcessor(
        size, tt.BayerPattern.RGGB, tt.PackedFormat.Packed12, settings, device=d,
        white_balance=WB)
    frame = synthetic_frames(W, H, 1, seed=700)[0].to(dev)
    fused_proc = mk((W, H), s, dev)
    fused = fused_proc.process(frame, 'x')
    bounds, metrics = fused_proc.bounds, fused_proc.metrics
    del fused_proc
    base = reserved_gib()

    def run(p, data):
        rgb = p.debayer(p.load_bytes(data))
        return p.tonemap(p.process_rgb(rgb, bounds), metrics)

    proc = mk((W, H), s, dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = run(proc, frame)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.launches)
    pool_gib = reserved_gib() - base
    d = int((out.to(torch.int16) - fused.to(torch.int16)).abs().max().item())
    log(f'piecewise {W}x{H} (load_bytes -> debayer -> process_rgb -> tonemap, FULL settings): '
        f'max |diff| to the fused path {d} count(s); {ms:.2f} ms (first call: eager, then the '
        f'captures); launches {launches}; the processor keeps {pool_gib:.2f} GiB reserved')
    if d > 1 or tuple(out.shape) != (H, W, 3) or out.dtype != torch.uint8:
        raise AssertionError(f'piecewise differs from fused by {d} counts, or has the wrong '
                             f'shape {tuple(out.shape)} {out.dtype}')
    # the workspaces' round trips split twice a stage (the L of the clipped
    # frame, then the frame's LAB) and merge once
    want = full_launches(1, lab_split=4, lab_merge=2)
    if launches != want:
        raise AssertionError(f'piecewise launched {launches}, expected {want}')
    graphed_captures = {n: k for n, (_, k) in workspace_captures(proc).items() if k}

    frames = synthetic_frames(W, H, 3, seed=710).to(dev)
    eager = ungraphed(mk((W, H), s, dev))
    turns = in_turns([('eager 1', lambda x: run(eager, x)), ('graphed 1', lambda x: run(proc, x)),
                      ('graphed 2', lambda x: run(proc, x)), ('eager 2', lambda x: run(eager, x))],
                     frames)
    for label, (outs, _) in turns.items():
        for k, (a, b) in enumerate(zip(outs, turns['eager 1'][0])):
            if not torch.equal(a, b):
                raise AssertionError(f'piecewise {label} frame {k + 1} differs from the eager copy')
    if {n: k for n, (_, k) in workspace_captures(proc).items() if k} != graphed_captures:
        raise AssertionError('a steady piecewise frame captured anew')
    report = dict(first_frame_ms=ms, pool_reserved_gib=pool_gib,
                  steady_ms={k: 1e3 * sum(t) / len(t) for k, (_, t) in turns.items()})
    log(f'piecewise {W}x{H} steady frames in turns, bit for bit with the eager copy; ms a frame: '
        + ', '.join(f'{k} {v:.2f}' for k, v in report['steady_ms'].items()))
    del turns
    profiled = {'piecewise_graphed_frame': lambda: run(proc, frames[0]),
                'piecewise_eager_frame': lambda: run(eager, frames[0])}

    w, h = 1024, 768
    data = synthetic_frames(w, h, 1, seed=5)[0]
    variants = {
        'ppg': dataclasses.replace(s, debayer=tt.Debayer.ppg, ppg_median_threshold=2.0),
        'bilinear': dataclasses.replace(s, debayer=tt.Debayer.bilinear),
        'linear tonemap': dataclasses.replace(s, tone_mapping=tt.ToneMapper.linear),
        'filmic tonemap': dataclasses.replace(s, tone_mapping=tt.ToneMapper.filmic),
    }
    for label, settings in variants.items():
        a = piecewise(mk((w, h), settings, dev), data).cpu().numpy().astype(int)
        b = piecewise(mk((w, h), settings, torch.device('cpu')), data).numpy().astype(int)
        d = int(np.abs(a - b).max())
        log(f'piecewise {label} card vs cpu at {w}x{h}: max |diff| {d} count(s), '
            f'{(a != b).mean():.2e} of values differ')
        if d > 1 or a.std() < 1.0:
            raise AssertionError(f'piecewise {label}: card and CPU differ by {d} counts, or flat')
    return report, profiled


# ---------------------------------------------------------------- phase 10

def sync_points(fn):
    """Run fn() with CUDA sync debugging on: for every call in it that made
    the host wait for the card, the line that made it and the innermost line
    of the port that led there."""
    import traceback
    import warnings

    found = []

    def show(message, category, filename, lineno, file=None, line=None):
        if 'called a synchronizing CUDA operation' not in str(message):
            return   # e.g. torch's notice that this debug mode is a prototype
        port = [f for f in traceback.extract_stack()[:-1] if 'tpu_darktable_torch' in f.filename]
        where = f' (from {Path(port[-1].filename).name}:{port[-1].lineno})' if port else ''
        found.append(f'{Path(filename).name}:{lineno}{where}')

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter('always')
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    return found


def config5_scene(w, h, seed=0):
    """BASELINE config 5's scene (benchmarks/baseline_configs.py:186-198):
    three sinusoids plus noise of sigma 0.01, (h, w, 3) float32."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    scene = np.stack([0.35 + 0.45 * np.sin(xx / 331) * np.cos(yy / 237),
                      0.40 + 0.40 * np.cos(xx / 181 + yy / 419),
                      0.45 + 0.35 * np.sin((xx + 2 * yy) / 293)], axis=-1)
    return np.clip(scene + rng.normal(0, 0.01, scene.shape), 0.0, 1.0).astype(np.float32)


def config5_frame(seed=0):
    """Packed12 bytes of config 5's scene, mosaicked and packed by the port."""
    import tpu_darktable_torch as tt

    mosaic = tt.rgb_to_bayer(torch.from_numpy(config5_scene(W, H, seed)))[..., 0]
    return tt.encode(mosaic.reshape(-1), tt.PackedFormat.Packed12).numpy()


def wall_ms(fn, n):
    """Median host ms of fn() over n calls, each starting on an idle card and
    ending in whatever fn waits for."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def device_busy(fn):
    """fn() once under torch.profiler, after a warm-up call: its wall ms (to
    a synchronize), the ms the card spent in kernels and copies, the share
    of the wall time the card was idle, the number of device ops, and the
    eight ops with the most device time (name, ms, count)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    ms = lambda e: (getattr(e, 'self_device_time_total', None)
                    or getattr(e, 'self_cuda_time_total', 0)) / 1e3
    busy = sum(ms(e) for e in evs)
    top = sorted(evs, key=ms, reverse=True)[:8]
    return dict(wall_ms=wall, device_ms=busy, idle_share=max(0.0, 1.0 - busy / wall),
                device_ops=sum(e.count for e in evs),
                top_device_ms=[(e.key[:70], ms(e), e.count) for e in top])


def plain_stages():
    """The JPEG encoder's two programs run eagerly (the copy that the graphed
    stages are held to)."""
    from tpu_darktable_torch.ops import jpeg as jp

    stages = jp._Stages()
    stages.dct, stages.scan = jp._jpeg_device_stage, jp._scan
    return stages


def jpeg_graphs(frame, frame_cpu, blocks, ri, ref):
    """A new Jpeg's graphed DCT stage and entropy scan on one 12 MP frame:
    its first encode (eager, then both captures) and the replays give the
    CPU encode's bytes (`ref`, 4:2:2 q90), encode_async and the progressive
    encode replay too, quality 75 replays the DCT capture with its own
    bytes; no replayed encode_jpeg_async makes the host wait; capture
    seconds and the GiB its pool keeps reserved; then each stage and the
    whole encode timed against the eager copy in turns (eager, graphed,
    graphed, eager)."""
    import tpu_darktable_torch as tt
    from tpu_darktable_torch.ops import jpeg as jp
    from tpu_darktable_torch.ops import jpeg_entropy

    plain = plain_stages()
    base = reserved_gib()
    jpg = tt.Jpeg()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = jpg.encode(frame, 90)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    pool_gib = reserved_gib() - base
    dct, scan = jpg._stages.dct, jpg._stages.scan
    ref75 = jp._encode(plain, frame_cpu, 75, 3, 1, False, None, 'host', None)
    got = {'first encode': first, 'replayed encode': jpg.encode(frame, 90),
           'replayed encode_async': jpg.encode_async(frame, 90).result(),
           'eager copy': jp._encode(plain, frame, 90, 3, 1, False, None, 'device', None)}
    for label, data in got.items():
        if not np.array_equal(data, ref):
            raise AssertionError(f'jpeg graphs: the {label} bytes differ from the CPU encode')
    if not np.array_equal(jpg.encode(frame, 75), ref75):
        raise AssertionError('jpeg graphs: quality 75 replayed differs from the CPU encode')
    prog = jpg.encode(frame, 90, progressive=True)
    if not np.array_equal(prog, jp._encode(plain, frame_cpu, 90, 3, 1, True, None, 'auto', None)):
        raise AssertionError('jpeg graphs: the replayed progressive encode differs from the CPU')
    captures = [len(dct._captured), len(scan._captured)]
    if captures != [1, 1]:
        raise AssertionError(f'jpeg graphs: {captures} captures, not one a stage')
    waits = sync_points(lambda: jpg.encode_async(frame, 90))
    if waits:
        raise AssertionError(f'a replayed encode_async makes the host wait at {waits}')
    ms = {}
    turns = (('eager 1', plain), ('graphed 1', jpg._stages), ('graphed 2', jpg._stages),
             ('eager 2', plain))
    for turn, st in turns:
        ms[turn] = dict(
            dct_stage_ms=cuda_ms(lambda: jp._prepare_device_stage(frame, 90, 3, 1, None,
                                                                  st.dct), iters=10, warmup=2),
            entropy_dispatch_ms=cuda_ms(lambda: jpeg_entropy._dispatch(st.scan, blocks, 1, ri),
                                        iters=5, warmup=1),
            entropy_wall_ms=wall_ms(lambda: jpeg_entropy.entropy_encode_device_finalize(
                jpeg_entropy._dispatch(st.scan, blocks, 1, ri)), 5),
            encode_wall_ms=wall_ms(lambda: jp._encode(st, frame, 90, 3, 1, False, None,
                                                      'device', None), 5))
    report = dict(first_encode_ms=first_ms, pool_reserved_gib=pool_gib,
                  captures=captures, host_waits_replayed_encode_async=waits, turns=ms)
    log(f'jpeg graphs (a new Jpeg, 12 MP 4:2:2 q90): first encode {first_ms:.1f} ms with '
        f'the captures; its pool keeps {pool_gib:.2f} GiB reserved; replays of '
        'encode, encode_async, progressive and q75 equal the CPU bytes; no host wait; in turns: '
        + '; '.join(f'{k} ' + ', '.join(f'{n} {v:.2f}' for n, v in d.items())
                    for k, d in ms.items()))
    del jpg
    return report


def jpeg_entropy_case(frame):
    """The scan kernel (csrc/jpeg_entropy.cu) at the stream cell's frame
    shape: the 4096x3000 frame turned to 3000x4096, as rotate_270 leaves it,
    4:2:2 q90 at the auto restart interval (a row of 188 MCUs).  Its words
    and small readback must equal the plain version's on the card, with 3
    launches a call; both timed by CUDA events in turns (plain, kernel,
    kernel, plain) beside the bound: 2 bytes a coefficient in, the words
    and readback out; ~40 integer operations a coefficient."""
    from tpu_darktable_torch import kernels
    from tpu_darktable_torch.kernels.jpeg_entropy import jpeg_entropy, jpeg_entropy_plain
    from tpu_darktable_torch.ops import jpeg as jp

    turned = frame.transpose(0, 1).contiguous()
    blocks = jp._prepare_device_stage(turned, 90, 3, 1)[4]
    ri = jp._resolve_restart_interval(None, turned.shape[1], 1, 3, blocks) or blocks[1].shape[0]
    cap_words = -(-max(4096, ri * 4 * 40) // 4)
    kernels.reset_launches()
    words, small = jpeg_entropy(blocks, 1, ri, cap_words)
    launches = kernels.launches['jpeg_entropy']
    plain_words, plain_small = jpeg_entropy_plain(blocks, 1, ri, cap_words)
    if launches != 3 or bool(small[-1]) or not torch.equal(small, plain_small) \
            or not torch.equal(words, plain_words):
        raise AssertionError(f'jpeg_entropy at {tuple(turned.shape)}: {launches} launches, '
                             f'overflow {bool(small[-1])}, or it differs from its plain version')
    ms = {}
    for turn, fn, iters in (('plain 1', jpeg_entropy_plain, 3), ('kernel 1', jpeg_entropy, 50),
                            ('kernel 2', jpeg_entropy, 50), ('plain 2', jpeg_entropy_plain, 3)):
        ms[turn] = cuda_ms(lambda: fn(blocks, 1, ri, cap_words), iters=iters, warmup=1)
    n_coef = sum(b.numel() for b in blocks)
    n_bytes = 2 * n_coef + 4 * int(small[-2]) + 8 * small.numel()
    bound_ms, bound_by = bound(n_bytes, 40 * n_coef)
    report = dict(
        name='jpeg_entropy', route='CUDA', source='csrc/jpeg_entropy.cu', replaces='none',
        shape=list(turned.shape), restart_interval=ri, blocks=n_coef // 64,
        stream_words=int(small[-2]), launches_a_call=launches,
        ms=min(ms['kernel 1'], ms['kernel 2']), plain_ms=min(ms['plain 1'], ms['plain 2']),
        turns=ms, bound_ms=bound_ms, bound_by=bound_by,
        bytes_ms=n_bytes / HBM_BYTES_PER_S * 1e3, operations_ms=40 * n_coef / FP32_OPS_PER_S * 1e3)
    log(f'jpeg_entropy {tuple(turned.shape)} 4:2:2 q90, restart {ri}: equal to its plain version '
        f'({report["stream_words"]} words), {launches} launches a call; in turns ' +
        ', '.join(f'{k} {v:.4f} ms' for k, v in ms.items()) +
        f'; bound {bound_ms:.4f} ms ({bound_by})')
    return report


def phase_jpeg(dev, smi):
    """The JPEG encoder on one FULL frame, card against CPU and timed, then
    BASELINE config 5 through the streaming executor in both JPEG modes."""
    import tpu_darktable_torch as tt
    from tpu_darktable_torch import kernels, native
    from tpu_darktable_torch.ops import jpeg as jp
    from tpu_darktable_torch.ops import jpeg_entropy
    from tpu_darktable_torch.pipeline.streaming import StreamingExecutor

    if native.get_lib() is None:
        raise AssertionError('the native host scan (native/bitpack.cpp) did not build')
    proc = tt.ImageProcessor((W, H), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                             full_settings(), device=dev, white_balance=WB)
    data = config5_frame()
    batch = torch.from_numpy(np.stack([data, data])).to(dev)
    frame = proc.process_batch(batch)[1]
    frame_cpu = frame.cpu()
    report = {'card': smi}

    # (a) the card against the CPU
    for ss, label in ((0, '4:4:4'), (2, 'gray'), (1, '4:2:2')):
        blocks = jp._prepare_device_stage(frame, 90, 3, ss)[4]
        cpu = jp._prepare_device_stage(frame_cpu, 90, 3, ss)[4]
        n_diff = sum(int((a.cpu() != b).sum()) for a, b in zip(blocks, cpu))
        log(f'jpeg DCT stage {label} card vs cpu: {n_diff} of '
            f'{sum(b.numel() for b in cpu)} coefficients differ')
        if n_diff:
            raise AssertionError(f'DCT stage {label}: card and CPU differ in {n_diff} coefficients')
    # blocks and cpu are 4:2:2 from here; the CPU's encodes finish from its own stage
    ri = jp._resolve_restart_interval(None, W, 1, 3, blocks)
    if jpeg_entropy.entropy_encode_device(blocks, 1, ri) is None:
        raise AssertionError('the device entropy overflowed its default capacity on a FULL frame')
    qy, qc = jp.quality_to_tables(90)
    ref = jp._host_entropy_bitstream(cpu, H, W, qy, qc, 1, 3, ri)
    encodes = {'device entropy': jp.encode_jpeg(frame, 90, entropy='device'),
               'host native scan': jp.encode_jpeg(frame, 90, entropy='host'),
               'encode_jpeg_async': jp.encode_jpeg_async(frame, 90).result()}
    for label, got in encodes.items():
        if not np.array_equal(got, ref):
            raise AssertionError(f'{label} bytes differ from the CPU host-entropy encode')
    prog = jp.encode_jpeg(frame, 90, progressive=True)
    if not np.array_equal(prog, jp._encode_progressive([b.numpy() for b in cpu], H, W, qy, qc, 1)):
        raise AssertionError('progressive bytes differ between the card and the CPU')
    log(f'jpeg 4:2:2 q90 restart {ri}: device entropy, host native scan, async and the CPU '
        f'encode give the same {len(ref)} bytes; progressive card == cpu ({len(prog)} bytes); '
        'no overflow at the default capacity')

    # (b) times of one frame
    host_blocks = [b.cpu().numpy() for b in blocks]
    tables = tuple((jp._HUFF[('dc', t)][0], jp._HUFF[('dc', t)][1], jp._HUFF[('ac', t)][0],
                    jp._HUFF[('ac', t)][1]) for t in (0, 1))
    # the working set of one device-entropy encode run eagerly, and of a replay
    peak = peak_gib(lambda: jp._encode(plain_stages(), frame, 90, 3, 1, False, None, 'device',
                                       None))
    report['peak_gib_replayed_encode'] = peak_gib(lambda: jp.encode_jpeg(frame, 90,
                                                                         entropy='device'))
    report.update(
        dct_stage_ms=cuda_ms(lambda: jp._prepare_device_stage(frame, 90, 3, 1), iters=10, warmup=2),
        device_entropy_ms=wall_ms(
            lambda: jpeg_entropy.entropy_encode_device(blocks, 1, ri), 5),
        host_native_scan_ms=wall_ms(
            lambda: native.jpeg_encode_baseline_native(host_blocks, 1, tables, ri), 5),
        encode_device_ms=wall_ms(lambda: jp.encode_jpeg(frame, 90, entropy='device'), 5),
        encode_host_ms=wall_ms(lambda: jp.encode_jpeg(frame, 90, entropy='host'), 5),
        progressive_ms=wall_ms(lambda: jp.encode_jpeg(frame, 90, progressive=True), 2),
        bytes_per_frame=len(ref), peak_gib_device_entropy_encode=peak,
        sync_points_process_batch=sync_points(lambda: proc.process_batch(batch)),
        sync_points_process_batch_from_host=sync_points(
            lambda: proc.process_batch(np.stack([data, data]))),
        sync_points_encode_jpeg_async=sync_points(lambda: jp.encode_jpeg_async(frame, 90)))
    log('jpeg one frame: ' + ', '.join(f'{k} {v}' for k, v in report.items() if k != 'card'))
    for name in ('sync_points_process_batch', 'sync_points_process_batch_from_host',
                 'sync_points_encode_jpeg_async'):
        if report[name]:
            raise AssertionError(f'{name}: the host waits for the card at {report[name]}, so '
                                 'batch N+1 cannot be enqueued while batch N runs')
    report['graphed_stages'] = jpeg_graphs(frame, frame_cpu, blocks, ri, ref)
    report['entropy_kernel'] = jpeg_entropy_case(frame)

    # (c) BASELINE config 5: FULL at 4096x3000, batch 2, quality 90, streamed
    n_frames, warm = 32, 2
    full_ms = wall_ms(lambda: (proc.process_batch(batch), torch.cuda.synchronize()), 5) / 2
    runs, executors = {}, {}
    for device_jpeg in (True, False):
        proc.bounds = proc.metrics = None   # each run starts from the same EMA state
        base = reserved_gib()
        ex = StreamingExecutor(proc, batch_size=2, jpeg_quality=90, jpeg_workers=2,
                               keep_images=False, device_jpeg=device_jpeg)
        kernels.reset_launches()
        ex.run([(f'warm{i}', data) for i in range(warm)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = ex.run([(f'f{i}', data) for i in range(n_frames)])
        seconds = (time.perf_counter() - t0) / n_frames
        launches = dict(kernels.launches)
        bad = [r.name for r in results
               if r.error is not None or not (r.jpeg or b'').startswith(b'\xff\xd8')]
        if bad or len(results) != n_frames:
            raise AssertionError(f'config 5 streaming failures: {bad} '
                                 f'{[r.error for r in results if r.error]}')
        scans = 3 * (warm + n_frames) if device_jpeg else 0   # the scan kernel's 3 a frame
        if launches != full_launches(warm + n_frames, jpeg_entropy=scans):
            raise AssertionError(f'config 5 launched {launches}')
        mode = 'device_jpeg' if device_jpeg else 'host_jpeg_2_workers'
        executors[mode] = ex
        runs[mode] = {r.name: r.jpeg for r in results}
        # the encoder's graphs: captured once (the first frame), replayed after
        stages = ex._jpeg._stages
        captures = [len(stages.dct._captured), len(stages.scan._captured)]
        if captures != [1, 1 if device_jpeg else 0]:
            raise AssertionError(f'config 5 ({mode}): the JPEG stages hold {captures} captures, '
                                 'not one a stage that ran')
        report[mode] = dict(s_per_frame=seconds, frames_per_s=1.0 / seconds,
                            mb_per_frame=float(np.mean([len(r.jpeg) for r in results])) / 1e6,
                            jpeg_captures=captures,
                            reserved_gib_over_the_processor=reserved_gib() - base)
        log(f'config 5 ({mode}): {n_frames} frames, {seconds:.4f} s/frame, '
            f'{1 / seconds:.2f} frames/s, {report[mode]["mb_per_frame"]:.3f} MB/frame; '
            f'launches {launches}; JPEG captures (DCT, scan) {captures}; the encoder\'s graphs add '
            f'{report[mode]["reserved_gib_over_the_processor"]:.2f} GiB to the reserved memory '
            '(one pool with the processor\'s)')
    if runs['device_jpeg'] != runs['host_jpeg_2_workers']:
        raise AssertionError('config 5: the device-JPEG and host-JPEG runs differ in their bytes')
    report['full_process_batch_ms_per_frame'] = full_ms
    log(f'config 5: both modes give the same bytes frame for frame; FULL process_batch alone '
        f'(batch 2) {full_ms:.2f} ms/frame in this call')

    # (d) the card's busy time under torch.profiler, last: where a profiler
    # session ran before them, FULL and config 5 timed 40-65% slower
    plain = plain_stages()
    profiled = {'dct_stage': lambda: jp._prepare_device_stage(frame, 90, 3, 1),
                'dct_stage_eager': lambda: jp._prepare_device_stage(frame, 90, 3, 1, None,
                                                                    plain.dct),
                'device_entropy': lambda: jpeg_entropy.entropy_encode_device(blocks, 1, ri),
                'device_entropy_eager': lambda: jpeg_entropy.entropy_encode_device_finalize(
                    jpeg_entropy._dispatch(plain.scan, blocks, 1, ri)),
                'full_process_batch_2': lambda: proc.process_batch(batch)}
    for mode, ex in executors.items():
        profiled[f'config5_{mode}_2_frames'] = \
            lambda ex=ex: ex.run([(f'p{i}', data) for i in range(2)])
    for label, fn in profiled.items():
        report[f'profile_{label}'] = device_busy(fn)
        log(f'profile of {label}: {report[f"profile_{label}"]}')
    return report


# ---------------------------------------------------------------- phase 11

def config4_inputs(dev):
    """BASELINE config 4's plane, tonemap parameters and metrics."""
    from tpu_darktable_torch.ops import tonemap

    lum = (np.random.default_rng(0).random((H, W)) * 0.8).astype(np.float32)
    params = tonemap.TonemapParameters(gamma=1.5, intensity=2.0, vibrance=0.5)
    metrics = torch.tensor([-1.5, 0.3, 0.3, 0.35, 0.25], dtype=torch.float32, device=dev)
    return torch.from_numpy(lum), params, metrics


def config4_frame(lum, params, metrics):
    """One frame of config 4: the local Laplacian, then three tonemaps of
    the stacked RGB."""
    from tpu_darktable_torch.ops import laplacian, tonemap

    y = laplacian.local_laplacian(lum, laplacian.LaplacianParams())
    rgb = torch.stack([y, y, y], dim=-1)
    return (tonemap.reinhard_tonemap(rgb, metrics, params), tonemap.filmic_tonemap(rgb, params),
            tonemap.aces_tonemap(rgb, params))


def peak_gib(fn):
    """Peak device memory of fn() above what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def phase_laplacian(dev):
    """BASELINE config 4, local_laplacian card vs CPU at full width, and
    FULL with the Laplacian.  Returns the report and the runs to profile
    after phase 10."""
    import tpu_darktable_torch as tt
    from tpu_darktable_torch import kernels
    from tpu_darktable_torch.ops import laplacian

    report = {}
    lum_cpu, params, metrics = config4_inputs(dev)
    lum = lum_cpu.to(dev)

    # (a) config 4
    outs = config4_frame(lum, params, metrics)
    for u in outs:
        if tuple(u.shape) != (H, W, 3) or u.dtype != torch.uint8 or u.float().std().item() < 1.0:
            raise AssertionError(f'config 4 tonemap output {tuple(u.shape)} {u.dtype} wrong or flat')
    neutral = laplacian.LaplacianParams()
    report.update(
        config4_ms_per_frame=cuda_ms(lambda: config4_frame(lum, params, metrics), 5, 2),
        config4_laplacian_ms=cuda_ms(lambda: laplacian.local_laplacian(lum, neutral), 5, 2),
        config4_peak_gib=peak_gib(lambda: config4_frame(lum, params, metrics)))
    log(f'config 4 {W}x{H}: {report["config4_ms_per_frame"]:.3f} ms/frame '
        f'({1e3 / report["config4_ms_per_frame"]:.2f} frames/s), the Laplacian alone '
        f'{report["config4_laplacian_ms"]:.3f} ms, peak {report["config4_peak_gib"]:.3f} GiB')

    def lc_tonemap(x):
        u1, u2, u3 = config4_frame(x, params, metrics)
        return x + 1e-12 * (u1[..., 0] + u2[..., 0] + u3[..., 0]).to(torch.float32)

    # as benchmarks/baseline_configs.py chains it: 2 passes
    report['config4_chain'] = chained_case(f'config 4 {W}x{H}', lc_tonemap, lum, 2, per_pass={})

    # (b) local_laplacian, card against CPU, at full width
    strong = laplacian.LaplacianParams(shadows=0.6, highlights=1.4, clarity=0.3)
    for label, p in (('neutral', neutral), ('strong', strong)):
        pad = laplacian.auto_max_supp(W, H, p)
        card = laplacian.local_laplacian(lum, p).cpu()
        d = (card - laplacian.local_laplacian(lum_cpu, p)).abs()
        max_d, share = d.max().item(), (d > 0).float().mean().item()
        report[f'card_vs_cpu_{label}'] = dict(pad=pad, max_abs=max_d, share_differing=share)
        log(f'local_laplacian {label} (pad {pad}) card vs cpu at {W}x{H}: max |diff| {max_d:.3e}, '
            f'{share:.3e} of elements differ')
        if (label == 'neutral' and max_d != 0.0) or max_d > 1e-3 or share >= 5e-3:
            raise AssertionError(f'local_laplacian {label}: card and CPU differ by {max_d} in '
                                 f'{share} of the elements')
    report['strong_laplacian_ms'] = cuda_ms(lambda: laplacian.local_laplacian(lum, strong), 3, 1)
    report['strong_laplacian_peak_gib'] = peak_gib(lambda: laplacian.local_laplacian(lum, strong))
    log(f'local_laplacian strong (pad {report["card_vs_cpu_strong"]["pad"]}) {W}x{H}: '
        f'{report["strong_laplacian_ms"]:.3f} ms, peak {report["strong_laplacian_peak_gib"]:.3f} GiB')

    # (c) FULL with the Laplacian (lap_clarity 0.3: the full pad)
    settings = dataclasses.replace(full_settings(), enable_laplacian=True, lap_clarity=0.3)
    proc = tt.ImageProcessor((W, H), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                             settings, device=dev, white_balance=WB)
    batches = [synthetic_frames(W, H, BATCH, seed=1100 + b).to(dev) for b in range(N_BATCHES)]
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
    full_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f'FULL+laplacian launches: {launches}')
    if launches != full_launches(BATCH * N_BATCHES, stages=3):
        raise AssertionError(f'FULL+laplacian launched {launches}')
    if tuple(out.shape) != (BATCH, H, W, 3) or out.float().std().item() < 1.0:
        raise AssertionError(f'FULL+laplacian output {tuple(out.shape)} is wrong or flat')
    if not (torch.isfinite(proc.bounds).all() and torch.isfinite(proc.metrics).all()):
        raise AssertionError('FULL+laplacian: non-finite EMA state')
    steady = sum(times[1:]) / (len(times) - 1)
    waits = sync_points(lambda: proc.process_batch(batches[0]))
    report.update(full_laplacian_ms_per_frame=steady / BATCH * 1e3, full_laplacian_peak_gib=full_peak,
                  full_laplacian_sync_points=waits)
    log(f'FULL+laplacian {W}x{H} batch {BATCH}: batch seconds {[round(t, 4) for t in times]}; '
        f'{steady / BATCH * 1e3:.2f} ms/frame, {BATCH / steady:.2f} frames/s (batches 2..{N_BATCHES}); '
        f'peak device memory {full_peak:.2f} GiB; host waits in process_batch: {waits}')
    if waits:
        raise AssertionError(f'FULL+laplacian: process_batch makes the host wait at {waits}')

    phase_card_vs_cpu(dev, settings, label='FULL+laplacian')
    w, h = 1024, 768
    data = synthetic_frames(w, h, 1, seed=5)[0]
    mk = lambda d: tt.ImageProcessor((w, h), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                                     settings, device=d, white_balance=WB)
    a = piecewise(mk(dev), data).cpu().numpy().astype(int)
    b = piecewise(mk(torch.device('cpu')), data).numpy().astype(int)
    d = int(np.abs(a - b).max())
    log(f'piecewise FULL+laplacian card vs cpu at {w}x{h}: max |diff| {d} count(s), '
        f'{(a != b).mean():.2e} of values differ')
    if d > 1 or a.std() < 1.0:
        raise AssertionError(f'piecewise FULL+laplacian: card and CPU differ by {d} counts, or flat')

    profiled = {'config4_frame': lambda: config4_frame(lum, params, metrics),
                'config4_laplacian': lambda: laplacian.local_laplacian(lum, neutral),
                'full_laplacian_process_batch_4': lambda: proc.process_batch(batches[0])}
    return report, profiled


def profile_runs(report, profiled):
    """The device ops and idle share of phase 9's and phase 11's runs,
    after phase 10's profiling."""
    for label, fn in profiled.items():
        report[f'profile_{label}'] = device_busy(fn)
        log(f'profile of {label}: {report[f"profile_{label}"]}')
    return report


# ---------------------------------------------------------------- phase 12

# The image tools' calls: (label, module name, arguments, output key, and
# the card-vs-CPU tolerance in max abs).  The Laplacian tool's RGB goes
# through LAB and back around the float16 pyramids: pow and cbrt round
# differently on the card, and the float16 rounding turns a few of those
# last bits into float16 steps of L (phase 11 holds the Laplacian itself bit
# for bit on one luminance plane), so it is held to one uint8 count of its
# [0, 1] output, the pipeline phases' bar.
CLI_CALLS = (
    ('test_debayer rcd', 'test_debayer', ['--algorithm', 'rcd'], 'rcd demosaic', 1e-5),
    ('test_bilateral sigma_s 2', 'test_bilateral', ['--sigma-s', '2'], 'bilateral', 1e-5),
    ('test_bilateral sigma_s 3', 'test_bilateral', ['--sigma-s', '3'], 'bilateral', 1e-5),
    ('test_wiener rgb', 'test_wiener', ['--mode', 'rgb'], 'denoised', 2e-5),
    ('test_wiener log_luminance', 'test_wiener', ['--mode', 'log_luminance'], 'denoised', 2e-5),
    ('test_laplacian', 'test_laplacian', ['--clarity', '0.3'], 'laplacian', 1 / 255),
)
# at least one launch of each of these across the phase
CLI_KERNELS = ('rcd_interior', 'color_smooth_diffs', 'bilateral_band', 'grid_blur_xyz',
               'wiener_tile_core')


def phase_cli(dev):
    """The command-line tools of tpu_darktable_torch/scripts/ on the card:
    run_benchmark at its default size, then the image tools' pure functions
    on a synthetic full-width frame, then those card against CPU."""
    import importlib

    from tpu_darktable_torch import kernels
    from tpu_darktable_torch.ops.bayer import BayerPattern
    from tpu_darktable_torch.scripts import run_benchmark

    report, seen = {}, dict.fromkeys(CLI_KERNELS, 0)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rates = run_benchmark.run_benchmark(None, BayerPattern.RGGB, warmup_iters=1, bench_iters=3,
                                        size=(W, H), device=dev)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.launches.items() if v}
    report['run_benchmark'] = dict(iters_per_s=rates, launches=launches,
                                   seconds=time.perf_counter() - t0)
    log(f'run_benchmark {W}x{H} (warm-up 1, 3 iterations): launches {launches}')
    for k in seen:
        seen[k] += launches.get(k, 0)

    def call(module, argv, rgb, d):
        mod = importlib.import_module(f'tpu_darktable_torch.scripts.{module}')
        args = mod.parser().parse_args(['synthetic.png', *argv, '--device', str(d)])
        return mod.run(rgb, args, d)

    rgb = torch.from_numpy(config5_scene(W, H, seed=1200)).to(dev)
    for label, module, argv, key, _ in CLI_CALLS:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = call(module, argv, rgb, dev)[key]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v for k, v in kernels.launches.items() if v}
        for k in seen:
            seen[k] += launches.get(k, 0)
        finite = bool(torch.isfinite(out).all())
        report[label] = dict(ms_first_call=ms, launches=launches)
        log(f'{label} {W}x{H}: {ms:.2f} ms (first call), launches {launches}, finite {finite}')
        if tuple(out.shape) != (H, W, 3) or out.device.type != dev.type or not finite:
            raise AssertionError(f'{label}: output {tuple(out.shape)} on {out.device}, '
                                 f'finite {finite}')
    del rgb, out
    log(f'command-line tools launches, all calls: {seen}')
    missing = [k for k, v in seen.items() if v < 1]
    if missing:
        raise AssertionError(f'the command-line tools launched no {missing}')
    report['launches'] = seen

    w, h = 1024, 768
    small = torch.from_numpy(config5_scene(w, h, seed=1201))
    for label, module, argv, key, tol in CLI_CALLS:
        card = call(module, argv, small.to(dev), dev)[key].cpu()
        d = (card - call(module, argv, small, torch.device('cpu'))[key]).abs()
        max_d, share = d.max().item(), (d > 1e-6).float().mean().item()
        report[f'{label} card vs cpu'] = dict(max_abs=max_d, share_above_1e_6=share)
        log(f'{label} card vs cpu at {w}x{h}: max |diff| {max_d:.3e} (tolerance {tol:g}), '
            f'{share:.3e} of values differ by more than 1e-6')
        if not max_d <= tol:
            raise AssertionError(f'{label}: card and CPU differ by {max_d} ({share} of values)')
    return report


# ---------------------------------------------------------------- phase 13

def sharded_case(label, fn, ref_fn, frames, blocks, report):
    """Run a sharded program and then its unsharded reference, each from its
    first call (eager, then its graphs' captures); check the launches (one
    of each of FULL's kernels a band block of a frame), 1 uint8 count and
    the EMA state against the test bars (bounds atol 1e-6; metrics rtol
    1e-5, atol 1e-6), that a second call of each (its graphs replayed)
    equals its first bit for bit, and that no replay makes the host wait
    for the card; time both replayed by CUDA events."""
    from tpu_darktable_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    out, bounds, metrics = fn()
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.launches.items() if v}
    ref, ref_bounds, ref_metrics = ref_fn()
    # the second calls replay every graph: bit for bit with the first
    for label_, f, first in (('sharded', fn, (out, bounds, metrics)),
                             ('unsharded', ref_fn, (ref, ref_bounds, ref_metrics))):
        if not all(torch.equal(a, b) for a, b in zip(f(), first)):
            raise AssertionError(f'{label}: the {label_} program\'s replay differs from its '
                                 'first call')
    d = int((out.to(torch.int16) - ref.to(torch.int16)).abs().max().item())
    db = (bounds - ref_bounds).abs().max().item()
    dm = (metrics - ref_metrics).abs().max().item()
    metrics_ok = bool(((metrics - ref_metrics).abs() <= 1e-6 + 1e-5 * ref_metrics.abs()).all())
    waits = sync_points(fn)
    ms = cuda_ms(fn, iters=3, warmup=1)
    ref_ms = cuda_ms(ref_fn, iters=3, warmup=1)
    report[label] = dict(max_count_diff=d, share_differing=(out != ref).float().mean().item(),
                         bounds_max_abs=db, metrics_max_abs=dm, launches=launches,
                         host_waits=waits, ms_per_frame=ms / frames,
                         unsharded_ms_per_frame=ref_ms / frames,
                         bit_equal=d == 0 and db == 0 and dm == 0)
    log(f'{label}: max |diff| {d} count(s) ({report[label]["share_differing"]:.2e} of values), '
        f'bounds {db:.3e}, metrics {dm:.3e} from the unsharded program; launches {launches}; '
        f'host waits {waits}; {ms / frames:.2f} ms/frame against {ref_ms / frames:.2f} unsharded')
    if d > 1 or db > 1e-6 or not metrics_ok:
        raise AssertionError(f'{label}: {d} counts, bounds {db}, metrics {dm} from the unsharded '
                             'program')
    if waits:
        raise AssertionError(f'{label} made the host wait for the card: {waits}')
    if any(launches.get(k, 0) != frames * blocks for k in FULL_KERNELS):
        raise AssertionError(f'{label} launched {launches}, not {frames * blocks} of each of '
                             f'{FULL_KERNELS}')


# the band programs' per-device steps between the collectives that ran
# eagerly before they were graphs of their own (parallel/spatial_pipeline.py)
BAND_GLUE = ('green_eq', 'lab', 'laplacian', 'lab_modify')


def band_breakdown(program, call, n=3):
    """ms of the card's timeline a frame (by CUDA events, over n calls after
    one) spent from the start to the end of each call of the band
    program's steps, summed a step, and in what lies between them (the
    gathers, sums and replicas across devices, the EMA, and the card's idle
    time while the host enqueues)."""
    graphs = dict(program.graphs)
    events = {}

    def timed(name, step):
        def run(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(*args)
            end.record()
            events.setdefault(name, []).append((start, end))
            return out
        return run

    program.graphs.update({name: timed(name, g) for name, g in graphs.items()})
    try:
        call()
        events.clear()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            call()
        end.record()
        torch.cuda.synchronize()
    finally:
        program.graphs.update(graphs)
    total = start.elapsed_time(end) / n
    steps = {name: sum(a.elapsed_time(b) for a, b in ev) / n for name, ev in events.items()}
    steps['between the steps'] = total - sum(steps.values())
    return dict(total_ms=total, steps_ms=steps)


def band_glue_case(label, build, call, frames, report):
    """A band program (its glue graphed) against a copy whose glue runs
    eagerly between its graphed stage groups: bit for bit, then ms a frame
    in turns (eager glue, graphed, graphed, eager glue) by CUDA events, the
    breakdown of a frame of each, and the card's busy time and idle share."""
    graphed, eager = build(), build()
    for name in BAND_GLUE:
        eager.graphs[name] = eager.graphs[name].fn
    first = call(graphed)           # eager, then the captures
    if not all(torch.equal(a, b) for a, b in zip(call(graphed), call(eager))) or \
            not all(torch.equal(a, b) for a, b in zip(first, call(eager))):
        raise AssertionError(f'{label}: the graphed glue differs from the eager glue')
    ms = {}
    for turn, prog in (('eager glue 1', eager), ('graphed 1', graphed), ('graphed 2', graphed),
                       ('eager glue 2', eager)):
        ms[turn] = cuda_ms(lambda: call(prog), iters=3, warmup=1) / frames
    out = dict(ms_per_frame=ms,
               breakdown={'graphed': band_breakdown(graphed, lambda: call(graphed)),
                          'eager glue': band_breakdown(eager, lambda: call(eager))},
               profile={'graphed': device_busy(lambda: call(graphed)),
                        'eager glue': device_busy(lambda: call(eager))},
               captures={n: len(g._captured) for n, g in graphed.graphs.items()})
    report[f'{label}: glue'] = out
    log(f'{label}: the graphed glue equals the eager glue bit for bit; ms/frame in turns '
        + ', '.join(f'{k} {v:.2f}' for k, v in ms.items())
        + f'; breakdown {out["breakdown"]}; profile {out["profile"]}; captures {out["captures"]}')


def phase_sharded(dev):
    """parallel/ on the card, over meshes of the one card repeated: the
    12-camera rig batch-sharded 4 ways through ImageProcessor(mesh=...), one
    FULL frame on 3 row bands, and 2 FULL frames on a (camera 2, band 3)
    grid, each against the unsharded program in the same call."""
    import tpu_darktable_torch as tt
    from tpu_darktable_torch import parallel
    from tpu_darktable_torch._graph import Graphed
    from tpu_darktable_torch.pipeline.camera_settings import load_camera_settings_from_dir

    report = {}
    cams = load_camera_settings_from_dir()
    rig = cams['beetroot']
    w, h = rig.image_size
    names = list(rig.transform)
    frames = synthetic_frames(w, h, len(names), seed=1300, ids=True).to(dev)
    image_set = dict(zip(names, frames))
    mk = lambda mesh: tt.ImageProcessor(rig.image_size, rig.bayer_pattern, rig.packed_format,
                                        rig.image_processing, device=dev,
                                        white_balance=rig.white_balance,
                                        transforms=rig.transform, padding=rig.padding, mesh=mesh)
    mesh = parallel.make_mesh([dev] * 4)
    sharded, single = mk(mesh), mk(None)
    def run(p):
        """The image set from the EMA's first state: every call the same work."""
        p.bounds = p.metrics = None
        return torch.stack(list(p.process_image_set(image_set).values())), p.bounds, p.metrics

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run(single)   # its eager first call and capture: the reference below is a replay
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    report['rig graph'] = dict(
        first_call_s=first_s, peak_gib=peak,
        graph_reserved_gib=(torch.cuda.memory_reserved() - base) / 2**30)
    log(f'the rig\'s unsharded processor ({len(names)} cameras a batch): {report["rig graph"]}')
    label = f'beetroot rig {w}x{h} Packed12_IDS, 12 cameras batch-sharded over {mesh.size} shards'
    sharded_case(label, lambda: run(sharded), lambda: run(single), len(names), 1, report)
    report[label]['stage_captures'] = {
        name: len(g._captured)
        for name, g in zip(('front', 'back', 'tonemap'), sharded._fused.graphs)}
    log(f'the rig\'s sharded stages: captures {report[label]["stage_captures"]} (one '
        'capture a stage for the four shards)')
    if any(n != 1 for n in report[label]['stage_captures'].values()):
        raise AssertionError('the rig\'s shards did not share one capture a stage')
    out = sharded.process_image_set(image_set)
    if tuple(out['cam1'].shape) != (w, h, 3) or tuple(out['cam7'].shape) != (w, h, 3):
        raise AssertionError('the rig\'s per-camera rotations were not applied')

    del sharded, single, out
    report['rig reserved_gib_after'] = reserved_gib()
    art = cams['artichoke']
    s = art.image_processing
    # the unsharded program, graphed as ImageProcessor graphs it
    ref_fn = Graphed(tt.build_pipeline_fn(s, (W, H), art.bayer_pattern, art.packed_format, True,
                                          rcd_strict_alias=False))
    f32 = dict(dtype=torch.float32, device=dev)
    state0 = (torch.tensor(WB, **f32), torch.zeros(2, **f32), torch.zeros(5, **f32),
              torch.ones((), **f32))
    batch = synthetic_frames(W, H, 2, seed=1310).to(dev)

    bands = parallel.make_mesh([dev] * 3)
    spatial = parallel.build_spatial_pipeline_fn(s, (W, H), art.bayer_pattern, art.packed_format,
                                                 True, bands, halo=64)
    label = f'FULL {W}x{H} on {bands.size} row bands (band {H // 3}, halo 64)'
    sharded_case(label, lambda: spatial(batch[0], *state0),
                 lambda: (lambda o, b, m: (o[0], b, m))(*ref_fn(batch[:1], *state0)), 1, 3,
                 report)
    del spatial
    band_glue_case(label, lambda: parallel.build_spatial_pipeline_fn(
        s, (W, H), art.bayer_pattern, art.packed_format, True, bands, halo=64),
        lambda p: p(batch[0], *state0), 1, report)

    grid_mesh = parallel.make_grid_mesh(2, 3, [dev] * 6)
    grid = parallel.build_grid_pipeline_fn(s, (W, H), art.bayer_pattern, art.packed_format, True,
                                           grid_mesh, halo=64)
    label = f'FULL {W}x{H} batch 2 on a (camera 2, band 3) grid'
    sharded_case(label, lambda: grid(batch, *state0), lambda: ref_fn(batch, *state0), 2, 3,
                 report)
    del grid
    band_glue_case(label, lambda: parallel.build_grid_pipeline_fn(
        s, (W, H), art.bayer_pattern, art.packed_format, True, grid_mesh, halo=64),
        lambda p: p(batch, *state0), 2, report)

    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        spread = parallel.make_mesh([torch.device('cuda', i % n_cards) for i in range(3)])
        over = parallel.build_spatial_pipeline_fn(s, (W, H), art.bayer_pattern,
                                                  art.packed_format, True, spread, halo=64)
        out = over(batch[0], *state0)[0]
        d = int((out.to(torch.int16) - ref_fn(batch[:1], *state0)[0][0].to(torch.int16))
                .abs().max().item())
        report[f'FULL on 3 bands over {n_cards} cards'] = dict(max_count_diff=d)
        log(f'FULL on 3 bands over {n_cards} cards: max |diff| {d} count(s)')
        if d > 1:
            raise AssertionError(f'the bands over {n_cards} cards differ by {d} counts')
    else:
        log('one card: the bands over distinct cards did not run')
    return report


# ---------------------------------------------------------------- phase 14

def phase_viewer(dev):
    """The viewer's controller (scripts/view_raw/pipeline_ui.py) on the card,
    headless and with matplotlib and Pillow blocked, at 4096x3000, then
    card against CPU at 1024x768."""
    import tempfile

    blocked = {m: sys.modules.get(m) for m in ('matplotlib', 'PIL')}
    sys.modules.update(dict.fromkeys(blocked))
    try:
        from tpu_darktable_torch import kernels
        from tpu_darktable_torch.pipeline.camera_settings import settings_for_file
        from tpu_darktable_torch.scripts.view_raw.jpeg_utils import encode_jpeg_bytes
        from tpu_darktable_torch.scripts.view_raw.pipeline_ui import PipelineController

        report = {}
        with tempfile.TemporaryDirectory() as tmp:
            cam_dir = Path(tmp) / 'artichoke'
            cam_dir.mkdir()
            path = cam_dir / 'frame0.raw'
            path.write_bytes(synthetic_frames(W, H, 1, seed=1400)[0].numpy().tobytes())
            cams = settings_for_file(path)
            base = reserved_gib()
            torch.cuda.synchronize()
            kernels.reset_launches()
            c = PipelineController(cams, [path], device=dev)
            times, shapes, captured = {}, {}, {}
            for step, action in (('process_current', None),
                                 ("update_setting('tone_gamma', 2.0)",
                                  lambda: c.update_setting('tone_gamma', 2.0)),
                                 ("apply_preset('reinhard')", lambda: c.apply_preset('reinhard')),
                                 ('rotate', c.rotate), ('reset', c.reset)):
                before = workspace_captures(c.processor)
                if action is not None:
                    action()
                t0 = time.perf_counter()
                img = c.process_current()   # ends in the copy to the host
                times[step] = (time.perf_counter() - t0) * 1e3
                shapes[step] = img.shape
                after = workspace_captures(c.processor)
                # the workspaces that captured anew: a new workspace, or a new key
                captured[step] = [n for n in WORKSPACES if after[n][1] and (
                    after[n][0] != before[n][0] or set(after[n][1]) - set(before[n][1]))]
            if shapes['rotate'] != shapes["apply_preset('reinhard')"][1::-1] + (3,):
                raise AssertionError(f'rotate did not turn the frame: {shapes}')
            launches = {k: v for k, v in kernels.launches.items() if v}
            pool_gib = reserved_gib() - base
            data = encode_jpeg_bytes(img, quality=90, device=dev)
            log(f'viewer controller {cams.name} {W}x{H} on the card: ms of process_current after '
                f'each step {({k: round(v, 2) for k, v in times.items()})}; the workspaces that '
                f'captured anew at each step {captured}; shapes {shapes}; launches {launches}; '
                f'the controller keeps {pool_gib:.2f} GiB reserved; '
                f'JPEG {len(data)} bytes, {data[:2].hex()}..{data[-2:].hex()}')
            missing = [k for k in FULL_KERNELS if not launches.get(k)]
            if missing or img.dtype != np.uint8 or img.std() < 1.0:
                raise AssertionError(f'the viewer launched no {missing}, or its frame is flat')
            if data[:2] != b'\xff\xd8' or data[-2:] != b'\xff\xd9':
                raise AssertionError('encode_jpeg_bytes gave no JFIF stream')
            if captured["update_setting('tone_gamma', 2.0)"]:
                raise AssertionError('a tone step captured anew: '
                                     f'{captured["update_setting('tone_gamma', 2.0)"]}')

            # steady frames: the controller replayed, in turns with an eager copy
            eager = PipelineController(cams, [path], device=dev)
            ungraphed(eager.processor)
            keys = workspace_captures(c.processor)
            turns = in_turns([('eager 1', lambda _: eager.process_current()),
                              ('graphed 1', lambda _: c.process_current()),
                              ('graphed 2', lambda _: c.process_current()),
                              ('eager 2', lambda _: eager.process_current())], range(3))
            for label, (outs, _) in turns.items():
                if not all(np.array_equal(a, turns['eager 1'][0][0]) for a in outs):
                    raise AssertionError(f'the viewer\'s {label} frames differ from the eager copy')
            if workspace_captures(c.processor) != keys:
                raise AssertionError('a steady viewer frame captured anew')
            steady = {k: 1e3 * sum(t) / len(t) for k, (_, t) in turns.items()}
            log(f'viewer process_current {W}x{H}, steady frames in turns, bit for bit with the '
                'eager copy; ms a frame: ' + ', '.join(f'{k} {v:.2f}' for k, v in steady.items()))
            report.update(ms_process_current=times, shapes=shapes, launches=launches,
                          captured_anew=captured, pool_reserved_gib=pool_gib,
                          steady_ms=steady,
                          jpeg_bytes=len(data))
            del turns, eager, c

            small = dataclasses.replace(cams, image_size=(1024, 768))
            path = cam_dir / 'small.raw'
            path.write_bytes(synthetic_frames(1024, 768, 1, seed=1401)[0].numpy().tobytes())
            outs = [PipelineController(small, [path], device=d).process_current().astype(int)
                    for d in (dev, torch.device('cpu'))]
            d = int(np.abs(outs[0] - outs[1]).max())
            report['card_vs_cpu_1024x768'] = d
            log(f'viewer controller card vs cpu at 1024x768: max |diff| {d} count(s), '
                f'{(outs[0] != outs[1]).mean():.2e} of values differ')
            if d > 1:
                raise AssertionError(f'the viewer: card and CPU differ by {d} counts')
        return report
    finally:
        for m, mod in blocked.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script needs one GPU',
              file=sys.stderr)
        return 2
    import tpu_darktable_torch  # noqa: F401  (fails where the repo is absent)

    dev = torch.device('cuda')
    seconds = {}

    reserved = {}

    def timed(phase, *args):
        t0 = time.perf_counter()
        result = phase(*args)
        torch.cuda.synchronize()
        name = phase.__name__ + (' 2' if phase.__name__ in seconds else '')
        seconds[name] = round(time.perf_counter() - t0, 1)
        # what the phase leaves reserved once its processors and graphs are gone
        reserved[name] = round(reserved_gib(), 2)
        return result

    smi = timed(phase_card_and_build)
    kern = timed(phase_kernels, dev)
    timed(phase_goldens, dev)
    timed(phase_card_vs_cpu, dev, full_settings())
    launches, full = timed(phase_full, dev)
    # each kernel's count from the run of its own path
    denoise_launches, config3 = timed(phase_denoise, dev)
    launches.update({k: v for k, v in denoise_launches.items()
                     if k in ('wavelet_core', 'nlm_core')})
    config2 = timed(phase_config2, dev)
    launches['grid_blur_xyz'] = timed(phase_general_bilateral, dev)['grid_blur_xyz']
    # the tile core's pipeline path: FULL with denoise_f16 off (phase 8)
    launches.update(timed(phase_wiener_route, dev))
    piecewise_report, piecewise_profiled = timed(phase_piecewise, dev)
    lap, lap_profiled = timed(phase_laplacian, dev)
    jpeg = timed(phase_jpeg, dev, smi)
    lap = timed(profile_runs, lap, lap_profiled)
    piecewise_report = timed(profile_runs, piecewise_report, piecewise_profiled)
    # the last references to phase 9's and 11's processors and their graphs
    del lap_profiled, piecewise_profiled
    full.update(timed(profile_full, dev))
    cli = timed(phase_cli, dev)
    sharded = timed(phase_sharded, dev)
    viewer = timed(phase_viewer, dev)
    log(f'seconds by phase: {seconds}')
    log(f'GiB reserved after each phase: {reserved}')
    for k in kern:
        k['launches'] = launches[k['name']]
    keys = ['name', 'route', 'source', 'replaces', 'launches', 'max_abs_err', 'ms', 'plain_ms',
            'bound_ms', 'bound_by', 'library_ms']
    print(json.dumps({'full': full, 'config2': config2, 'config3': config3,
                      'piecewise': piecewise_report}))
    print(json.dumps({'jpeg': jpeg}))
    print(json.dumps({'laplacian': lap}))
    print(json.dumps({'cli': cli}))
    print(json.dumps({'sharded': sharded, 'viewer': viewer}))
    print(json.dumps({'kernels': [{key: k[key] for key in keys} for k in kern]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
