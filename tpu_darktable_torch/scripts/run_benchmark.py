"""Per-op benchmark (counterpart of tpu_darktable/scripts/run_benchmark.py).

Measures iterations/s of each op after a warm-up: the op is chained on its
own output `bench_iters` times, the calls enqueued back to back and fenced
once (utils/timing.py:benchmark_op).  The default input is a synthetic
4096x3000 frame.

    python -m tpu_darktable_torch.scripts.run_benchmark [IMAGE] [--bench-iters 10]
        [--width 4096 --height 3000] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device, to_device
from ..jpeg import InputFormat, Jpeg
from ..ops import bilateral as _bl
from ..ops import color as _cl
from ..ops import demosaic as _dm
from ..ops import laplacian as _lap
from ..ops import postprocess as _pp
from ..ops import rcd as _rcd
from ..ops import wiener as _wn
from ..ops.bayer import BayerPattern, rgb_to_bayer
from ..utils.timing import benchmark_op
from .util import add_device_argument, load_image


def benchmark(name: str, fn, x0, warmup_iters: int = 2, bench_iters: int = 10) -> float:
    """Iterations/s of `fn` chained `bench_iters` times from `x0`."""
    elapsed = benchmark_op(fn, x0, iters=bench_iters, warmup=warmup_iters) * bench_iters
    rate = bench_iters / elapsed
    print(f'{name}: {bench_iters} iterations in {elapsed * 1e3:.1f}ms at {rate:.1f} iters/sec')
    return rate


def run_benchmark(
    image_path: Path | None,
    pattern: BayerPattern,
    warmup_iters: int = 2,
    bench_iters: int = 10,
    jpeg_quality: int = 90,
    size: tuple[int, int] = (4096, 3000),
    device=None,
) -> dict[str, float]:
    """Print and return each op's iterations/s."""
    device = resolve_device(device)
    if image_path is not None:
        rgb_tensor = load_image(image_path, device)
    else:
        w, h = size
        rng = np.random.default_rng(0)
        rgb_tensor = to_device((rng.random((h, w, 3)) * 0.8).astype(np.float32), device)
    bayer_input = rgb_to_bayer(rgb_tensor, pattern)

    height, width = bayer_input.shape[:2]
    print()
    print('=== Benchmark Settings ===')
    print(f'Image size: {width}x{height}')
    print(f'Warmup iterations: {warmup_iters}')
    print(f'Benchmark iterations: {bench_iters}')
    print(f'Pattern: {pattern.name}')
    print(f'Device: {device}')
    print()

    bayer2d = bayer_input[..., 0].contiguous()
    mono = _cl.compute_luminance(rgb_tensor)
    rates = {}

    def bench(name, fn, x0, iters=bench_iters):
        rates[name] = benchmark(name, fn, x0, warmup_iters, iters)

    print('=== Denoise Benchmarks ===')
    bench('Wiener 32x2', lambda x: _wn.wiener_denoise(x, 0.05, 32, 2), rgb_tensor)
    bench('Wiener 32x4', lambda x: _wn.wiener_denoise(x, 0.05, 32, 4), rgb_tensor)
    bench('Wiener 32x2 Gray',
          lambda x: _cl.modify_luminance(
              x, _wn.wiener_denoise(_cl.compute_luminance(x)[..., None], 0.05, 32, 2)[..., 0]),
          rgb_tensor)
    bench('Estimate Noise',
          lambda x: x * (1e-9 * torch.sum(_wn.estimate_channel_noise(x)) + 1.0), rgb_tensor)

    print()
    print('=== Demosaic Algorithm Benchmarks ===')
    bench('PPG', lambda x: _dm.ppg_demosaic(x, pattern)[..., 1], bayer2d)
    bench('RCD', lambda x: _rcd.rcd_demosaic(x, pattern)[..., 1], bayer2d)
    bench('Bilinear 5x5', lambda x: _dm.bilinear5x5_demosaic(x, pattern)[..., 1], bayer2d)

    print()
    print('=== Post-processing Benchmarks ===')
    bench('Color smooth', lambda x: _pp.postprocess(x, pattern, 3, False, False), rgb_tensor)
    bench('Green eq', lambda x: _pp.postprocess(x, pattern, 0, True, True), rgb_tensor)

    print()
    print('=== Laplacian/Bilateral Benchmarks ===')
    bench('Laplacian', lambda x: _lap.local_laplacian(x, _lap.LaplacianParams()), mono,
          max(2, bench_iters // 2))
    bench('Bilateral 2x2', lambda x: _bl.bilateral_process(x, 2.0, 0.2, 0.2), mono)
    bench('Bilateral 8x1', lambda x: _bl.bilateral_process(x, 8.0, 0.1, 0.2), mono)

    print()
    print('=== JPEG Encoding Benchmarks ===')
    u8 = torch.clamp(rgb_tensor * 255.0, 0, 255).to(torch.uint8)
    jpeg = Jpeg()

    def bench_host(name, fn, iters=5):
        fn()  # warm
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        rates[name] = iters / (time.perf_counter() - t0)
        print(f'{name}: {iters} iterations at {rates[name]:.2f} iters/sec')

    bench_host(f'JPEG Encode (Q{jpeg_quality})',
               lambda: jpeg.encode(u8, quality=jpeg_quality, input_format=InputFormat.RGBI))
    print()
    return rates


def main(argv=None):
    parser = argparse.ArgumentParser(description='Benchmark demosaic algorithms and post-processing')
    parser.add_argument('image', type=Path, nargs='?', default=None,
                        help='Input image path (default: synthetic 4096x3000)')
    parser.add_argument('--pattern', type=str, default='RGGB',
                        choices=[p.name for p in BayerPattern])
    parser.add_argument('--warmup-iters', type=int, default=2)
    parser.add_argument('--bench-iters', type=int, default=10)
    parser.add_argument('--jpeg-quality', type=int, default=90)
    parser.add_argument('--width', type=int, default=4096)
    parser.add_argument('--height', type=int, default=3000)
    add_device_argument(parser)
    args = parser.parse_args(argv)

    run_benchmark(args.image, BayerPattern[args.pattern], args.warmup_iters, args.bench_iters,
                  args.jpeg_quality, (args.width, args.height), args.device)


if __name__ == '__main__':
    main()
