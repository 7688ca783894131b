"""First calls on the card: what a user waits for before anything replays.

At 4096x3000 on one card, in this order, after a warm-up that builds the
kernels and runs FULL once (as chip_smoke.py phase 9 does before its
first piecewise frame):
- a new processor's first piecewise frame (load_bytes -> debayer ->
  process_rgb -> tonemap, FULL's settings) and its second;
- the viewer controller's first process_current and its second;
- a new Jpeg's first encode of a 12 MP frame (4:2:2, quality 90, the
  device entropy) and its next two;
- each image tool's run() (chip_smoke.py's CLI_CALLS, phase 12), called
  twice: every call builds its workspace anew, so both are first calls.
Each call is split into its captures (`_graph.Graphed._capture`, where the
tree has it) and the rest (the eager run), and inside the captures the
host time in torch.cuda.synchronize (mostly the wait for the eager run's
kernels), gc.collect and torch.cuda.empty_cache.

Each tree runs in a process of its own, in the order given, so another
checkout (a parent commit unpacked by `git archive` into a git-ignored
directory) is timed in turns with this one:

    python3 chip_first_calls.py --trees build/parent . . build/parent \\
        --out build/first_calls.json

A tree given as `DIR:torch.cuda.graph` captures through torch.cuda.graph
(a synchronize and the emptying of the device and host caches before each
capture, and gc.collect where torch asks for it) in place of the tree's
own `_graph._capturing`.  The host cache's emptying is not timed apart.  Prints one JSON line a tree run.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent


def _instrument():
    """Host seconds inside captures, by what spends them (reset by caller)."""
    from tpu_darktable_torch import _graph

    stats = dict.fromkeys(('capture', 'synchronize', 'gc_collect', 'empty_cache'), 0.0)
    stats['captures'] = 0
    inside = [False]

    def timed(name, f):
        def wrapper(*args, **kwargs):
            if not inside[0]:
                return f(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return f(*args, **kwargs)
            finally:
                stats[name] += time.perf_counter() - t0
        return wrapper

    torch.cuda.synchronize = timed('synchronize', torch.cuda.synchronize)
    torch.cuda.empty_cache = timed('empty_cache', torch.cuda.empty_cache)
    gc.collect = timed('gc_collect', gc.collect)
    capture = getattr(getattr(_graph, 'Graphed', None), '_capture', None)
    if capture is not None:
        def counted(self, *args):
            inside[0] = True
            t0 = time.perf_counter()
            try:
                return capture(self, *args)
            finally:
                inside[0] = False
                stats['capture'] += time.perf_counter() - t0
                stats['captures'] += 1
        _graph.Graphed._capture = counted
    return stats


def _with_torch_graph():
    """_graph._capturing as torch.cuda.graph makes it, on a side stream."""
    from tpu_darktable_torch import _graph

    streams = {}

    def capturing(graph, pool):
        index = torch.cuda.current_device()
        stream = streams.setdefault(index, torch.cuda.Stream(index))
        return torch.cuda.graph(graph, pool=pool, stream=stream,
                                capture_error_mode='thread_local')

    _graph._capturing = capturing


def _one(tree: Path, capture: str | None) -> dict:
    sys.path.insert(0, str(tree))
    import chip_smoke as cs   # the tree's own helpers and constants
    import tpu_darktable_torch as tt

    if not Path(tt.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f'imported {tt.__file__}, not the package of {tree}')
    if capture == 'torch.cuda.graph':
        _with_torch_graph()
    elif capture is not None:
        raise ValueError(f'unknown capture: {capture}')
    dev = torch.device('cuda')
    smi = cs.phase_card_and_build()
    stats = _instrument()

    def timed_call(fn):
        for k in stats:
            stats[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
        split = {f'{k}_ms': v * 1e3 for k, v in stats.items() if k != 'captures'}
        return dict(ms=total, eager_ms=total - split['capture_ms'], captures=stats['captures'],
                    **split)

    def release():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    W, H = cs.W, cs.H
    s = cs.full_settings()
    mk = lambda: tt.ImageProcessor((W, H), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12, s,
                                   device=dev, white_balance=cs.WB)
    frame = cs.synthetic_frames(W, H, 1, seed=700)[0].to(dev)
    warm = mk()
    warm.process(frame, 'x')
    bounds, metrics = warm.bounds, warm.metrics
    del warm
    release()

    report = {'tree': str(tree), 'capture': capture or 'the tree\'s own', 'card': smi}
    proc = mk()

    def piecewise():
        rgb = proc.debayer(proc.load_bytes(frame))
        proc.tonemap(proc.process_rgb(rgb, bounds), metrics)

    report['piecewise'] = [timed_call(piecewise) for _ in range(2)]
    del proc
    release()

    from tpu_darktable_torch.pipeline.camera_settings import settings_for_file
    from tpu_darktable_torch.scripts.view_raw.pipeline_ui import PipelineController

    with tempfile.TemporaryDirectory() as tmp:
        cam_dir = Path(tmp) / 'artichoke'
        cam_dir.mkdir()
        path = cam_dir / 'frame0.raw'
        path.write_bytes(cs.synthetic_frames(W, H, 1, seed=1400)[0].numpy().tobytes())
        c = PipelineController(settings_for_file(path), [path], device=dev)
        report['viewer'] = [timed_call(c.process_current) for _ in range(2)]
        del c
    release()

    u8 = torch.from_numpy((cs.config5_scene(W, H, seed=1500) * 255).astype('uint8')).to(dev)
    jpeg = tt.Jpeg()
    report['Jpeg.encode'] = [timed_call(lambda: jpeg.encode(u8, 90)) for _ in range(3)]
    del jpeg
    release()

    import importlib

    rgb = torch.from_numpy(cs.config5_scene(W, H, seed=1200)).to(dev)
    for label, module, argv, _, _ in cs.CLI_CALLS:
        mod = importlib.import_module(f'tpu_darktable_torch.scripts.{module}')
        args = mod.parser().parse_args(['synthetic.png', *argv, '--device', str(dev)])
        report[label] = [timed_call(lambda: mod.run(rgb, args, dev)) for _ in range(2)]
        release()
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--trees', nargs='+', default=['.'],
                   help='checkouts to time in turns, each DIR or DIR:torch.cuda.graph')
    p.add_argument('--out', type=Path, default=None, help='write the reports here as JSON')
    p.add_argument('--one', default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_first_calls: torch.cuda.is_available() is False', file=sys.stderr)
        return 2
    if args.one is not None:
        tree, _, capture = args.one.partition(':')
        print(json.dumps(_one(Path(tree).resolve(), capture or None)), flush=True)
        return 0
    reports = []
    for spec in args.trees:
        tree = Path(spec.partition(':')[0]).resolve()
        run = subprocess.run([sys.executable, str(REPO / 'chip_first_calls.py'), '--one',
                              f'{tree}{spec[len(spec.partition(":")[0]):]}'],
                             cwd=tree, capture_output=True, text=True, timeout=600)
        if run.returncode != 0:
            print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        reports.append(json.loads(run.stdout.strip().splitlines()[-1]))
        print(json.dumps(reports[-1]), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(reports, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
