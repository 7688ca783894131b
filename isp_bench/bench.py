"""One run of one cell: set-up, warm-up, the measured window, the metrics,
then the comparison with the reference.  `run.py` is the command; this
module holds the run so that a test can drive it on the CPU at a small
size (the command itself refuses to run without a card)."""

from __future__ import annotations

import contextlib
import gc
import os
import random
import sys
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from . import check, drive, readers, scene, spec, trace, tracer
from .stats import percentile

# top-level module names that must not be loaded when the window closes
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'tpu_darktable')


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: tpu_darktable_torch is not tpu_darktable."""
    return sorted({m for m in list(sys.modules) if m.split('.')[0] in FORBIDDEN})


def frame_names(camera: dict, batch: int) -> list[str]:
    """Frame names in feed order: a rig's cameras by name (their transforms
    are per camera), else one name a frame of the batch."""
    tf = camera.get('transform', 'none')
    if isinstance(tf, dict):
        names = list(tf)
        if len(names) != batch:
            raise ValueError(f'a capture of {len(names)} cameras fed in batches of {batch}')
        return names
    return [f'frame{j}' for j in range(batch)]


def build_processor(camera: dict, devices):
    from tpu_darktable_torch.parallel import make_mesh
    from tpu_darktable_torch.pipeline.camera_settings import CameraSettings
    from tpu_darktable_torch.pipeline.image_processor import ImageProcessor

    cs = CameraSettings.from_dict(camera)
    mesh = make_mesh(devices) if len(devices) > 1 else None
    return ImageProcessor(cs.image_size, cs.bayer_pattern, cs.packed_format,
                          cs.image_processing, device=devices[0],
                          white_balance=cs.white_balance, transforms=cs.transform,
                          padding=cs.padding, mesh=mesh)


def _sync(devices):
    for d in dict.fromkeys(devices):
        if d.type == 'cuda':
            torch.cuda.synchronize(d)


def _program_tracer():
    """The program's tracer (tpu_darktable_torch.utils.timing), or None
    where the program has none."""
    try:
        from tpu_darktable_torch.utils import timing
    except ImportError:
        return None
    # before the tracer, the module held the timers alone
    return timing if hasattr(timing, 'enable') else None


@contextlib.contextmanager
def _tracing(on: bool):
    """The program's tracer on for the block, where `on` and the program
    has a tracer: from before the set-up, so the graphs are captured with
    their marks; its records are forgotten first."""
    timing = _program_tracer() if on else None
    if timing is None:
        yield
        return
    timing.reset()
    timing.enable()
    try:
        yield
    finally:
        timing.disable()


def _context(rec, tr, cfg, work) -> SimpleNamespace:
    """What the per-layer readers read: the window's calls (with the card's
    ms of each, and of its frames' JPEG stages) and frames, the trace of
    the slice after the window, the kernels' work, and the program's
    tracer records (`marks`, `spans`: None unless the tracer is on)."""
    t0, t1 = rec.window
    calls = [c for c in rec.calls if c.in_window]
    for c in calls:
        if c.events:
            c.card_ms = c.events[0].elapsed_time(c.events[1])
        if c.jpeg_end is not None:
            c.jpeg_ms = c.events[1].elapsed_time(c.jpeg_end)
    frames = [SimpleNamespace(take=rec.take[i], due=rec.due[i],
                              done=rec.done[i] if i < len(rec.done) else None)
              for i in range(len(rec.take)) if t0 <= rec.take[i] < t1]
    w, h = cfg['camera']['image_size']
    timing = _program_tracer()
    on = timing is not None and timing.tracing()
    return SimpleNamespace(calls=calls, frames=frames, window=(t0, t1), trace=tr, work=work,
                           pixels=w * h, chips=cfg['chips'], marks=timing.marks() if on else None,
                           spans=timing.spans() if on else None)


def _report_tracer(ctx) -> None:
    """The tracer's tables of a traced run, on standard error."""
    err = sys.stderr
    for kind, table in (tracer.mark_table(ctx) or {}).items():
        print(f'isp_bench: {kind} marks, card ms a frame from the mark before: '
              + ', '.join(f'{k} {v:.3f}' for k, v in table.items() if v is not None), file=err)
    print('isp_bench: spans in the window (count, host ms a frame, mean ms): '
          + '; '.join(f'{k} {n} {a:.3f} {m:.3f}'
                      for k, (n, a, m) in (tracer.span_table(ctx) or {}).items()), file=err)
    for label, ops in (tracer.stage_ops(ctx) or {}).items():
        print(f'isp_bench: top device ops to {label}, ms a frame: '
              + '; '.join(f'{name[:70]} {ms:.3f}' for name, ms in ops), file=err)
    parts = tracer.tail_parts(ctx)
    if parts is not None:
        print(f'isp_bench: lag + flush + hold + results {parts[0]:.1f} ms against the slowest '
              f'frame {parts[1]:.1f} ms (medians over the window batches)', file=err)


@dataclass
class Setup:
    """A cell ready to run: its processor behind the proxy, its entry and
    frame pool, warmed up."""

    cell: dict
    cfg: dict
    traffic: dict
    camera: dict
    devices: list
    names: list
    pool: np.ndarray
    proc: object
    rec: drive.Recorder
    entry: object                 # the StreamingExecutor, or None for the batch entry
    proxy: drive.Proxy
    setup_s: float = 0.0

    @property
    def on_card(self) -> bool:
        return self.devices[0].type == 'cuda'

    def go(self, **kw):
        """Feed the entry: count=... (warm-up) or seconds=... (a window)."""
        batch = self.traffic['batch_size']
        if self.entry is not None:
            drive.stream(self.entry, self.rec, self.pool, self.names, batch, **kw)
        else:
            kw.pop('rate', None)
            drive.batches(self.proxy, self.rec, self.pool, batch, **kw)


def prepare(cell_name: str, seed: int, *, t_process=None, devices=None, camera_override=None,
            bench=None, fault=None) -> Setup:
    """Set-up and warm-up of a cell: frames from the seed, the processor,
    the entry, and the warm-up batches, which build and capture every shape
    the window uses.  `devices` defaults to the cell's cards;
    `camera_override` updates the configuration's camera settings (tests
    shrink the frames); `fault`, a test's hook, gets the processor after
    set-up and may break it."""
    t_start = drive.clock() if t_process is None else t_process
    bench = spec.benchmark() if bench is None else bench
    c = spec.cell(cell_name, bench)
    cfg = spec.config(c['config'])
    traffic = spec.traffic(c['traffic'])
    camera = dict(cfg['camera'], **(camera_override or {}))
    if devices is None:
        devices = [torch.device('cuda', i) for i in range(c['chips'])]
    devices = [torch.device(d) for d in devices]
    batch = traffic['batch_size']
    t_pool = drive.clock()
    pool = scene.frame_pool(camera, traffic['pool_frames'], seed, devices[0])
    t_proc = drive.clock()
    proc = build_processor(camera, devices)
    rec = drive.Recorder(keep=traffic['check_calls'], rng=random.Random(seed))
    proxy = drive.Proxy(proc, rec, devices[0].type == 'cuda')
    if traffic['entry'] == 'stream':
        from tpu_darktable_torch.pipeline.streaming import StreamingExecutor

        entry = StreamingExecutor(proxy, batch_size=batch, jpeg_quality=traffic['jpeg_quality'],
                                  device_jpeg=traffic['device_jpeg'], keep_images=False)
        if getattr(entry, '_jpeg', None) is not None:
            # the executor's encoder, timed as the processor is; without it
            # (another design of the executor) the JPEG reader reads nothing
            entry._jpeg = drive.JpegProxy(entry._jpeg, rec)
    elif traffic['entry'] == 'batch':
        entry = None
    else:
        raise ValueError(f"unknown entry {traffic['entry']!r}")
    s = Setup(c, cfg, traffic, camera, devices, frame_names(camera, batch), pool, proc, rec,
              entry, proxy)
    t_warm = drive.clock()
    s.go(count=traffic['warm_batches'] * (batch if entry is not None else 1))
    _sync(devices)
    if fault is not None:
        fault(proc)
    t_end = drive.clock()
    s.setup_s = t_end - t_start
    print(f'isp_bench: set-up {s.setup_s:.2f} s: imports {t_pool - t_start:.2f}, frames '
          f'{t_proc - t_pool:.2f}, processor {t_warm - t_proc:.2f}, warm-up {t_end - t_warm:.2f} '
          f'(first call {rec.calls[0].t1 - rec.calls[0].t0:.2f})', file=sys.stderr)
    return s


def run(cell_name: str, seed: int, seconds: float, traced: bool, **kw) -> dict:
    """The run's result (the dict run.py prints); with `control`, also the
    control's numbers under 'control'.  Keywords go to prepare.  A traced
    run has the program's tracer on throughout."""
    with _tracing(traced):
        return _run(cell_name, seed, seconds, traced, **kw)


def _run(cell_name: str, seed: int, seconds: float, traced: bool, *, control=False,
         bench=None, **kw) -> dict:
    bench = spec.benchmark() if bench is None else bench
    s = prepare(cell_name, seed, bench=bench, **kw)
    traffic, devices, rec, cfg = s.traffic, s.devices, s.rec, s.cfg
    on_card, setup_s = s.on_card, s.setup_s

    tslice, trace_path = None, None
    if traced:
        trace_path = spec.OUT / f'trace.{cell_name}.{os.getpid()}.json'
        tslice = drive.Slice(drive.SETTLE_S, traffic['trace_slice_s'], trace.profile_to(trace_path))
    s.go(seconds=seconds, rate=traffic.get('captures_per_s'), tslice=tslice)
    _sync(devices)
    if tslice is not None:
        print(f'isp_bench: traced slice after the window: profiler up in {tslice.up_s:.2f} s, '
              f'recorded from {tslice.record_at - rec.window[1]:.2f} s after the close',
              file=sys.stderr)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f'modules loaded that the benchmark forbids: {found}')

    reserved = max((torch.cuda.max_memory_reserved(d) for d in dict.fromkeys(devices)
                    if d.type == 'cuda'), default=0)
    t0, t1 = rec.window
    window_frames = [i for i in range(len(rec.take)) if t0 <= rec.take[i] < t1]
    done = [i for i in window_frames if i < len(rec.done)]
    failed = rec.errors + len(window_frames) - len(done)
    device = {'platform': 'gpu' if on_card else 'cpu',
              'kind': torch.cuda.get_device_name(devices[0]) if on_card else 'cpu',
              'count': len(dict.fromkeys(devices)), 'memory_peak_bytes': int(reserved)}
    calls = [c for c in rec.calls if c.in_window]
    worst = [max(rec.done[i] - rec.due[i] for i in range(c.first_frame, c.first_frame + c.n)
                 if i < len(rec.done)) * 1e3 for c in calls if c.first_frame < len(rec.done)]
    print('isp_bench: the slowest frame of each window batch (ms): '
          + ' '.join(f'{v:.0f}' for v in worst), file=sys.stderr)
    metrics, breakdown = {}, None
    tr = None
    if traced and trace_path.is_file():
        tr = trace.load_chrome(trace_path)
        trace_path.unlink()
    ctx = _context(rec, tr, cfg, spec.kernel_work())
    if not traced:
        lat = [(rec.done[i] - rec.due[i]) * 1e3 for i in done]
        values = {
            'setup_s': setup_s,
            # over the time to the last result in the window: the batch still in
            # flight at the close would quantise the rate by whole batches
            'frames_per_s': readers.frames_per_s(ctx) or 0.0,
            'frame_p95_ms': percentile(lat, 95.0) if lat else float('inf'),
            'peak_reserved_gib': reserved / 2**30,
        }
        # one quantity may go by several names, one a group of cells with
        # its own bound: frame_p95_ms, open_loop_p95_ms
        values['open_loop_p95_ms'] = values['frame_p95_ms']
        for m in spec.metrics_of(cell_name, 'end_to_end', bench):
            metrics[m['name']] = {'value': values[m['name'].split('.')[0]], 'unit': m['unit']}
    else:
        _report_tracer(ctx)
        for m in spec.metrics_of(cell_name, 'per_layer', bench):
            v = spec.metric_reader(m['name'])(ctx)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
        if tr is not None and tr.device:
            devs = tr.devices()
            device['busy_s'] = float(np.mean([
                trace.busy_us([(a.start, a.end) for a in tr.in_window(d)]) * 1e-6 for d in devs]))
            device['window_s'] = tr.window_s
            breakdown = trace.breakdown(tr, devs[0])

    # the comparison, once the program's state is gone
    t_check = drive.clock()
    s.entry = s.proxy = s.proc = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = check.compare(rec, s.pool, s.camera, s.names, devices[0],
                            jpeg_quality=traffic.get('jpeg_quality'),
                            jpeg_frames=traffic.get('check_jpeg_frames', 0),
                            rng=random.Random(seed + 1))
    ok, rows = check.verdict(numbers, spec.limits(cell_name))
    print(f'isp_bench: window {seconds} s, comparison {drive.clock() - t_check:.2f} s',
          file=sys.stderr)
    result = {'correct': bool(ok and failed == 0), 'attempted': len(window_frames),
              'failed': failed, 'metrics': metrics, 'device': device}
    if breakdown is not None:
        result['breakdown'] = breakdown
    if control:
        result['control'] = check.compare(rec, s.pool, s.camera, s.names, devices[0],
                                          control=True)
    result['checks'] = dict(rows, failed={'value': failed, 'limit': 0},
                            jpeg_checked={'value': numbers['jpeg_checked'], 'limit': None})
    return result


__all__ = ['FORBIDDEN', 'Setup', 'build_processor', 'forbidden_modules', 'frame_names', 'prepare',
           'run']
