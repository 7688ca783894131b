"""One cell of the benchmark with the program's tracer on, and what it sees.

    python3 chip_trace.py --workload <cell> --seed <n> --seconds <s> [--out FILE.json]

The benchmark's traced run (isp_bench/run.py --trace 1) leaves the
program's tracer off.  This runs the same thing, bench.run with its traced
slice after the window, with tpu_darktable_torch.utils.timing turned on
before the cell's set-up, so that every graph is captured with its device
marks, and reads the tracer's records of the window (isp_bench/tracer.py):

  - the per-layer readings: the card ms a frame of demosaic, postprocess,
    denoise, bilateral and tonemap (the batched program's marks), of the
    JPEG entropy scan (the encodes' marks), the host ms a frame of
    `isp.input` and of `jpeg.result` in the drains, and the median hold
    of a batch between its flush and its drain;
  - the mark table: every mark's mean card ms a frame from the mark before
    it, and each kind of call's whole span, against the harness's
    isp_card_ms and jpeg_card_ms of the same window;
  - the counters' deltas over the window, and each span's count and host
    ms a frame in the window;
  - from the traced slice, the top device ops between each pair of marks,
    and the idle gaps labelled by the innermost host range, the program's
    spans among them;
  - for an open loop, the median over its captures of the first frame's
    feed lag + flush + hold + JPEG results against the median of each
    capture's slowest frame.

The result line of bench.run, with these under 'tracer', is the last line
of standard output and goes to FILE; the tables go to standard error.
Without a card it exits with status 2 (its tables are card times).

It runs the harness's own traced run with three of the harness's private
names wrapped (bench._context, drive.Slice.start, drive._open_window) and
fails at once if any of them is missing or has another signature.  Once
the benchmark turns the tracer on in its traced runs itself, this script
goes, and isp_bench/tracer.py's readers move into isp_bench/metrics/.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))


# the harness's names that traced_run wraps, with the parameters it passes on
_WRAPPED = {('bench', '_context'): ['rec', 'tr', 'cfg', 'work'],
            ('drive.Slice', 'start'): ['self', 'period'],
            ('drive', '_open_window'): ['rec', 'seconds']}


def _check_wrapped(bench, drive) -> None:
    """Raise unless each name of _WRAPPED is there with its parameters."""
    owners = {'bench': bench, 'drive': drive, 'drive.Slice': getattr(drive, 'Slice', None)}
    for (owner, name), params in _WRAPPED.items():
        fn = getattr(owners[owner], name, None)
        got = list(inspect.signature(fn).parameters) if callable(fn) else None
        if got != params:
            raise RuntimeError(f'chip_trace: isp_bench {owner}.{name} is {got}, not {params}: '
                               'the harness changed under the names this script wraps')


def traced_run(cell: str, seed: int, seconds: float, **kw) -> dict:
    """bench.run(cell, seed, seconds, traced=True, **kw) with the program's
    tracer on; its result with the tracer's readings under 'tracer'."""
    from isp_bench import bench, drive, readers, tracer
    from tpu_darktable_torch.utils import timing

    _check_wrapped(bench, drive)
    seen = {}
    real_context, real_start, real_open = bench._context, drive.Slice.start, drive._open_window

    def context(*args):
        seen['ctx'] = real_context(*args)
        return seen['ctx']

    def slice_start(self, *args, **kwargs):
        # the window has closed: the counters' deltas stop here
        seen['counters'] = timing.counters()
        return real_start(self, *args, **kwargs)

    def window_open(rec, secs):
        if secs is not None:
            seen['counters_at_open'] = timing.counters()
        return real_open(rec, secs)

    timing.reset()
    timing.enable()
    bench._context, drive.Slice.start, drive._open_window = context, slice_start, window_open
    try:
        result = bench.run(cell, seed, seconds, True, **kw)
    finally:
        bench._context, drive.Slice.start, drive._open_window = real_context, real_start, \
            real_open
        timing.disable()
    ctx = seen['ctx']
    ctx.marks, ctx.spans = timing.marks(), timing.spans()
    table = tracer.mark_table(ctx) or {}
    harness = {'isp': readers.isp_card_ms(ctx), 'jpeg': readers.jpeg_card_ms(ctx)}
    marks_vs_events = {k: (table[k]['all'], harness[k], table[k]['all'] / harness[k])
                       for k in table if harness.get(k) and table[k].get('all') is not None}
    readings = {name.split('.')[0]: fn(ctx) for name, fn in tracer.READINGS.items()}
    result['tracer'] = {
        'readings': {k: v for k, v in readings.items() if v is not None},
        'mark_table': table,
        'marks_vs_events': marks_vs_events,
        'counters': _delta(seen.get('counters_at_open', {}), seen.get('counters', {})),
        'spans': tracer.span_table(ctx),
        'stage_ops': tracer.stage_ops(ctx),
        'tail_parts': tracer.tail_parts(ctx),
        'n_marks': len(ctx.marks),
        'n_spans': len(ctx.spans),
    }
    return result


def _delta(before: dict, after: dict) -> dict:
    out = {}
    for name, v in after.items():
        b = before.get(name, {} if isinstance(v, dict) else 0)
        if isinstance(v, dict):
            d = {k: n - b.get(k, 0) for k, n in v.items() if n - b.get(k, 0)}
            if d:
                out[name] = d
        elif v - b:
            out[name] = v - b
    return out


def report(result: dict) -> None:
    t = result['tracer']
    err = sys.stderr
    print(f"chip_trace: correct {result['correct']}; readings "
          + ', '.join(f'{k} {v:.3f}' for k, v in t['readings'].items()), file=err)
    for kind, table in t['mark_table'].items():
        print(f'chip_trace: {kind} marks, mean card ms a frame from the mark before: '
              + ', '.join(f'{k} {v:.3f}' for k, v in table.items() if v is not None), file=err)
    for kind, (marks, events, ratio) in t['marks_vs_events'].items():
        print(f'chip_trace: {kind} marks {marks:.3f} ms a frame against the harness events '
              f'{events:.3f} (ratio {ratio:.4f})', file=err)
    print(f"chip_trace: counters over the window {t['counters']}", file=err)
    print('chip_trace: spans in the window (count, host ms a frame, mean ms): '
          + '; '.join(f'{k} {n} {a:.3f} {m:.3f}' for k, (n, a, m) in (t['spans'] or {}).items()),
          file=err)
    for label, ops in (t['stage_ops'] or {}).items():
        print(f'chip_trace: top device ops to {label}, ms a frame: '
              + '; '.join(f'{name[:70]} {ms:.3f}' for name, ms in ops), file=err)
    if t['tail_parts']:
        parts, slowest = t['tail_parts']
        print(f'chip_trace: lag + flush + hold + results {parts:.1f} ms against the slowest '
              f'frame {slowest:.1f} ms (ratio {parts / slowest:.4f})', file=err)
    for label, s in (result.get('breakdown') or {}).get('idle_gaps', []):
        print(f'chip_trace: idle gap {s * 1e3:.2f} ms, the host in {label}', file=err)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--out', type=Path)
    args = ap.parse_args(argv)
    from isp_bench import env

    env.setup()
    import torch

    if not torch.cuda.is_available():
        print('chip_trace: torch.cuda.is_available() is False; the tables are card times',
              file=sys.stderr)
        return 2
    result = traced_run(args.workload, args.seed, args.seconds)
    report(result)
    line = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + '\n')
    print(line, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
