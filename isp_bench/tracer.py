"""Readers of the program's own tracer (tpu_darktable_torch/utils/timing.py):
the card time of each stage from the device marks of each call, and the
host spans of the entry and of the streaming executor.

A traced run (bench.run with `traced`) turns the tracer on before its
set-up, so that every graph is captured with its marks, and its context
(bench._context) carries `marks` and `spans`, the tracer's records of the
run (each mark: name, call, host, ns; each span: name, thread, start,
end, attrs, parent; host times on the harness's clock); both are None in
an untraced run or where the program has no tracer.  Without them, or
where it finds nothing, a reader returns None.  A stage's card time is
the time from the last mark of its opening names to its closing mark, in
each traced call of the program; a "per frame" reading is summed over
the window's calls and divided by their frames, as readers.isp_card_ms
is.  A metric file names a stage's marks itself (`isp_stage`,
`jpeg_stage`), so a stage's metric is one file in metrics/.
"""

from __future__ import annotations

from .stats import median
from .trace import Trace

MARK_KERNEL = 'trace_mark_write'


def _by_call(marks) -> dict:
    """call -> its marks in the device's order."""
    calls: dict = {}
    for m in marks:
        calls.setdefault(m.call, []).append(m)
    for ms in calls.values():
        ms.sort(key=lambda m: m.ns)
    return calls


def _opened_by(ctx, first: str) -> list:
    return [ms for ms in _by_call(ctx.marks).values() if ms[0].name == first]


def isp_calls(ctx):
    """The batched program's traced calls inside the window's process_batch
    calls, and the frames of those calls; None without marks."""
    if getattr(ctx, 'marks', None) is None:
        return None
    program = _opened_by(ctx, 'begin')
    found, frames = [], 0
    for c in ctx.calls:
        inside = [ms for ms in program if c.t0 <= ms[0].host <= c.t1]
        if inside:
            found.extend(inside)
            frames += c.n
    return found, frames


def jpeg_calls(ctx):
    """The JPEG encodes of the frames of those calls (each encode is its
    own traced call, dispatched after its batch's program call), and the
    frames of those calls."""
    found = isp_calls(ctx)
    if found is None:
        return None
    window, frames = found
    program = sorted(ms[0].host for ms in _opened_by(ctx, 'begin'))
    inside = {ms[0].host for ms in window}
    out = []
    for ms in _opened_by(ctx, 'jpeg.begin'):
        owner = max((t for t in program if t <= ms[0].host), default=None)
        if owner in inside:
            out.append(ms)
    return out, frames


def stage_ms(calls, opens, closes: str) -> float | None:
    """Card ms, summed over `calls`, from the last mark named in `opens` to
    each `closes` mark after it; None where no such pair exists."""
    total, pairs = 0.0, 0
    for ms in calls:
        last = None
        for m in ms:
            if m.name == closes and last is not None:
                total += (m.ns - last.ns) * 1e-6
                pairs += 1
                last = None
            elif m.name in opens:
                last = m
    return total if pairs else None


def _per_frame(found, opens, closes):
    if found is None:
        return None
    calls, frames = found
    total = stage_ms(calls, opens, closes)
    return total / frames if total is not None and frames else None


def isp_stage(opens: tuple, closes: str):
    """The reader of one stage of the batched program: card ms a frame from
    the last mark named in `opens` to the `closes` mark."""
    def read(ctx):
        return _per_frame(isp_calls(ctx), opens, closes)
    return read


def jpeg_stage(opens: tuple, closes: str):
    """The reader of one stage of the window's JPEG encodes, likewise."""
    def read(ctx):
        return _per_frame(jpeg_calls(ctx), opens, closes)
    return read


def mark_table(ctx) -> dict | None:
    """Every mark's mean card ms a frame, from the mark before it in its
    call (the batched program's and the JPEG encodes' apart), with each
    kind's whole call under 'all'."""
    out = {}
    for label, found, first, last in (('isp', isp_calls(ctx), 'begin', 'tonemap'),
                                      ('jpeg', jpeg_calls(ctx), 'jpeg.begin', 'jpeg.scan')):
        if found is None or not found[1] or not found[0]:
            continue
        calls, frames = found
        table: dict = {}
        for ms in calls:
            for a, b in zip(ms, ms[1:]):
                table[b.name] = table.get(b.name, 0.0) + (b.ns - a.ns) * 1e-6
        table = {k: v / frames for k, v in table.items()}
        whole = stage_ms(calls, (first,), last)
        table['all'] = whole / frames if whole is not None else None
        out[label] = table
    return out or None


# ---- host spans ----

def _spans(ctx, name):
    return [s for s in getattr(ctx, 'spans', None) or () if s.name == name]


def isp_input_ms(ctx):
    """Host ms a frame in process_batch before the program's call (the
    `isp.input` span: checks, the copy to the card, the EMA inputs)."""
    if getattr(ctx, 'spans', None) is None:
        return None
    spans = _spans(ctx, 'isp.input')
    total, frames = 0.0, 0
    for c in ctx.calls:
        inside = [s for s in spans if c.t0 <= s.start <= c.t1]
        if inside:
            total += sum(s.end - s.start for s in inside) * 1e3
            frames += c.n
    return total / frames if frames else None


def span_table(ctx) -> dict | None:
    """Each span name's count, host ms a frame and mean host ms, over the
    spans that start inside the window (frames: the window's)."""
    spans = getattr(ctx, 'spans', None)
    if spans is None or not ctx.frames:
        return None
    t0, t1 = ctx.window
    table: dict = {}
    for s in spans:
        if t0 <= s.start < t1:
            n, total = table.get(s.name, (0, 0.0))
            table[s.name] = (n + 1, total + (s.end - s.start) * 1e3)
    return {k: (n, total / len(ctx.frames), total / n) for k, (n, total) in table.items()}


def window_batches(ctx) -> list:
    """(call, its `stream.flush` span, its `stream.drain` span) for each
    window call that the streaming executor flushed and drained."""
    if getattr(ctx, 'spans', None) is None:
        return []
    flushes = _spans(ctx, 'stream.flush')
    drains = {s.attrs.get('seq'): s for s in _spans(ctx, 'stream.drain')}
    out = []
    for c in ctx.calls:
        flush = next((s for s in flushes if s.start <= c.t0 <= s.end), None)
        if flush is not None and flush.attrs.get('seq') in drains:
            out.append((c, flush, drains[flush.attrs['seq']]))
    return out


def drain_hold_ms(ctx):
    """Median over the window's batches of the time from the end of a
    batch's flush to the start of its drain (ms)."""
    holds = [(d.start - f.end) * 1e3 for _, f, d in window_batches(ctx)]
    return median(holds) if holds else None


def _results_in(ctx, drain):
    return [s for s in _spans(ctx, 'jpeg.result')
            if s.thread == drain.thread and drain.start <= s.start <= drain.end]


def jpeg_result_ms(ctx):
    """Host ms a frame in PendingJpeg.result, over the drains of the
    window's batches."""
    batches = window_batches(ctx)
    frames = sum(c.n for c, _, _ in batches)
    if not frames:
        return None
    total = sum(s.end - s.start for _, _, d in batches for s in _results_in(ctx, d))
    return total * 1e3 / frames


def tail_parts(ctx):
    """For each window batch: its first frame's feed lag, its flush, its
    hold and its JPEG results (host ms, summed), against its slowest
    frame from due to done; the medians of both, or None."""
    batches = window_batches(ctx)
    if not batches:
        return None
    start = {c.index: k for k, c in enumerate(ctx.calls)}
    sums, slowest = [], []
    for c, f, d in batches:
        k0 = sum(x.n for x in ctx.calls[:start[c.index]])
        frames = ctx.frames[k0:k0 + c.n]
        done = [fr.done - fr.due for fr in frames if fr.done is not None]
        if len(done) < c.n:
            continue
        results = sum(s.end - s.start for s in _results_in(ctx, d))
        sums.append((frames[0].take - frames[0].due + (f.end - f.start) + (d.start - f.end)
                     + results) * 1e3)
        slowest.append(max(done) * 1e3)
    return (median(sums), median(slowest)) if sums else None


# ---- the traced slice ----

def stage_ops(ctx, device: int = 0, top: int = 3) -> dict | None:
    """From the traced slice, the device ops with the most time between
    each pair of marks of a call, by the mark that closes the pair
    ('outside the marks' between calls), in ms a frame of the slice (its
    `decode` marks).  The slice's mark kernels are matched to the run's
    marks on the card by the pattern of the times between them (the
    profiler's clock is not the card's)."""
    tr: Trace | None = ctx.trace
    marks = [m for m in getattr(ctx, 'marks', None) or () if str(m.device) == f'cuda:{device}']
    if tr is None or len(marks) < 3:
        return None
    acts = sorted(tr.in_window(device), key=lambda a: a.start)
    kernels = [a for a in acts if MARK_KERNEL in a.name]
    n = len(kernels)
    if n < 3 or n > len(marks):
        return None
    marks.sort(key=lambda m: m.ns)
    want = [(b.start - a.start) for a, b in zip(kernels, kernels[1:])]
    gaps = [(b.ns - a.ns) * 1e-3 for a, b in zip(marks, marks[1:])]
    best, at = None, 0
    for j in range(len(gaps) - len(want) + 1):
        err = 0.0
        for k, w in enumerate(want):
            err += abs(gaps[j + k] - w)
            if best is not None and err >= best:
                break
        if best is None or err < best:
            best, at = err, j
    matched = marks[at:at + n]
    ops: dict = {}
    k = 0
    for a in acts:
        if MARK_KERNEL in a.name:
            continue
        while k < n and kernels[k].start <= a.start:
            k += 1
        if 0 < k < n and matched[k - 1].call == matched[k].call:
            label = matched[k].name
        else:
            label = 'outside the marks'
        by_op = ops.setdefault(label, {})
        by_op[a.name] = by_op.get(a.name, 0.0) + (a.end - a.start) * 1e-3
    frames = sum(m.name == 'decode' for m in matched) or 1
    return {label: [(name, ms / frames) for name, ms in
                    sorted(v.items(), key=lambda kv: -kv[1])[:top]] for label, v in ops.items()}


def __getattr__(name):
    """READINGS, for chip_trace.py: metric name -> reader, for every
    per-layer metric of BENCHMARK.json whose reader this module made."""
    if name != 'READINGS':
        raise AttributeError(name)
    from . import spec

    found = {m['name']: spec.metric_reader(m['name']) for m in spec.benchmark()['per_layer']}
    return {k: v for k, v in found.items() if getattr(v, '__module__', None) == __name__}


__all__ = ['MARK_KERNEL', 'drain_hold_ms', 'isp_calls', 'isp_input_ms', 'isp_stage', 'jpeg_calls',
           'jpeg_result_ms', 'jpeg_stage', 'mark_table', 'span_table', 'stage_ms', 'stage_ops',
           'tail_parts', 'window_batches']
