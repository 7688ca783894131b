"""A profiled steady slice of a run, reduced to plain intervals.

torch.profiler (CUPTI) records the slice; its chrome trace is parsed here
into device activities (kernels, copies, sets: name, device, start, end)
and the harness's own ranges (record_function: name, thread, start, end),
all on the profiler's microsecond clock.  The per-layer readers and the breakdown
work from these lists alone, so they can be tested with hand-made ones.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

# the harness's ranges: the entry's batch call, the open loop's wait for a
# capture's due time, and the traced slice itself
ISP_RANGE = 'isp_bench.process_batch'
WAIT_RANGE = 'isp_bench.wait_for_due'
SLICE_RANGE = 'isp_bench.slice'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
NAME_CHARS = 160      # a device op's name in the breakdown (C++ signatures run long)


@dataclass
class Activity:
    name: str
    device: int
    start: float          # us
    end: float            # us
    cat: str = 'kernel'


@dataclass
class HostRange:
    name: str
    tid: int
    start: float
    end: float


@dataclass
class Trace:
    device: list[Activity] = field(default_factory=list)
    ranges: list[HostRange] = field(default_factory=list)
    window: tuple[float, float] = (0.0, 0.0)                               # the slice, us

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def devices(self) -> list[int]:
        return sorted({a.device for a in self.device})

    def in_window(self, device: int | None = None) -> list[Activity]:
        """Activities clipped to the slice, on one device or all."""
        t0, t1 = self.window
        out = []
        for a in self.device:
            if device is not None and a.device != device:
                continue
            s, e = max(a.start, t0), min(a.end, t1)
            if e > s:
                out.append(Activity(a.name, a.device, s, e, a.cat))
        return out


def parse_chrome(events: list[dict]) -> Trace:
    tr = Trace()
    for ev in events:
        if ev.get('ph') != 'X':
            continue
        cat = ev.get('cat', '')
        ts, dur = float(ev.get('ts', 0.0)), float(ev.get('dur', 0.0))
        args = ev.get('args') or {}
        if cat in DEVICE_CATS:
            tr.device.append(Activity(ev.get('name', ''), int(args.get('device', 0)), ts, ts + dur,
                                      cat))
        elif cat == 'user_annotation':
            tr.ranges.append(HostRange(ev.get('name', ''), ev.get('tid', 0), ts, ts + dur))
    slices = [r for r in tr.ranges if r.name == SLICE_RANGE]
    if slices:
        tr.window = (slices[0].start, slices[0].end)
    elif tr.device:
        tr.window = (min(a.start for a in tr.device), max(a.end for a in tr.device))
    return tr


def load_chrome(path) -> Trace:
    with open(path) as f:
        data = json.load(f)
    return parse_chrome(data['traceEvents'] if isinstance(data, dict) else data)


def union(intervals) -> list[tuple[float, float]]:
    """Merged (start, end) intervals: overlapping work counts once."""
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_us(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


def idle_gaps(intervals, window) -> list[tuple[float, float]]:
    """The stretches of the window that no interval covers."""
    t0, t1 = window
    gaps, at = [], t0
    for s, e in union(intervals):
        if s > at:
            gaps.append((at, min(s, t1)))
        at = max(at, e)
    if at < t1:
        gaps.append((at, t1))
    return [(s, e) for s, e in gaps if e > s]


def idle_share(tr: Trace, device: int) -> float:
    """1 - busy / wall over the slice, on one device."""
    acts = tr.in_window(device)
    return 1.0 - busy_us([(a.start, a.end) for a in acts]) / (tr.window[1] - tr.window[0])


def host_label(tr: Trace, t: float) -> str:
    """The innermost harness range the host was in at time t."""
    inside = [r for r in tr.ranges if r.start <= t <= r.end and r.name != SLICE_RANGE
              and not r.name.startswith('ProfilerStep')]
    if not inside:
        return 'outside the harness ranges'
    return min(inside, key=lambda r: r.end - r.start).name


def breakdown(tr: Trace, device: int = 0, top: int = 10) -> dict:
    """The device ops with the most time over the slice, and the longest
    idle gaps, each labelled by the harness range the host was in when it
    began (seconds)."""
    acts = tr.in_window(device)
    by_name: dict[str, float] = {}
    for a in acts:
        by_name[a.name] = by_name.get(a.name, 0.0) + (a.end - a.start) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps([(a.start, a.end) for a in acts], tr.window),
                  key=lambda g: g[0] - g[1])[:top]
    return {'device_ops': [[n[:NAME_CHARS], s] for n, s in ops],
            'idle_gaps': [[host_label(tr, s), (e - s) * 1e-6] for s, e in gaps]}


def profile_to(path):
    """A torch.profiler over CPU and CUDA for one slice: started, it warms
    up; its first step records; stopped, it writes the chrome trace to
    `path`."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def done(prof):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(str(path))

    return torch.profiler.profile(activities=acts, on_trace_ready=done,
                                  schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                                                   repeat=1))


__all__ = ['Activity', 'HostRange', 'ISP_RANGE', 'SLICE_RANGE', 'WAIT_RANGE', 'Trace', 'breakdown', 'busy_us',
           'host_label', 'idle_gaps', 'idle_share', 'load_chrome', 'parse_chrome',
           'profile_to', 'union']
