"""The arithmetic the per-layer readers share.  Each metric's own file in
metrics/ picks what it reads; a reader that finds nothing returns None."""

from __future__ import annotations

import json

from . import trace as _trace
from .spec import HERE
from .stats import median


def peaks() -> dict:
    return json.loads((HERE / 'peaks.json').read_text())


def feed_lag_ms(ctx):
    """Median over the window's frames of how late the entry took each one
    after it was due."""
    lags = [(f.take - f.due) * 1e3 for f in ctx.frames]
    return median(lags) if lags else None


def isp_card_ms(ctx):
    """The card's span of each process_batch call (CUDA events on its
    stream, recorded by the harness's proxy), summed over the window, per
    frame."""
    calls = [c for c in ctx.calls if getattr(c, 'card_ms', None) is not None]
    n = sum(c.n for c in calls)
    return sum(c.card_ms for c in calls) / n if n else None


def frames_per_s(ctx):
    """Frames whose result came inside the window, over the time from the
    window's start to the last of them."""
    t0, t1 = ctx.window
    done = [f.done for f in ctx.frames if f.done is not None and f.done <= t1]
    return len(done) / (max(done) - t0) if done else None


def jpeg_card_ms(ctx):
    """The card's span of each call's JPEG stages (from the call's end
    event to the event after the last JPEG launch of its frames, CUDA
    events on its stream), summed over the window, per frame."""
    calls = [c for c in ctx.calls if getattr(c, 'jpeg_ms', None) is not None]
    n = sum(c.n for c in calls)
    return sum(c.jpeg_ms for c in calls) / n if n else None


def least_ms(work: dict, pixels: int, pk: dict) -> float:
    """The least time one launch needs: its bytes at the HBM rate or its
    operations at the float32 rate, whichever is longer."""
    return max(work['bytes_per_pixel'] * pixels / pk['hbm_bytes_per_s'],
               work['ops_per_pixel'] * pixels / pk['fp32_flops_per_s']) * 1e3


def roofline_pct(ctx, device: int = 0):
    """Over the slice, the hand kernels' least time (from the cell's
    shapes) over their measured device time, in percent."""
    tr = ctx.trace
    if tr is None:
        return None
    pk = peaks()
    least = spent = 0.0
    for a in tr.in_window(device):
        for sym, work in ctx.work.items():
            if sym in a.name:
                least += least_ms(work, ctx.pixels, pk)
                spent += (a.end - a.start) * 1e-3
                break
    return 100.0 * least / spent if spent else None


def device_idle_pct(ctx, devices=(0,)):
    """100 x (1 - the union of device activity over the slice's wall time),
    averaged over `devices`."""
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * sum(_trace.idle_share(tr, d) for d in devices) / len(devices)
