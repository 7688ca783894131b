"""The comparison that decides `correct`: what the timed path produced,
held against the reference (isp_bench/reference, plain PyTorch and numpy).

- bounds_gap: the bounds EMA after every call of the run, in order, against
  the reference's recurrence over the same batches (each batch's bounds
  from the reference's front stage of its pool frames), as a share of the
  reference's range.  It covers decode, white balance, RCD, postprocess and
  the state carried from call to call, and the gathers between cards.
- metrics_gap: at the sampled calls, the metrics EMA against the reference's
  step from the program's own state before the call (the reference cannot
  follow every call's back stage, so it checks this step call by call; the
  first call of the run, from the zero state, is always sampled).
- u8_max_counts, u8_off_share: at the sampled calls, every uint8 value of
  every frame against the reference's back stage and tonemap: the widest
  gap in counts, and the share of values that differ at all.
- jpeg_mismatch: of the sampled calls' frames whose JFIF bytes reached the
  caller, the number whose bytes differ from the reference encoder's bytes
  of the program's own uint8 frame, after the reference's orientation
  transform (exact: the encoder is integer work after a float64 DCT).

The control puts the reference computed in a lower precision (each stage's
output rounded to bfloat16) in the program's place, on the same batches.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import jpeg as ref_jpeg
from .reference.isp import Camera, ReferenceISP, lerp

NUMBERS = ('bounds_gap', 'metrics_gap', 'u8_max_counts', 'u8_off_share', 'jpeg_mismatch')


def _rows(pool, p, device):
    return torch.from_numpy(np.ascontiguousarray(pool[p])).to(device)


def compare(rec, pool: np.ndarray, camera: dict, names, device, *, jpeg_quality=None,
            jpeg_frames: int = 0, rng=None, control: bool = False) -> dict:
    """The numbers of NUMBERS for the run in `rec` (a drive.Recorder), or
    for the control in the program's place when `control`."""
    cam = Camera.from_dict(camera)
    ref = ReferenceISP(cam, device)
    subject = ReferenceISP(cam, device, lower_precision=True) if control else None
    f32 = dict(dtype=torch.float32, device=device)
    used = sorted({p for c in rec.calls for p in c.pool_idx})

    def front_samples(isp):
        return {p: isp.sample(isp.front(_rows(pool, p, device))) for p in used}

    ref_samples = front_samples(ref)
    sub_samples = front_samples(subject) if control else None
    alpha_steady = float(cam.settings['moving_average'])

    out = {k: 0.0 for k in NUMBERS}
    b_ref = torch.zeros(2, **f32)
    b_sub = torch.zeros(2, **f32)
    ref_bounds = {}
    for c in rec.calls:
        alpha = torch.full((), 1.0 if c.bounds_in is None else alpha_steady, **f32)
        if c.bounds_in is None:
            b_ref = torch.zeros(2, **f32)
            b_sub = torch.zeros(2, **f32)
        b_ref = lerp(b_ref, ref.batch_bounds([ref_samples[p] for p in c.pool_idx]), alpha)
        ref_bounds[c.index] = (b_ref, alpha)
        if control:
            b_sub = lerp(b_sub, ref.batch_bounds([sub_samples[p] for p in c.pool_idx]), alpha)
            got = b_sub
        else:
            got = c.bounds_out.to(device)
        gap = (got - b_ref).abs().max() / (b_ref[1] - b_ref[0])
        out['bounds_gap'] = max(out['bounds_gap'], float(gap))
    del ref_samples, sub_samples

    n_values = n_off = 0
    checked = 0
    for c in rec.kept_calls():
        b, alpha = ref_bounds[c.index]
        m_in = torch.zeros(5, **f32) if c.metrics_in is None else c.metrics_in.to(device)
        frames = [_rows(pool, p, device) for p in c.pool_idx]
        u8_ref, m_ref = ref.run_batch(frames, b, m_in, alpha)
        if control:
            u8_got, m_got = subject.run_batch(frames, b, m_in, alpha)
        else:
            u8_got = [c.out[j].to(device) for j in range(c.n)]
            m_got = c.metrics_out.to(device)
        out['metrics_gap'] = max(out['metrics_gap'], float((m_got - m_ref).abs().max()))
        for j in range(c.n):
            d = (u8_got[j].to(torch.int16) - u8_ref[j].to(torch.int16)).abs()
            out['u8_max_counts'] = max(out['u8_max_counts'], float(d.max()))
            n_off += int((d > 0).sum())
            n_values += d.numel()
        if control or jpeg_quality is None:
            continue
        frames_here = [c.first_frame + j for j in range(c.n) if c.first_frame + j in rec.jpeg]
        if rng is not None and len(frames_here) > jpeg_frames:
            frames_here = sorted(rng.sample(frames_here, jpeg_frames))
        for i in frames_here:
            oriented = ref.oriented(c.out[i - c.first_frame].to(device), names[i % len(names)])
            want = ref_jpeg.encode(oriented, jpeg_quality)
            got = np.frombuffer(rec.jpeg[i], np.uint8)
            out['jpeg_mismatch'] += 0 if np.array_equal(want, got) else 1
            checked += 1
    out['u8_off_share'] = n_off / max(n_values, 1)
    out['jpeg_checked'] = checked
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit; correct when none is above."""
    rows = {k: {'value': numbers[k], 'limit': limits[k]} for k in NUMBERS if k in limits}
    return all(r['value'] <= r['limit'] for r in rows.values()), rows


__all__ = ['NUMBERS', 'compare', 'verdict']
