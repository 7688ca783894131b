"""The frames a run feeds: natural scenes made from the seed on the device,
packed as the camera packs them, and held in host memory as a camera
delivers them.

A scene is three smooth fields (sinusoids of the same spatial periods,
levels and amplitudes for every seed, at the seed's phases), seen through the
configuration's white balance as a sensor sees it (each channel divided by
its gain), sampled on the RGGB mosaic, with shot noise (variance in
proportion to the signal) and read noise, quantised to 12 bits.  Natural
content matters: pure noise would make every JPEG ~10x larger than a
scene does and turn the entropy stage into another workload.

The 12-bit packer is the benchmark's own (the formats of ops/packed.py of
the measured package, written out here):

  Packed12:      b0 = p0 & 0xff;  b1 = (p1 & 0xf) << 4 | p0 >> 8;  b2 = p1 >> 4
  Packed12_IDS:  b0 = p0 >> 4;    b1 = p1 >> 4;  b2 = (p1 & 0xf) << 4 | (p0 & 0xf)

(IDS as its decoder reads it: p0's low nibble is b2's low one.)
"""

from __future__ import annotations

import numpy as np
import torch

# spatial periods (pixels), levels and amplitudes of the three fields; the
# seed draws phases only, so every seed asks the same work of the ISP and
# of the JPEG entropy stage (whose work follows the noise, so the signal)
_PERIODS = ((331.0, 237.0), (181.0, 419.0), (293.0, 149.0))
_LEVELS = (0.40, 0.45, 0.35)
_AMPS = (0.35, 0.30, 0.30)
_SHOT = 4e-4        # noise variance per unit of signal
_READ = 2e-5        # noise variance of the read-out


def pack12(values: torch.Tensor, ids: bool) -> torch.Tensor:
    """int32 12-bit values (..., 2N) -> packed uint8 (..., 3N)."""
    pairs = values.reshape(values.shape[:-1] + (-1, 2))
    p0, p1 = pairs[..., 0], pairs[..., 1]
    if ids:
        b = (p0 >> 4, p1 >> 4, ((p1 & 0xF) << 4) | (p0 & 0xF))
    else:
        b = (p0 & 0xFF, ((p1 & 0xF) << 4) | (p0 >> 8), p1 >> 4)
    out = torch.stack(b, dim=-1).to(torch.uint8)
    return out.reshape(values.shape[:-1] + (out.shape[-2] * 3,))


def scene_mosaics(width: int, height: int, n: int, seed: int, gains, device) -> torch.Tensor:
    """(n, height, width) int32 12-bit RGGB mosaics of n scenes."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    f32 = dict(dtype=torch.float32, device=device)
    # one draw of every frame's phases, then each frame's noise in one draw
    phases = torch.rand((n, 3, 2), generator=gen, **f32) * (2 * np.pi)
    yy = torch.arange(height, **f32)[:, None]
    xx = torch.arange(width, **f32)[None, :]
    out = torch.empty((n, height, width), dtype=torch.int32, device=device)
    site = torch.zeros((height, width), dtype=torch.int64, device=device)   # R
    site[0::2, 1::2] = 1                                                    # G
    site[1::2, 0::2] = 1                                                    # G
    site[1::2, 1::2] = 2                                                    # B
    inv_gain = 1.0 / torch.as_tensor(gains, **f32)
    for i in range(n):
        chans = torch.stack([
            _LEVELS[c] + _AMPS[c] * torch.sin(xx / _PERIODS[c][0] + phases[i, c, 0])
            * torch.cos(yy / _PERIODS[c][1] + phases[i, c, 1]) for c in range(3)])
        signal = torch.gather(chans, 0, site[None])[0] * inv_gain[site]
        signal = signal.clamp(0.0, 1.0)
        noise = torch.randn((height, width), generator=gen, **f32)
        raw = signal + noise * torch.sqrt(_SHOT * signal + _READ)
        out[i] = torch.round(raw.clamp(0.0, 1.0) * 4095.0).to(torch.int32)
    return out


def frame_pool(camera: dict, n: int, seed: int, device) -> np.ndarray:
    """(n, bytes) uint8 packed frames in host memory, with the camera's
    padding bytes (zeros) at the end of each."""
    width, height = camera['image_size']
    ids = camera.get('packed_format', 'Packed12') == 'Packed12_IDS'
    gains = camera.get('white_balance') or (1.0, 1.0, 1.0)
    mosaics = scene_mosaics(width, height, n, seed, gains, device)
    packed = pack12(mosaics.reshape(n, -1), ids)
    pad = int(camera.get('padding', 0))
    if pad:
        packed = torch.cat([packed, torch.zeros((n, pad), dtype=torch.uint8, device=device)], 1)
    return packed.cpu().numpy()


__all__ = ['frame_pool', 'pack12', 'scene_mosaics']
