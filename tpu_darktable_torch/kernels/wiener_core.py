"""Wiener tile core: wrapper of csrc/wiener_core.cu and its plain version.

Replaces the TPU kernel tpu_darktable/kernels/wiener_core.py:wiener_tile_core:
for every K x K tile t of the coset slabs, with wf2 = outer(wf, wf) and
wi2 = outer(wi, wi): m = mean(t); the real 2-D DFT of (t - m) * wf2; the
Wiener gain max(power - sig2, 0) / power with power = re^2 + im^2 + 1e-15;
the inverse transform times wi2, plus m * wf2 * wi2.

On the H100 the function is bound by its 8 bytes a pixel: a real 2-D FFT
each way needs ~74 float operations a pixel at K = 32, less than the bytes
cost.  The TPU kernel's dense folded-basis product costs O(K^4) a tile;
the Hopper kernel is a radix-2 FFT in registers: a warp transforms two
tiles at once as one complex tile (columns in the lanes' registers, one
transpose through shared memory, rows, the two spectra split by a warp
shuffle, gain, and the same steps back), and reads and writes the tiles in
place in the slabs' spatial layout, so the two tile-major transposes of the
TPU path are gone.  The plain version keeps the dense folded-basis einsums
(the JAX package's stacked formulation); the two differ by float32 rounding
only: their sums run in different orders, and the plain version subtracts
the mean after the transform.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import device_cache
from . import launch

_EPS = 1e-15


def _check(slabs: torch.Tensor, sig2: torch.Tensor, wf, wi, k: int):
    if slabs.dtype != torch.float32 or slabs.ndim != 3:
        raise RuntimeError(f'slabs must be (G, n_ty*K, n_tx*K) float32, got {slabs.dtype} '
                           f'{tuple(slabs.shape)}')
    if not slabs.is_contiguous():
        raise RuntimeError('slabs must be contiguous')
    if k not in (16, 32):
        raise ValueError(f'tile size must be 16 or 32, got {k}')
    g, hh, ww = slabs.shape
    if hh % k or ww % k:
        raise ValueError(f'slab {hh}x{ww} is not a whole number of {k}x{k} tiles')
    if sig2.dtype != torch.float32 or sig2.ndim != 1 or sig2.device != slabs.device \
            or sig2.numel() < 1 or g % sig2.numel():
        raise RuntimeError(f'sig2 must be a float32 vector on {slabs.device} whose length divides '
                           f'G = {g}, got {sig2.dtype} {tuple(sig2.shape)} on {sig2.device}')
    if np.shape(wf) != (k,) or np.shape(wi) != (k,):
        raise ValueError(f'windows must have shape ({k},), got {np.shape(wf)} and {np.shape(wi)}')


@device_cache(maxsize=8)
def _windows(k: int, wf_bytes: bytes, wi_bytes: bytes, device: torch.device) -> torch.Tensor:
    """(2, K) float32 on the device: the analysis and the synthesis window."""
    tab = np.stack([np.frombuffer(wf_bytes, np.float32), np.frombuffer(wi_bytes, np.float32)])
    return torch.as_tensor(tab, device=device)


def wiener_tile_core(slabs: torch.Tensor, sig2: torch.Tensor, wf: np.ndarray, wi: np.ndarray,
                     *, k: int) -> torch.Tensor:
    """Coset slabs (G, n_ty*K, n_tx*K) float32 -> the reconstructed,
    window-weighted slabs in the same layout.

    sig2: (G,) or any (n,) with n dividing G (slab g uses sig2[g // (G // n)],
    so (C,) serves channel-major slabs).  wf, wi: (K,) float32 analysis and
    synthesis windows.
    """
    _check(slabs, sig2, wf, wi, k)
    if slabs.device.type == 'cpu':
        return wiener_tile_core_plain(slabs, sig2, wf, wi, k=k)
    g, hh, ww = slabs.shape
    windows = _windows(k, np.asarray(wf, np.float32).tobytes(),
                       np.asarray(wi, np.float32).tobytes(), slabs.device)
    out = torch.empty_like(slabs)
    launch('wiener_tile_core', slabs.device, slabs, out, sig2.contiguous(), windows, k, g,
           hh // k, ww // k, sig2.numel())
    return out


def rdft2_basis(k: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Real 2-D DFT as analysis (2R, K^2) and synthesis (2R, K^2) matrices
    over one representative of each conjugate frequency pair; the sine rows
    of the self-conjugate bins are zero."""
    coords = np.arange(k)
    xx, yy = np.meshgrid(coords, coords, indexing='ij')
    flat_x = xx.reshape(-1)
    flat_y = yy.reshape(-1)
    reps, self_conj = [], []
    for u in range(k):
        for v in range(k):
            pu, pv = (k - u) % k, (k - v) % k
            if (u, v) <= (pu, pv):
                reps.append((u, v))
                self_conj.append((u, v) == (pu, pv))
    r = len(reps)
    ang = np.zeros((r, k * k), dtype=np.float64)
    for i, (u, v) in enumerate(reps):
        ang[i] = 2.0 * np.pi * (u * flat_x + v * flat_y) / k
    cos_rows = np.cos(ang)
    sin_rows = np.sin(ang)
    sin_rows[np.asarray(self_conj)] = 0.0
    analysis = np.concatenate([cos_rows, sin_rows], axis=0)
    w = np.where(np.asarray(self_conj), 1.0, 2.0)[:, None] / (k * k)
    synthesis = np.concatenate([cos_rows * w, sin_rows * w], axis=0)
    return analysis.astype(np.float32), synthesis.astype(np.float32), r


@device_cache(maxsize=8)
def _folded(k: int, wf_bytes: bytes, wi_bytes: bytes, device: torch.device):
    wf, wi = np.frombuffer(wf_bytes, np.float32), np.frombuffer(wi_bytes, np.float32)
    analysis, synthesis, n_rep = rdft2_basis(k)
    w2f = np.outer(wf, wf).astype(np.float64)
    w2i = np.outer(wi, wi).astype(np.float64)
    ana_w = analysis.astype(np.float64) * w2f.reshape(1, -1)
    ana_aug = np.concatenate([ana_w, np.full((1, k * k), 1.0 / (k * k))], axis=0)
    syn_w = synthesis.astype(np.float64) * w2i.reshape(1, -1)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    return (t(ana_aug).reshape(-1, k, k), t(syn_w).reshape(-1, k, k), t(ana_w.sum(axis=1)),
            t(w2f * w2i), n_rep)


def folded_bases(k: int, wf: np.ndarray, wi: np.ndarray, device: torch.device):
    """The rDFT bases with the windows and the tile mean folded in:
        A @ ((t - m) * wf2) = (A * wf2) @ t - m * (A @ wf2),
    the mean taken by an appended 1/K^2 row, and
        (Syn^T @ s + m * wf2) * wi2 = (Syn * wi2)^T @ s + m * (wf2 * wi2).
    Returns (ana3 (2R+1, K, K), syn3 (2R, K, K), a0 (2R,), mc (K, K), R)."""
    return _folded(k, np.asarray(wf, np.float32).tobytes(), np.asarray(wi, np.float32).tobytes(),
                   torch.device(device))


def wiener_tile_core_plain(slabs: torch.Tensor, sig2: torch.Tensor, wf: np.ndarray,
                           wi: np.ndarray, *, k: int) -> torch.Tensor:
    """Plain PyTorch version: the JAX package's stacked folded-rDFT einsums
    (tpu_darktable/ops/wiener.py, the tile-domain branch), in true float32."""
    _check(slabs, sig2, wf, wi, k)
    if slabs.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    g, hh, ww = slabs.shape
    ana3, syn3, a0, mc, n_rep = folded_bases(k, wf, wi, slabs.device)
    tiles = slabs.reshape(g, hh // k, k, ww // k, k)
    raw = torch.einsum('ruv,gaubv->gabr', ana3, tiles)
    mean = raw[..., -1:]
    spec = raw[..., :-1] - mean * a0
    del raw
    a_part = spec[..., :n_rep]
    b_part = spec[..., n_rep:]
    power = a_part * a_part + b_part * b_part + _EPS
    s2 = sig2.repeat_interleave(g // sig2.numel())[:, None, None, None]
    gain = torch.clamp(power - s2, min=0.0) / power
    del power
    spec = torch.cat([a_part * gain, b_part * gain], dim=-1)
    del gain, a_part, b_part
    y = torch.einsum('ruv,gabr->gaubv', syn3, spec)
    return (y + mean[:, :, None, :, :] * mc[None, None, :, None, :]).reshape(g, hh, ww)


__all__ = ['folded_bases', 'rdft2_basis', 'wiener_tile_core', 'wiener_tile_core_plain']
