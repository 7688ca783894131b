# Frozen copy of tpu_darktable_torch/ops/wiener.py (plain PyTorch paths only), kept
# as the benchmark's reference; it imports nothing of the measured package.
"""Overlapped-tile spectral Wiener denoise (counterpart of
tpu_darktable/ops/wiener.py:33-302 and 305-594).

The overlapping K x K tiles regroup into overlap^2 non-overlapping cosets;
the windowed 2-D DFT is separable, so analysis and synthesis are short
einsums against bases built in numpy (`_sep_bases`), and the overlap-add is
a sum of padded cosets: no scatters, no atomics.  The einsums go to
torch.einsum in true float32: TF32 is switched off and the float32 matmul
precision must be "highest" (TF32 has not been measured against the 1e-3
parity budget yet).

`storage_dtype` / `spectral_dtype` (float16) are STORAGE knobs: the big
intermediates are kept in float16 and upcast at the point of use; the math
stays float32.

Only the separable route is copied: the configurations take it (the
pipeline's default, `denoise_f16`, with float16 storage).  The program's
tile-domain route (`use_separable=False`) and its gather path for frames
narrower than their reflection are not.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .._device import constant_on, device_cache, to_device

_F32 = torch.float32
_EPS = 1e-15


def _require_fp32_matmul(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
        if torch.get_float32_matmul_precision() != 'highest':
            raise RuntimeError(
                'wiener_denoise needs torch.get_float32_matmul_precision() == "highest": '
                'TF32 DFT products are not validated against the 1e-3 budget')


def _gaussian_window(k: int, weight: float) -> np.ndarray:
    """1-D Gaussian window, L2-normalized."""
    half = k / 2.0
    scale = weight * half * half
    r = np.linspace(-half + 0.5, half - 0.5, k, dtype=np.float64)
    vals = np.exp(-(r * r) / scale)
    vals = vals / np.sqrt(np.sum(vals * vals))
    return vals.astype(np.float32)


@device_cache(maxsize=32)
def _weight_sum_1d(n_pad: int, grid_n: int, k: int, stride: int, fft_scale: float,
                   interp_scale: float, dev: torch.device) -> torch.Tensor:
    """The overlap-add weight along one axis of the padded frame: the sum of
    wf * wi over the tiles that cover each position.  It depends on the
    geometry alone, so it is built once and kept on the device (the pipeline
    calls the Wiener stage every frame)."""
    wprod = _gaussian_window(k, fft_scale) * _gaussian_window(k, interp_scale)
    m = np.zeros(n_pad, dtype=np.float64)
    for g in range(grid_n):
        o = g * stride
        end = min(o + k, n_pad)
        if end > o:
            m[o:end] += wprod[: end - o]
    return torch.as_tensor(m.astype(np.float32), device=dev)


def _sep_bases(k: int, wf: np.ndarray, wi: np.ndarray) -> dict:
    """Bases of the separable windowed-DFT formulation (numpy float64,
    cast to float32); see the JAX package's _sep_bases for the derivation."""
    u_count = k // 2 + 1
    i = np.arange(k)
    u = np.arange(u_count)
    ang_u = 2.0 * np.pi * np.outer(i, u) / k
    b_row = np.concatenate(
        [np.cos(ang_u) * wf[:, None], np.sin(ang_u) * wf[:, None], np.ones((k, 1))], axis=1)
    v = np.arange(k)
    ang_v = 2.0 * np.pi * np.outer(v, i) / k
    cos_c = (np.cos(ang_v) * wf[None, :]).T
    sin_c = (np.sin(ang_v) * wf[None, :]).T
    cos_s = np.cos(ang_v) * wi[None, :]
    sin_s = np.sin(ang_v) * wi[None, :]
    b_reim = np.block([[cos_c, -sin_c], [-sin_c, -cos_c]])
    w_hat = np.fft.fft2(np.outer(wf, wf))[:u_count, :]
    rho = np.where((u == 0) | (u == k // 2), 1.0, 2.0) / (k * k)
    row_cos = (np.cos(ang_u) * wi[:, None] * rho[None, :]).T
    row_sin = (-np.sin(ang_u) * wi[:, None] * rho[None, :]).T
    b_row_syn = np.concatenate([row_cos, row_sin, (wf * wi)[None, :]], axis=0)
    cs_s = np.block([[cos_s, sin_s], [-sin_s, cos_s]])
    perm = np.empty(2 * k, dtype=np.int64)
    perm[0::2] = np.arange(k)
    perm[1::2] = np.arange(k) + k
    f32 = lambda a: a.astype(np.float32)
    return dict(
        u_count=u_count,
        b_row=f32(b_row),
        b_reim=f32(b_reim),
        cs_s2=f32(cs_s[:, perm]),
        w_hat_re=f32(w_hat.real.copy()),
        w_hat_im=f32(w_hat.imag.copy()),
        b_row_syn_spec=f32(b_row_syn[:-1]),
        wfwi=f32(wf * wi),
    )


@device_cache(maxsize=16)
def _sep_bases_on(k: int, wf_bytes: bytes, wi_bytes: bytes, dev: torch.device) -> dict:
    """_sep_bases as tensors on `dev`, built once per geometry and device
    and copied through pinned memory, so that the pipeline's per-frame
    Wiener stage does not make the host wait for the card."""
    wf, wi = np.frombuffer(wf_bytes, np.float32), np.frombuffer(wi_bytes, np.float32)
    return {n: (to_device(a, dev) if isinstance(a, np.ndarray) else a)
            for n, a in _sep_bases(k, wf, wi).items()}


def _wiener_separable(xr, h, w, c, k, ov, sigmas, wf, wi, mrow, mcol,
                      spectral_dtype=None, storage_dtype=None):
    """Separable-DFT Wiener core on the reflect-padded (Hp, Wp, C) image."""
    dev = xr.device
    stride = k // ov
    grid_h = (h + k + stride - 1) // stride + ov
    grid_w = (w + k + stride - 1) // stride + ov
    n_ty = -(-grid_h // ov)
    n_tx = -(-grid_w // ov)
    bb = _sep_bases_on(k, np.asarray(wf, np.float32).tobytes(),
                       np.asarray(wi, np.float32).tobytes(), dev)
    uc = bb['u_count']
    acc_h = (ov - 1) * stride + n_ty * k
    acc_w = (ov - 1) * stride + n_tx * k
    assert xr.shape[0] >= acc_h and xr.shape[1] >= acc_w, (xr.shape, acc_h, acc_w)
    sig2 = (sigmas * sigmas).reshape(1, 1, 1, 1, 1, -1)

    store = lambda t, dt: t if dt is None else t.to(dt)
    use = lambda t: t if t.dtype == _F32 else t.to(_F32)

    # ---- row analysis ----
    win = torch.stack([xr[p * stride : p * stride + n_ty * k, :acc_w] for p in range(ov)]
                      ).reshape(ov, n_ty, k, acc_w, c)
    rout = store(torch.einsum('ptkwc,kf->ptwfc', win, bb['b_row']), storage_dtype)
    del win

    # ---- column analysis: packed re|im basis ----
    cwin = torch.stack([rout[:, :, q * stride : q * stride + n_tx * k] for q in range(ov)],
                       dim=2).reshape(ov, n_ty, ov, n_tx, k, 2 * uc + 1, c)
    del rout
    g_all = torch.cat([cwin[..., :uc, :], cwin[..., uc : 2 * uc, :]], dim=4)
    mean = use(cwin[..., 2 * uc, :]).sum(dim=4) / (k * k)
    del cwin
    reim = store(torch.einsum('ptqxjuc,jv->ptqxvuc', use(g_all), bb['b_reim']), spectral_dtype)
    del g_all
    re_x = use(reim[..., :k, :, :])
    im_x = use(reim[..., k:, :, :])
    del reim

    # ---- mean-corrected spectral gain ----
    m_b = mean[:, :, :, :, None, None, :]
    w_re = bb['w_hat_re'].T[None, None, None, None, :, :, None]
    w_im = bb['w_hat_im'].T[None, None, None, None, :, :, None]
    re_t = re_x - m_b * w_re
    im_t = im_x - m_b * w_im
    del re_x, im_x
    power = re_t * re_t + im_t * im_t + _EPS
    gain = torch.clamp(power - sig2[..., None, :], min=0.0) / power
    del power
    s_all = store(torch.cat([re_t * gain, im_t * gain], dim=4), spectral_dtype)
    del re_t, im_t, gain

    # ---- column synthesis (interleaved basis) ----
    t_all = store(torch.einsum('ptqxvfc,vm->ptqxmfc', use(s_all), bb['cs_s2'])
                  .reshape(ov, n_ty, ov, n_tx, k, 2 * uc, c), storage_dtype)
    del s_all

    # ---- column overlap-add ----
    def _pad_cols(t, q, trailing):
        pads = [0, 0] * trailing + [q * stride, acc_w - n_tx * k - q * stride]
        return F.pad(t, pads)

    cacc = sum(_pad_cols(use(t_all[:, :, q]).reshape(ov, n_ty, n_tx * k, -1, c), q, 2)
               for q in range(ov))
    del t_all
    u_col = bb['wfwi']
    mpiece = mean[..., None, :] * u_col[None, None, None, None, :, None]
    macc = sum(_pad_cols(mpiece[:, :, q].reshape(ov, n_ty, n_tx * k, c), q, 1)
               for q in range(ov))

    # ---- row synthesis + mean broadcast + row overlap-add ----
    y = store(torch.einsum('ptwfc,fk->ptkwc', cacc, bb['b_row_syn_spec']), storage_dtype)
    del cacc
    yfull = use(y) + macc[:, :, None, :, :] * u_col[None, None, :, None, None]
    del y
    out = sum(
        F.pad(yfull[p].reshape(n_ty * k, acc_w, c),
              (0, 0, 0, 0, p * stride, acc_h - n_ty * k - p * stride))
        for p in range(ov)
    )
    return _divide_by_weight(out[k : k + h, k : k + w], mrow, mcol, k)


def wiener_denoise(image: torch.Tensor, noise_sigmas, tile_size: int = 32,
                   overlap_factor: int = 4, fft_scale: float = 0.3,
                   interp_scale: float = 0.3, use_separable: bool = True,
                   spectral_dtype=None, storage_dtype=None) -> torch.Tensor:
    """Wiener-filter an (H, W) or (H, W, C) image, C in {1, 3}.

    Args:
        noise_sigmas: scalar or (C,) per-channel noise sigma.
        tile_size: K in {16, 32}.
        overlap_factor: 2, 4 or 8; tile stride = K / overlap_factor.
        use_separable: must be True: the separable row/column einsum route
            is the only one copied.
        spectral_dtype / storage_dtype: optional float16 storage of the
            spectral / row and tile intermediates.

    Returns:
        (H, W, C) float32.
    """
    x = image.to(_F32)
    if x.ndim == 2:
        x = x[..., None]
    if x.ndim != 3 or x.shape[-1] not in (1, 3):
        raise RuntimeError(
            f'image must be (H, W) or (H, W, C) with C in {{1, 3}}, got shape {tuple(image.shape)}')
    h, w, c = x.shape
    k = tile_size
    if k not in (16, 32):
        raise ValueError(f'tile_size must be 16 or 32, got {k}')
    if overlap_factor not in (2, 4, 8):
        raise ValueError(f'overlap_factor must be 2, 4, or 8, got {overlap_factor}')
    dev = x.device
    _require_fp32_matmul(dev)
    sigmas = (to_device(noise_sigmas, dev, _F32) if isinstance(noise_sigmas, torch.Tensor)
              else constant_on(noise_sigmas, dev, _F32)).reshape(-1).expand(c)

    ov = overlap_factor
    stride = k // ov
    h_pad, w_pad = h + 2 * k, w + 2 * k
    grid_h = (h + k + stride - 1) // stride + ov
    grid_w = (w + k + stride - 1) // stride + ov
    wf = _gaussian_window(k, fft_scale)
    wi = _gaussian_window(k, interp_scale)
    mrow = _weight_sum_1d(h_pad, grid_h, k, stride, fft_scale, interp_scale, dev)
    mcol = _weight_sum_1d(w_pad, grid_w, k, stride, fft_scale, interp_scale, dev)

    padded = _reflect_pad(x, k, ov)
    if not use_separable or padded is None:
        raise NotImplementedError('the reference copies the separable route of frames wider '
                                  'than their reflection only')
    xr, _, _ = padded
    return _wiener_separable(xr, h, w, c, k, ov, sigmas, wf, wi, mrow, mcol,
                             spectral_dtype=spectral_dtype, storage_dtype=storage_dtype)


def _divide_by_weight(acc: torch.Tensor, mrow: torch.Tensor, mcol: torch.Tensor,
                      k: int) -> torch.Tensor:
    """The overlap-added (H, W, C) crop over its summed window weights."""
    h, w, _ = acc.shape
    return acc / ((mrow[k : k + h, None] * mcol[None, k : k + w])[..., None] + _EPS)


def _reflect_pad(x: torch.Tensor, k: int, ov: int):
    """Reflect-pad an (H, W, C) image once so that every coset slab is a
    contiguous slice: K rows above (mirror without the edge), and below
    enough for the maximal coset's n_ty tiles (mirror with the edge), the
    reference's asymmetric reflection.  Returns (xr, n_ty, n_tx), or None
    for a frame narrower than its reflection (the gather path's case)."""
    h, w, _ = x.shape
    stride = k // ov
    n_ty = -(-((h + k + stride - 1) // stride + ov) // ov)
    n_tx = -(-((w + k + stride - 1) // stride + ov) // ov)
    pad_hi_r = max(2 * k, n_ty * k - stride - h)
    pad_hi_c = max(2 * k, n_tx * k - stride - w)
    if not (h > pad_hi_r and w > pad_hi_c):
        return None
    xr = torch.cat([x[1 : k + 1].flip(0), x, x.flip(0)[:pad_hi_r]], dim=0)
    xr = torch.cat([xr[:, 1 : k + 1].flip(1), xr, xr.flip(1)[:, :pad_hi_c]], dim=1)
    return xr, n_ty, n_tx


__all__ = ['wiener_denoise']
