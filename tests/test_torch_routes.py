"""The Wiener tile-core route (the pipeline's with denoise_f16 off) and the fused bilateral
detail term against the JAX package, on the CPU (where the wrappers run
their plain versions): the tile-domain route against JAX's Pallas tile core
(interpret mode) and its stacked einsum branch; `kernels.bilateral_fused`
through its wrapper against JAX's fused kernel (interpret mode) and JAX's
fast path; and which route the `Wiener` class takes.
"""

import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_darktable.kernels.bilateral_fused import bilateral_fused as j_fused
from tpu_darktable.ops import bilateral as jbil
from tpu_darktable.ops import wiener as jwiener

from tpu_darktable_torch import denoise as tdenoise
from tpu_darktable_torch import kernels
from tpu_darktable_torch.kernels.bilateral_fused import bilateral_fused, bilateral_fused_plain
from tpu_darktable_torch.kernels.wiener_core import (folded_bases, wiener_tile_core,
                                                     wiener_tile_core_plain)
from tpu_darktable_torch.ops import bilateral as tbil
from tpu_darktable_torch.ops import wiener as twiener

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- wiener_tile_core / wiener_denoise(use_separable=False) ----

@pytest.mark.parametrize('k,ov', [(16, 2), (16, 4), (16, 8), (32, 2), (32, 4), (32, 8)])
@pytest.mark.parametrize('c', [3, 1])
def test_wiener_tile_route_vs_jax(rng, c, k, ov):
    """(96, 128, C): the tile-domain route against JAX's Pallas tile core
    in interpret mode and against its stacked einsum branch, atol 1e-4 (the
    bar of the JAX package's own Pallas-vs-XLA test: bf16x3 products there,
    float32 sums in another order here).  Frames too small for the
    reflect-pad fast path (K = 32) take the gather path in both packages."""
    img = rng.random((96, 128, c)).astype(np.float32)
    sig = [0.05, 0.03, 0.04][:c]
    out = twiener.wiener_denoise(_t(img), sig, k, ov, use_separable=False).numpy()
    ref_pallas = np.asarray(jwiener.wiener_denoise(jnp.asarray(img), sig, k, ov, use_pallas=True,
                                                   _pallas_interpret=True))
    ref_einsum = np.asarray(jwiener.wiener_denoise(jnp.asarray(img), sig, k, ov,
                                                   use_separable=False))
    np.testing.assert_allclose(out, ref_pallas, atol=1e-4)
    np.testing.assert_allclose(out, ref_einsum, atol=1e-4)


@pytest.mark.parametrize('c', [3, 1])
def test_wiener_tile_route_fast_path_k32(rng, c):
    """(256, 320, C) at K = 32, ov = 4 takes the reflect-pad fast path, so
    the slabs go through kernels/wiener_core.py: against JAX's Pallas route
    (1e-4) and the port's separable route (1e-4)."""
    img = rng.random((256, 320, c)).astype(np.float32)
    sig = [0.05, 0.03, 0.04][:c]
    out = twiener.wiener_denoise(_t(img), sig, 32, 4, use_separable=False).numpy()
    ref = np.asarray(jwiener.wiener_denoise(jnp.asarray(img), sig, 32, 4, use_pallas=True,
                                            _pallas_interpret=True))
    np.testing.assert_allclose(out, ref, atol=1e-4)
    sep = twiener.wiener_denoise(_t(img), sig, 32, 4).numpy()
    np.testing.assert_allclose(out, sep, atol=1e-4)


def test_wiener_tile_route_reaches_the_core(rng, monkeypatch):
    """use_separable=False on a fast-path frame calls kernels.wiener_core
    once with (C ov^2, n_ty K, n_tx K) slabs and per-channel sig2; the
    default route does not call it."""
    seen = []
    real = twiener.wiener_tile_core

    def spy(slabs, sig2, wf, wi, *, k):
        seen.append((tuple(slabs.shape), tuple(sig2.shape), k))
        return real(slabs, sig2, wf, wi, k=k)

    monkeypatch.setattr(twiener, 'wiener_tile_core', spy)
    img = _t(rng.random((96, 128, 3)).astype(np.float32))
    twiener.wiener_denoise(img, 0.05, 16, 4)
    assert seen == []
    twiener.wiener_denoise(img, 0.05, 16, 4, use_separable=False)
    # grid_h = (96 + 16 + 3) // 4 + 4 = 32 -> n_ty 8; grid_w = 40 -> n_tx 10
    assert seen == [((48, 128, 160), (3,), 16)]
    assert kernels.launches['wiener_tile_core'] == 0   # CPU: the plain version, no launch


def test_wiener_tile_core_plain_is_jax_tile_core(rng):
    """The plain version on spatial slabs == JAX's Pallas tile core
    (interpret) on the same tiles flattened, 1e-5 (bf16x3 against float32)."""
    from tpu_darktable.kernels.wiener_core import wiener_tile_core as j_core

    k, g, n_ty, n_tx = 16, 4, 2, 3
    x = rng.random((g, n_ty * k, n_tx * k)).astype(np.float32)
    sig2 = np.array([0.002, 0.004], np.float32)
    wf, wi = twiener._gaussian_window(k, 0.3), twiener._gaussian_window(k, 0.25)
    out = wiener_tile_core(_t(x), _t(sig2), wf, wi, k=k).numpy()
    ana3, syn3, a0, mc, n_rep = folded_bases(k, wf, wi, 'cpu')
    tiles = x.reshape(g, n_ty, k, n_tx, k).transpose(0, 1, 3, 2, 4).reshape(g * n_ty, n_tx, k * k)
    ref = np.asarray(j_core(jnp.asarray(tiles), jnp.asarray(ana3.reshape(-1, k * k).numpy().T),
                            jnp.asarray(syn3.reshape(-1, k * k).numpy()),
                            jnp.asarray(a0.numpy()[None]), jnp.asarray(mc.reshape(1, -1).numpy()),
                            jnp.asarray(np.repeat(sig2, 2 * n_ty)), n_rep=n_rep, interpret=True))
    ref = ref.reshape(g, n_ty, n_tx, k, k).transpose(0, 1, 3, 2, 4).reshape(x.shape)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_wiener_core_wrapper_checks():
    wf = twiener._gaussian_window(16, 0.3)
    s2 = torch.zeros(1)
    with pytest.raises(RuntimeError):
        wiener_tile_core(torch.zeros(2, 32, 32, dtype=torch.float64), s2, wf, wf, k=16)
    with pytest.raises(ValueError):
        wiener_tile_core(torch.zeros(2, 32, 40), s2, wf, wf, k=16)
    with pytest.raises(ValueError):
        wiener_tile_core(torch.zeros(2, 32, 32), s2, wf, wf, k=8)
    with pytest.raises(RuntimeError):
        wiener_tile_core(torch.zeros(4, 32, 32), torch.zeros(3), wf, wf, k=16)
    with pytest.raises(RuntimeError):
        wiener_tile_core_plain(torch.zeros(2, 32, 64)[:, :, ::2], s2, wf, wf, k=16)


# ---- bilateral_fused ----

@pytest.mark.parametrize('h,w,s,sr', [(128, 192, 2, 0.2), (128, 256, 2, 0.1)])
def test_bilateral_fused_plain_vs_pallas_interpret(rng, h, w, s, sr):
    """Against JAX's fused kernel in interpret mode: 1e-5 (same formula,
    another assembly order).  The plain version is bilateral_band's chain,
    so a comparison with that would hold a function against itself."""
    lum = (rng.random((h, w)) * 0.95).astype(np.float32)
    _, _, gz = jbil.compute_grid_size(w, h, float(s), sr)
    ref = np.asarray(j_fused(jnp.asarray(lum), s=s, gz=gz, sigma_r=float(sr), bg=16,
                             interpret=True))
    out = bilateral_fused(_t(lum), s=s, gz=gz, sigma_r=float(sr))
    assert np.abs(out.numpy() - ref).max() < 1e-5


def test_bilateral_fused_gaussian_z_vs_pallas_interpret(rng):
    lum = (rng.random((64, 96)) * 0.95).astype(np.float32)
    ref = np.asarray(j_fused(jnp.asarray(lum), s=2, gz=6, sigma_r=0.2, z_mode='gaussian', bg=16,
                             interpret=True))
    out = bilateral_fused_plain(_t(lum), s=2, gz=6, sigma_r=0.2, z_mode='gaussian').numpy()
    assert np.abs(out - ref).max() < 1e-5


@pytest.mark.parametrize('h,w,s,sr', [(96, 128, 2, 0.2), (64, 128, 8, 0.2)])
def test_bilateral_fused_wrapper_vs_jax_fast_path(rng, h, w, s, sr):
    """kernels.bilateral_fused through its wrapper, as the detail term of
    the fast path, against the JAX fast path (2e-6, the bar the port's
    bilateral_process is held to) and equal to bilateral_process, which
    calls kernels.bilateral_band for the same function."""
    lum = (rng.random((h, w)) * 0.9).astype(np.float32)
    _, _, gz = jbil.compute_grid_size(w, h, float(s), sr)
    ref = np.asarray(jbil.bilateral_process(jnp.asarray(lum), float(s), sr, 0.4,
                                            _use_pallas_blur=False))
    l_diff = bilateral_fused(_t(lum), s=s, gz=gz, sigma_r=float(sr))
    out = torch.clamp(_t(lum) + (-0.4 * sr * 4.0) * l_diff, min=0.0)
    assert np.abs(out.numpy() - ref).max() <= 2e-6
    assert torch.equal(out, tbil.bilateral_process(_t(lum), float(s), sr, 0.4))
    assert kernels.launches['bilateral_fused'] == 0   # CPU: the plain version, no launch


def test_bilateral_process_has_no_kernel_switch(rng, monkeypatch):
    """The fast path calls kernels.bilateral_band once; a geometry off it
    (3 does not divide 128) takes the general path and never calls it."""
    calls = []
    real = tbil.bilateral_band
    monkeypatch.setattr(tbil, 'bilateral_band', lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    lum = _t((rng.random((96, 128)) * 0.9).astype(np.float32))
    tbil.bilateral_process(lum, 3.0, 0.2, 0.4)
    assert calls == []
    tbil.bilateral_process(lum, 2.0, 0.2, 0.4)
    assert calls == [dict(s=2, gz=6, sigma_r=0.2)]
    assert list(inspect.signature(tbil.bilateral_process).parameters) == [
        'luminance', 'sigma_s', 'sigma_r', 'detail']


@pytest.mark.parametrize('store,core_calls', [(None, 1), (torch.float16, 0)])
def test_wiener_class_route(rng, monkeypatch, store, core_calls):
    """Built without a storage dtype the Wiener class takes the tile-core
    route (nothing to store); with one, the separable einsums, where the
    storage lives.  Either way within 1e-3 of the JAX class."""
    import tpu_darktable as td

    seen = []
    real = twiener.wiener_tile_core
    monkeypatch.setattr(twiener, 'wiener_tile_core',
                        lambda *a, **kw: seen.append(1) or real(*a, **kw))
    img = rng.random((96, 128, 3)).astype(np.float32)
    kw = {} if store is None else dict(spectral_dtype=store, storage_dtype=store)
    out = tdenoise.Wiener('cpu', (128, 96), **kw).process(_t(img), 0.05)
    assert len(seen) == core_calls
    ref = np.asarray(td.Wiener(None, (128, 96)).process(jnp.asarray(img), 0.05))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3)


def test_bilateral_fused_wrapper_checks():
    with pytest.raises(RuntimeError):
        bilateral_fused(torch.zeros(8, 8, 1), s=2, gz=6, sigma_r=0.2)
    with pytest.raises(ValueError):
        bilateral_fused(torch.zeros(9, 8), s=2, gz=6, sigma_r=0.2)
    with pytest.raises(ValueError):
        bilateral_fused(torch.zeros(8, 8), s=2, gz=1, sigma_r=0.2)
    with pytest.raises(ValueError):
        bilateral_fused(torch.zeros(8, 8), s=2, gz=6, sigma_r=0.2, z_mode='box')
