"""The port's ops against the JAX package, on the CPU.

Each test feeds the same numpy arrays (from the `rng` seed) to the JAX
function and to its counterpart in tpu_darktable_torch (device='cpu', so
every kernel runs its plain version).  Tolerances are stated per test.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_darktable.ops import bayer as jbayer
from tpu_darktable.ops import color as jcolor
from tpu_darktable.ops import packed as jpacked
from tpu_darktable.ops import postprocess as jpost
from tpu_darktable.ops import rcd as jrcd
from tpu_darktable.ops import tonemap as jtone
from tpu_darktable.ops import white_balance as jwb
from tpu_darktable.ops import wiener as jwiener
from tpu_darktable.ops._stencil import median9 as jmedian9

from tpu_darktable_torch.ops import bayer as tbayer
from tpu_darktable_torch.ops import color as tcolor
from tpu_darktable_torch.ops import packed as tpacked
from tpu_darktable_torch.ops import postprocess as tpost
from tpu_darktable_torch.ops import rcd as trcd
from tpu_darktable_torch.ops import tonemap as ttone
from tpu_darktable_torch.ops import white_balance as twb
from tpu_darktable_torch.ops import wiener as twiener
from tpu_darktable_torch.ops._stencil import median9 as tmedian9

torch.set_num_threads(1)

PATTERNS = ['RGGB', 'BGGR', 'GRBG', 'GBRG']


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rgb(rng, h=48, w=64, lo=0.0, hi=1.0):
    return (lo + (hi - lo) * rng.random((h, w, 3))).astype(np.float32)


# ---- bit-exact: codec, white balance, median network ----

@pytest.mark.parametrize('ids', [False, True])
def test_decode12_and_round_trip_bit_exact(rng, ids):
    """decode12_float == JAX bit for bit on random bytes (Packed12 and the
    IDS nibble swap); encode and encode -> decode == JAX bit for bit, and
    Packed12 round-trips the 12-bit grid."""
    raw = rng.integers(0, 256, (6, 3 * 40), dtype=np.uint8)
    ref = np.asarray(jpacked.decode12_float(jnp.asarray(raw), ids_format=ids))
    out = tpacked.decode12_float(_t(raw), ids_format=ids).numpy()
    np.testing.assert_array_equal(out, ref)

    vals = (rng.integers(0, 4096, 80) / 4095.0).astype(np.float32)
    enc_t = tpacked.encode12_float(_t(vals), ids_format=ids).numpy()
    enc_j = np.asarray(jpacked.encode12_float(jnp.asarray(vals), ids_format=ids))
    np.testing.assert_array_equal(enc_t, enc_j)
    back = tpacked.decode12_float(_t(enc_t), ids_format=ids).numpy()
    np.testing.assert_array_equal(back, np.asarray(jpacked.decode12_float(jnp.asarray(enc_j), ids_format=ids)))
    if not ids:  # IDS decode swaps the shared nibbles: no identity by design
        np.testing.assert_allclose(back, vals, atol=0.5 / 4095)


@pytest.mark.parametrize('ids', [False, True])
def test_encode_dispatch_vs_jax(rng, ids):
    """encode takes `dtype` and ignores it, as JAX's does; uint16 and
    float32 input encode bit for bit as JAX's; int32 raises ValueError with
    JAX's message."""
    fmt = 'Packed12_IDS' if ids else 'Packed12'
    vals = rng.integers(0, 4096, 64).astype(np.uint16)
    floats = (vals / 4095.0).astype(np.float32)
    for x in (vals, floats):
        ref = np.asarray(jpacked.encode(jnp.asarray(x), jbayer.PackedFormat[fmt], dtype=None))
        out = tpacked.encode(torch.from_numpy(x), tbayer.PackedFormat[fmt], dtype=None)
        np.testing.assert_array_equal(out.numpy(), ref)
    with pytest.raises(ValueError, match='Unsupported input dtype: ') as t_err:
        tpacked.encode(torch.from_numpy(vals.astype(np.int32)), tbayer.PackedFormat[fmt])
    with pytest.raises(ValueError, match='Unsupported input dtype: int32'):
        jpacked.encode(jnp.asarray(vals.astype(np.int32)), jbayer.PackedFormat[fmt])
    assert 'int32' in str(t_err.value)


@pytest.mark.parametrize('pattern', PATTERNS)
def test_white_balance_bit_exact(rng, pattern):
    x = rng.random((2, 10, 14)).astype(np.float32)
    gains = np.array([1.8, 1.0, 2.1], np.float32)
    ref = np.asarray(jwb.apply_white_balance(jnp.asarray(x), jnp.asarray(gains),
                                             jbayer.BayerPattern[pattern]))
    out = twb.apply_white_balance(_t(x), _t(gains), tbayer.BayerPattern[pattern]).numpy()
    np.testing.assert_array_equal(out, ref)


def test_median9_bit_exact(rng):
    planes = [rng.normal(size=(7, 9)).astype(np.float32) for _ in range(9)]
    ref = np.asarray(jmedian9([jnp.asarray(p) for p in planes]))
    out = tmedian9([_t(p) for p in planes]).numpy()
    np.testing.assert_array_equal(out, ref)


def test_enums_and_fc_match():
    for name in PATTERNS:
        assert tbayer.BayerPattern[name].value == jbayer.BayerPattern[name].value
        np.testing.assert_array_equal(tbayer.fc_tile(tbayer.BayerPattern[name]),
                                      jbayer.fc_tile(jbayer.BayerPattern[name]))
    assert {m.name: m.value for m in tbayer.PackedFormat} == \
        {m.name: m.value for m in jbayer.PackedFormat}


# ---- RCD and postprocess ----

@pytest.mark.parametrize('pattern', PATTERNS)
def test_rcd_full_path_matches_jax(rng, pattern):
    """The plain full-frame RCD (strict alias + border ladder) against
    rcd_demosaic(use_pallas=False) at atol 1e-6, at two geometries: one
    below the strip size (full-frame ladder) and one above it."""
    for h, w in [(30, 40), (64, 96)]:
        x = rng.random((h, w)).astype(np.float32)
        ref = np.asarray(jrcd.rcd_demosaic(jnp.asarray(x), jbayer.BayerPattern[pattern],
                                           use_pallas=False))
        out = trcd.rcd_demosaic(_t(x), tbayer.BayerPattern[pattern]).numpy()
        assert np.abs(out - ref).max() <= 1e-6, (h, w, np.abs(out - ref).max())


def test_rcd_non_strict_and_odd_size(rng):
    x = rng.random((64, 96)).astype(np.float32)
    ref = np.asarray(jrcd.rcd_demosaic(jnp.asarray(x), jbayer.BayerPattern.RGGB,
                                       strict_alias=False, use_pallas=False))
    out = trcd.rcd_demosaic(_t(x), tbayer.BayerPattern.RGGB, strict_alias=False).numpy()
    assert np.abs(out - ref).max() <= 1e-6
    with pytest.raises(ValueError):
        trcd.rcd_demosaic(torch.zeros(63, 96), tbayer.BayerPattern.RGGB)


@pytest.mark.parametrize('n_passes', [1, 3])
def test_color_smoothing_bit_exact_vs_per_pass(rng, n_passes):
    """Port colour smoothing (diff recurrence, plain version on the CPU) ==
    JAX's per-pass path bit for bit."""
    rgb = _rgb(rng, 30, 44) - 0.1
    ref = np.asarray(jpost.color_smoothing(jnp.asarray(rgb), n_passes, use_pallas=False))
    out = tpost.color_smoothing(_t(rgb), n_passes).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize('n_passes', [1, 3])
def test_color_smoothing_pass_matches_jax(rng, n_passes):
    """N calls of color_smoothing_pass equal N calls of JAX's bit for bit,
    and equal color_smoothing(rgb, N): the kernel renews its zero fill every
    pass.  Negative inputs included."""
    rgb = (-0.2 + 1.2 * rng.random((40, 52, 3))).astype(np.float32)
    j, t = jnp.asarray(rgb), _t(rgb)
    for _ in range(n_passes):
        j, t = jpost.color_smoothing_pass(j), tpost.color_smoothing_pass(t)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert torch.equal(t, tpost.color_smoothing(_t(rgb), n_passes))


def test_postprocess_exports_median9(rng):
    """median9 is importable from ops.postprocess, as in the JAX package, and
    is the port's one median network; the modules' __all__ agree."""
    assert tpost.median9 is tmedian9
    planes = [rng.normal(size=(5, 6)).astype(np.float32) for _ in range(9)]
    np.testing.assert_array_equal(tpost.median9([_t(p) for p in planes]).numpy(),
                                  np.asarray(jpost.median9([jnp.asarray(p) for p in planes])))
    assert tpost.__all__ == jpost.__all__


@pytest.mark.parametrize('pattern', PATTERNS)
def test_postprocess_green_eq_global(rng, pattern):
    """3 smoothing passes + global green eq; the ratio is a sum, summed in
    another order by torch: atol 1e-6."""
    rgb = _rgb(rng, 32, 40)
    ref = np.asarray(jpost.postprocess(jnp.asarray(rgb), jbayer.BayerPattern[pattern],
                                       color_smoothing_passes=3, green_eq_global_enabled=True))
    out = tpost.postprocess(_t(rgb), tbayer.BayerPattern[pattern], color_smoothing_passes=3,
                            green_eq_global_enabled=True).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


# ---- colour helpers and tonemaps ----

def test_color_helpers_match(rng):
    """LAB, clipped-L LAB, luminance write-back, gray, 3x3: atol 1e-6 in
    float (cbrt is a float pow(1/3) here, 1 ulp from XLA's cbrt on ~1.5% of
    inputs).  Vibrance: atol 5e-6 - its last 3x3 cancels near black and
    the 12.92 sRGB slope amplifies that ulp (observed 1.5e-6); its uint8
    result is held to 1 count in test_tonemaps_uint8."""
    rgb = _rgb(rng, 24, 32, -0.1, 1.2)
    j, t = jnp.asarray(rgb), _t(rgb)
    np.testing.assert_allclose(tcolor.rgb_to_lab(t).numpy(), np.asarray(jcolor.rgb_to_lab(j)), atol=1e-6)
    lab_t, l_t = tcolor.rgb_to_lab_with_clipped_l(t)
    lab_j, l_j = jcolor.rgb_to_lab_with_clipped_l(j)
    np.testing.assert_allclose(lab_t.numpy(), np.asarray(lab_j), atol=1e-6)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), atol=1e-6)
    new_l = rng.random((24, 32)).astype(np.float32)
    np.testing.assert_allclose(
        tcolor.lab_modify_luminance(lab_t, _t(new_l)).numpy(),
        np.asarray(jcolor.lab_modify_luminance(lab_j, jnp.asarray(new_l))), atol=1e-6)
    pos = np.clip(rgb, 0, 1)
    np.testing.assert_allclose(tcolor.modify_vibrance(_t(pos), 0.5).numpy(),
                               np.asarray(jcolor.modify_vibrance(jnp.asarray(pos), 0.5)), atol=5e-6)
    np.testing.assert_allclose(tcolor.rgb_to_gray(t).numpy(), np.asarray(jcolor.rgb_to_gray(j)), atol=1e-6)
    mat = rng.normal(size=(3, 3)).astype(np.float32)
    np.testing.assert_allclose(tcolor.color_transform_3x3(t, mat).numpy(),
                               np.asarray(jcolor.color_transform_3x3(j, mat)), atol=1e-6)


def test_bounds_metrics_adaptation(rng):
    """Strided bounds exact; metrics are sums in another order: atol 1e-6."""
    batch = _rgb(rng, 40, 48)[None].repeat(2, 0) * np.float32(1.05)
    np.testing.assert_array_equal(ttone.compute_image_bounds(_t(batch)).numpy(),
                                  np.asarray(jtone.compute_image_bounds(jnp.asarray(batch))))
    mt = ttone.compute_image_metrics(_t(batch))
    mj = jtone.compute_image_metrics(jnp.asarray(batch))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-6)
    rgb = _rgb(rng, 8, 8)
    np.testing.assert_allclose(
        ttone._compute_adaptation(mt, _t(rgb), 0.8, 2.0).numpy(),
        np.asarray(jtone._compute_adaptation(mj, jnp.asarray(rgb), 0.8, 2.0)), atol=1e-6)


@pytest.mark.parametrize('kind', ['adaptive_aces', 'aces', 'reinhard'])
def test_tonemaps_uint8(rng, kind):
    """Tonemaps end in uint8: at most 1 count apart."""
    rgb = _rgb(rng, 32, 40, -0.05, 1.1)
    metrics = np.array([-1.2, 0.4, 0.45, 0.4, 0.38], np.float32)
    jp = jtone.TonemapParameters(1.5, 2.0, 0.8, 0.5)
    tp = ttone.TonemapParameters(1.5, 2.0, 0.8, 0.5)
    j, t = jnp.asarray(rgb), _t(rgb)
    if kind == 'adaptive_aces':
        ref, out = jtone.aces_tonemap(j, jp, jnp.asarray(metrics)), ttone.aces_tonemap(t, tp, _t(metrics))
    elif kind == 'aces':
        ref, out = jtone.aces_tonemap(j, jp), ttone.aces_tonemap(t, tp)
    else:
        ref, out = (jtone.reinhard_tonemap(j, jnp.asarray(metrics), jp),
                    ttone.reinhard_tonemap(t, _t(metrics), tp))
    d = np.abs(np.asarray(ref).astype(int) - out.numpy().astype(int))
    assert out.dtype == torch.uint8 and d.max() <= 1


# ---- Wiener ----

@pytest.mark.parametrize('overlap', [2, 4, 8])
def test_wiener_separable_f32(rng, overlap):
    """The separable fast path (K=32) in float32: atol 1e-5 (observed
    2.4e-7 / 1.8e-7 / 1.8e-7 at overlap 2 / 4 / 8: einsum summation order)."""
    img = rng.random((136, 152, 1)).astype(np.float32)
    ref = np.asarray(jwiener.wiener_denoise(jnp.asarray(img), 0.05, 32, overlap))
    out = twiener.wiener_denoise(_t(img), 0.05, 32, overlap).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_wiener_f16_storage(rng):
    """f16 storage of the intermediates: within the 1e-3 bound of the JAX
    package's own f16 test (tests/test_wiener.py::test_f16_storage_error_budget);
    observed 0 here (the f16 roundings of both land on the same values)."""
    img = rng.random((136, 152, 1)).astype(np.float32)
    ref = np.asarray(jwiener.wiener_denoise(jnp.asarray(img), 0.075, 32, 4,
                                            spectral_dtype=jnp.float16, storage_dtype=jnp.float16))
    out = twiener.wiener_denoise(_t(img), 0.075, 32, 4, spectral_dtype=torch.float16,
                                 storage_dtype=torch.float16).numpy()
    assert np.abs(out - ref).max() < 1e-3


def test_wiener_small_frame_gather_path(rng):
    """Frames below the reflect-pad size take the per-coset gather path:
    atol 1e-5 (observed 4.8e-7)."""
    img = rng.random((64, 96, 1)).astype(np.float32)
    ref = np.asarray(jwiener.wiener_denoise(jnp.asarray(img), 0.075, 32, 4))
    out = twiener.wiener_denoise(_t(img), 0.075, 32, 4).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        twiener.wiener_denoise(_t(img), 0.075, 32, 3)
