"""Card-only checks of the port's kernels, importing nothing of JAX so that
they also run where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(tests/conftest.py imports JAX; nothing here needs it).  Each new kernel
against its plain version on a CUDA tensor, at small and ragged sizes
(tiles that do not divide the frame), and the launch counts.  Without a
card every test skips with its reason.
"""

import numpy as np
import pytest
import torch

from tpu_darktable_torch import kernels
from tpu_darktable_torch.denoise import Wiener
from tpu_darktable_torch.kernels.bilateral_band import bilateral_band, bilateral_band_plain
from tpu_darktable_torch.kernels.bilateral_fused import bilateral_fused, bilateral_fused_plain
from tpu_darktable_torch.kernels.color_smooth import color_smooth_diffs, color_smooth_diffs_plain
from tpu_darktable_torch.kernels.grid_blur import grid_blur_xyz, grid_blur_xyz_plain
from tpu_darktable_torch.kernels.nlm import nlm_core, nlm_core_plain
from tpu_darktable_torch.kernels.rcd_interior import RING, rcd_interior, rcd_interior_plain
from tpu_darktable_torch.kernels.wavelet import wavelet_core, wavelet_core_plain
from tpu_darktable_torch.kernels.wiener_core import wiener_tile_core, wiener_tile_core_plain
from tpu_darktable_torch.ops import bilateral, nlm, wiener
from tpu_darktable_torch.ops.bayer import BayerPattern, site_parities


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; chip_smoke.py runs these kernels on the card')
    return torch.device('cuda')


def _rand(seed, shape, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random(shape).astype(np.float32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(9, 101, 150), (6, 1001, 1366), (2, 33, 97), (51, 40, 64)])
@pytest.mark.parametrize('z_mode', ['derivative', 'gaussian'])
def test_grid_blur_on_card(dev, z_mode, shape):
    """Against the plain version: 1e-6 (same tap order, --fmad=false); the
    sigma_s 3 grid of a 12 MP frame, gz = 2 and gz = 51, ragged tiles."""
    grid = _rand(1, shape, dev)
    err = (grid_blur_xyz(grid, z_mode=z_mode) - grid_blur_xyz_plain(grid, z_mode=z_mode))
    assert err.abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize('h,w', [(28, 60), (134, 200), (71, 137), (3000, 4096)])
@pytest.mark.parametrize('n_passes', [1, 3, 5])
def test_color_smooth_on_card(dev, h, w, n_passes):
    """The selection median against the plain version's sorting network:
    equal (torch.equal counts -0.0 and +0.0 as equal) from one tile to a
    12 MP frame."""
    d = _rand(11, (2, h, w), dev) - 0.5
    g = _rand(12, (h, w), dev) - 0.1
    assert torch.equal(color_smooth_diffs(d, g, n_passes=n_passes),
                       color_smooth_diffs_plain(d, g, n_passes=n_passes))


@pytest.mark.cuda
@pytest.mark.parametrize('h,w', [(28, 60), (134, 200), (71, 137), (2998, 4002)])
@pytest.mark.parametrize('pattern', ['RGGB', 'BGGR', 'GRBG', 'GBRG'])
def test_rcd_interior_on_card(dev, pattern, h, w):
    """The quad cascade against its plain version, bit for bit >= RING px
    from every edge: one tile, ragged tiles, odd sizes, a ragged 12 MP frame."""
    x = _rand(3, (h, w), dev)
    rp, bp = site_parities(BayerPattern[pattern])
    r = RING
    k = rcd_interior(x, r_par=rp, b_par=bp)[:, r:-r, r:-r]
    assert torch.equal(k, rcd_interior_plain(x, r_par=rp, b_par=bp)[:, r:-r, r:-r])


@pytest.mark.cuda
@pytest.mark.parametrize('shape,levels', [
    ((3, 130, 200), 1), ((3, 130, 200), 4), ((3, 130, 200), 6),
    *[((2, 150, 200), lv) for lv in range(8)],   # inside blocks next to rim blocks, every depth
    ((1, 9, 7), 7), ((3, 64, 64), 2), ((1, 65, 129), 3), ((1, 1, 1), 2), ((1, 3, 300), 30),
    ((1, 40, 300), 6), ((2, 21, 530), 7), ((1, 20, 530), 8), ((3, 3000, 4096), 6)])
def test_wavelet_on_card(dev, shape, levels):
    """The shared-memory tile of the first levels, the one-launch levels and
    the two-pass levels, on ragged tiles and strips, narrow images and at
    full width: 1e-6."""
    x = _rand(2, shape, dev)
    thr = torch.tensor([0.15, 0.1, 0.2][:shape[0]], device=dev)
    err = wavelet_core(x, thr, levels=levels) - wavelet_core_plain(x, thr, levels=levels)
    assert err.abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize('shape,sr,pr', [
    ((3, 130, 200), 3, 1), ((1, 130, 200), 2, 2),
    # the register kernel: ragged tiles, images smaller than a tile, C = 1
    ((3, 70, 101), 3, 1), ((1, 67, 99), 3, 1), ((3, 9, 13), 3, 1), ((1, 5, 40), 3, 1),
    ((3, 33, 31), 3, 1), ((1, 1, 1), 3, 1),
    # the general kernel
    ((2, 20, 33), 1, 1), ((3, 35, 45), 2, 1), ((4, 21, 37), 3, 1), ((1, 41, 39), 3, 2),
    ((3, 6, 5), 1, 0)])
def test_nlm_on_card(dev, shape, sr, pr):
    """Against the plain version: 1e-5 (CUDA expf against torch.exp)."""
    x = _rand(3, shape, dev)
    inv_h2 = 1.0 / (0.05 * 0.05 * (2 * pr + 1) ** 2 * shape[0])
    err = (nlm_core(x, inv_h2, search_radius=sr, patch_radius=pr)
           - nlm_core_plain(x, inv_h2, search_radius=sr, patch_radius=pr))
    assert err.abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_paths_launch_their_kernels(dev):
    """On CUDA tensors the ops always launch their kernel, whatever the
    size or depth."""
    kernels.reset_launches()
    img = _rand(4, (50, 70, 3), dev)
    nlm.wavelet_denoise(img, 0.05, levels=7)
    nlm.nlm_denoise(img[..., 0], 0.05)
    lum = _rand(5, (50, 70), dev)
    bilateral.bilateral_process(lum, 3.0, 0.2, 0.4)
    bilateral.bilateral_denoise(lum, 2.5, 0.2, 0.5)
    assert kernels.launches['wavelet_core'] == 1
    assert kernels.launches['nlm_core'] == 1
    assert kernels.launches['grid_blur_xyz'] == 3
    assert kernels.launches['bilateral_band'] == 0


@pytest.mark.cuda
@pytest.mark.parametrize('h,w,s,gz,sr,z_mode', [
    (130, 200, 2, 6, 0.2, 'derivative'), (130, 200, 1, 6, 0.2, 'gaussian'),
    (144, 136, 8, 11, 0.1, 'derivative'), (70, 66, 2, 51, 0.02, 'derivative'),
    (240, 360, 120, 6, 0.2, 'derivative')])
def test_bilateral_fused_on_card(dev, h, w, s, gz, sr, z_mode):
    """Ragged tiles, a shrunk tile (gz 51) and the unstaged splat (s 120)
    against the plain version: 1e-6 (same sum order; PyTorch's CUDA division
    by a scalar multiplies by the reciprocal, the kernel divides)."""
    lum = _rand(6, (h, w), dev) * 0.95
    err = (bilateral_fused(lum, s=s, gz=gz, sigma_r=sr, z_mode=z_mode)
           - bilateral_fused_plain(lum, s=s, gz=gz, sigma_r=sr, z_mode=z_mode))
    assert err.abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize('k,shape,n_sig,offset', [
    (32, (16, 96, 160), 1, -6.0), (16, (12, 48, 80), 3, 0.0), (16, (192, 48, 80), 3, 0.0),
    (32, (3, 96, 160), 3, 0.0), (16, (1, 48, 112), 1, -6.0),   # C = 3 at K = 32; odd tile counts
    (32, (1, 32, 32), 1, 0.0), (16, (1, 16, 16), 1, -3.0),     # a slab of one tile
    (32, (16, 3072, 4160), 1, -4.0), (16, (12, 1536, 2080), 3, 0.0)])   # 4096x3000, 2048x1500
def test_wiener_core_on_card(dev, k, shape, n_sig, offset):
    """The FFT kernel against the dense folded-basis einsums: 2e-6 *
    max(1, max|x|) (sums in another order, the mean subtracted before the
    transform, not after)."""
    x = _rand(7, shape, dev) * 0.5 + offset
    sig2 = _rand(8, (n_sig,), dev) * 0.01 + 0.002
    wf, wi = wiener._gaussian_window(k, 0.3), wiener._gaussian_window(k, 0.25)
    err = (wiener_tile_core(x, sig2, wf, wi, k=k) - wiener_tile_core_plain(x, sig2, wf, wi, k=k))
    assert err.abs().max().item() <= 2e-6 * max(1.0, abs(offset) + 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize('s', [1, 2, 8])
def test_bilateral_band_on_card_equals_fused(dev, s):
    """One source behind both wrappers: equal (0) with the derivative z
    taps, one launch each, and within 1e-6 of the plain version."""
    lum = _rand(10, (240, 368), dev) * 0.95
    kernels.reset_launches()
    a = bilateral_band(lum, s=s, gz=6, sigma_r=0.2)
    b = bilateral_fused(lum, s=s, gz=6, sigma_r=0.2)
    assert torch.equal(a, b)
    assert kernels.launches['bilateral_band'] == 1 and kernels.launches['bilateral_fused'] == 1
    assert (a - bilateral_band_plain(lum, s=s, gz=6, sigma_r=0.2)).abs().max().item() <= 1e-6


@pytest.mark.cuda
def test_routes_launch_their_kernels(dev):
    """The tile-core route, the Wiener class and the bilateral fast path on
    CUDA tensors launch their kernels; the separable route launches none."""
    kernels.reset_launches()
    img = _rand(9, (96, 128, 3), dev)
    a = wiener.wiener_denoise(img, 0.05, 16, 4, use_separable=False)
    b = wiener.wiener_denoise(img, 0.05, 16, 4)
    assert (a - b).abs().max().item() <= 1e-4
    assert kernels.launches['wiener_tile_core'] == 1
    c = Wiener(dev, (128, 96), tile_size=16).process(img, 0.05)
    assert torch.equal(a, c) and kernels.launches['wiener_tile_core'] == 2
    lum = img[..., 0].contiguous()
    bilateral.bilateral_process(lum, 2.0, 0.2, 0.4)
    assert kernels.launches['bilateral_band'] == 1
    assert kernels.launches['bilateral_fused'] == 0


# ---- the LAB round trip of the luminance stages (csrc/lab.cu)

def _bits_equal(got, want, what):
    """Equal value for value (NaN where NaN, either sign of zero); else the
    differing values, each with its distance in float32 ulps."""
    g, w = got.reshape(-1), want.reshape(-1)
    off = ~((g == w) | (torch.isnan(g) & torch.isnan(w)))
    if bool(off.any()):
        idx = torch.nonzero(off)[:, 0]
        ulps = (g.view(torch.int32)[idx].long() - w.view(torch.int32)[idx].long()).abs()
        shown = ', '.join(f'[{i}] {a:.9g} vs {b:.9g} ({u} ulp)' for i, a, b, u in zip(
            idx[:20].tolist(), g[idx[:20]].tolist(), w[idx[:20]].tolist(), ulps[:20].tolist()))
        raise AssertionError(f'{what}: {idx.numel()} of {g.numel()} values differ, at most '
                             f'{int(ulps.max())} ulp: {shown}')


def _scene_stage_input(dev, w, h, n=2, seed=2**31 + 24):
    """The denoise stage's input on `n` of the benchmark's `artichoke` scenes:
    FULL's front end and the bounds normalisation, (n, h, w, 3) on the card."""
    from isp_bench import scene, spec
    import tpu_darktable_torch as tt
    from tpu_darktable_torch.pipeline.camera_settings import CameraSettings
    from tpu_darktable_torch.pipeline.image_processor import ema_bounds
    from tpu_darktable_torch.pipeline.util import normalize_image

    cam = dict(spec.config('artichoke')['camera'], image_size=[w, h])
    cs = CameraSettings.from_dict(cam)
    fn = tt.build_pipeline_fn(cs.image_processing, cs.image_size, cs.bayer_pattern,
                              cs.packed_format, cs.white_balance is not None)
    frames = torch.from_numpy(scene.frame_pool(cam, n, seed, 'cpu')).to(dev)
    wb = torch.tensor(cs.white_balance or (1.0, 1.0, 1.0), dtype=torch.float32, device=dev)
    rgb, samples = fn.stages.front(frames, wb)
    bounds = ema_bounds(samples, torch.zeros(2, device=dev), torch.ones((), device=dev))
    return normalize_image(rgb, bounds)


@pytest.mark.cuda
def test_lab_kernels_on_card_scenes(dev):
    """Both kernels against the plain chain on the card, bit for bit, on two
    4096x3000 scenes at the denoise stage's input: the split with either
    plane, a frame of the batch and the whole batch, and the merge of its
    LAB with the bilateral stage's new plane."""
    from tpu_darktable_torch.kernels.lab import (lab_merge, lab_merge_plain, lab_split,
                                                 lab_split_plain)

    x = _scene_stage_input(dev, 4096, 3000)
    for clipped_l in (True, False):
        lab, lum = lab_split(x, clipped_l=clipped_l)
        want_lab, want_lum = lab_split_plain(x, clipped_l=clipped_l)
        _bits_equal(lab, want_lab, f'lab_split LAB, clipped_l {clipped_l}')
        _bits_equal(lum, want_lum, f'lab_split plane, clipped_l {clipped_l}')
        assert lum.is_contiguous() and tuple(lum.shape) == tuple(x.shape[:-1])
        one_lab, one_lum = lab_split(x[1], clipped_l=clipped_l)
        assert torch.equal(one_lab, lab[1]) and torch.equal(one_lum, lum[1])
        new = bilateral.bilateral_process(lum[0], 2.0, 0.2, 0.4)
        _bits_equal(lab_merge(lab[0], new), lab_merge_plain(lab[0], new), 'lab_merge')


@pytest.mark.cuda
@pytest.mark.parametrize('offset', [0, 1], ids=['aligned', 'unaligned'])
def test_lab_kernels_on_card_edge_grid(dev, offset):
    """The host emulation test's edge grid (every branch threshold and its
    neighbouring floats, 0, -0, 1, NaN), on the 16-byte path and, one
    float off alignment, on the scalar one; and 1-9 pixels, for the tail:
    bit for bit with the plain chain on the card."""
    import lab_grids
    from tpu_darktable_torch.kernels.lab import (lab_merge, lab_merge_plain, lab_split,
                                                 lab_split_plain)

    def on_card(a):
        buf = torch.empty(a.size + offset, dtype=torch.float32, device=dev)
        return buf[offset:].view(a.shape).copy_(torch.from_numpy(a))

    rng = np.random.default_rng(24)
    rgb = on_card(lab_grids.edge_rgb(rng))
    for clipped_l in (True, False):
        got, want = lab_split(rgb, clipped_l=clipped_l), lab_split_plain(rgb, clipped_l=clipped_l)
        _bits_equal(got[0], want[0], f'lab_split LAB, clipped_l {clipped_l}')
        _bits_equal(got[1], want[1], f'lab_split plane, clipped_l {clipped_l}')
    lab_np, lum_np = lab_grids.edge_merge(rng, lab_split_plain(rgb, clipped_l=False)[0].cpu().numpy())
    lab, lum = on_card(lab_np), on_card(lum_np)
    _bits_equal(lab_merge(lab, lum), lab_merge_plain(lab, lum), 'lab_merge')
    for n in range(1, 10):
        x = on_card(rng.uniform(-0.1, 1.2, (n, 3)).astype(np.float32))
        got, want = lab_split(x, clipped_l=True), lab_split_plain(x, clipped_l=True)
        _bits_equal(got[0], want[0], f'lab_split LAB, {n} pixels')
        _bits_equal(got[1], want[1], f'lab_split plane, {n} pixels')
        _bits_equal(lab_merge(got[0], got[1]), lab_merge_plain(got[0], got[1]),
                    f'lab_merge, {n} pixels')


@pytest.mark.cuda
@pytest.mark.parametrize('case,stages', [('full', 2), ('laplacian', 3)])
def test_full_frame_launches_the_lab_kernels(dev, case, stages):
    """One FULL frame splits and merges once a luminance stage: 2 and 2, 3
    and 3 with the Laplacian, eager and in the processor's graph."""
    _, _, _, _, eager_launches, launches = _graph_case(dev, case, n_batches=1, batch=1)
    for got in (eager_launches, launches):
        assert got['lab_split'] == stages and got['lab_merge'] == stages, got


def _jpeg_image(seed, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / 23) * np.cos(yy / 17), 128 + 70 * np.cos(xx / 11),
                    128 + 50 * np.sin((xx + yy) / 31)], -1)
    return torch.from_numpy(np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize('h,w', [(61, 45), (480, 640), (3000, 4096)])
@pytest.mark.parametrize('subsampling', [0, 1, 2])
def test_jpeg_stage_on_card(dev, subsampling, h, w):
    """The DCT stage on the card equals the same stage on the CPU,
    coefficient for coefficient (elementwise ops in a fixed order)."""
    from tpu_darktable_torch.ops import jpeg as jp

    img = _jpeg_image(h + w, h, w)
    card = jp._prepare_device_stage(img.to(dev), 90, 3, subsampling)[4]
    cpu = jp._prepare_device_stage(img, 90, 3, subsampling)[4]
    for a, b in zip(card, cpu):
        assert a.is_cuda and torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize('h,w,restart_interval', [(61, 45, 0), (480, 640, 5), (3000, 4096, None)])
def test_device_entropy_on_card(dev, h, w, restart_interval):
    """Device entropy on the card against the native host scan: the same
    bytes, with and without restart intervals; async equals sync."""
    from tpu_darktable_torch.ops import jpeg as jp

    img = _jpeg_image(h * w, h, w).to(dev)
    host = jp.encode_jpeg(img, 90, restart_interval=restart_interval, entropy='host')
    device = jp.encode_jpeg(img, 90, restart_interval=restart_interval, entropy='device')
    pending = jp.encode_jpeg_async(img, 90, restart_interval=restart_interval)
    assert np.array_equal(device, host)
    assert np.array_equal(pending.result(), host)


def _luminance(seed, h, w):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((h, w)) * 0.8).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize('h,w', [(97, 131), (480, 640), (3000, 4096)])
@pytest.mark.parametrize('storage', [torch.float32, torch.float16])
@pytest.mark.parametrize('params', [{}, dict(shadows=0.6, highlights=1.4, clarity=0.3)],
                         ids=['neutral', 'strong'])
def test_local_laplacian_on_card(dev, params, storage, h, w):
    """The card against the CPU, with the bars the CPU holds against JAX:
    float32 storage 1e-6; float16 storage bit for bit with neutral
    parameters, else 1e-3 in under 0.5% of the elements (torch's `exp`
    rounds differently on the card and the CPU)."""
    from tpu_darktable_torch.ops.laplacian import LaplacianParams, local_laplacian

    lum = _luminance(h + w, h, w)
    p = LaplacianParams(**params)
    card = local_laplacian(lum.to(dev), p, storage_dtype=storage)
    assert card.is_cuda
    d = (card.cpu() - local_laplacian(lum, p, storage_dtype=storage)).abs()
    if storage == torch.float32:
        assert d.max().item() <= 1e-6
    elif not params:
        assert d.max().item() == 0.0
    else:
        assert d.max().item() <= 1e-3 and (d > 0).float().mean().item() < 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize('adjust', [(0.0, 0.0, 0.0), (0.25, 0.1, -0.05), (-0.6, -0.3, 0.2)])
def test_hsl_on_card(dev, adjust):
    """rgb_to_hsl, hsl_to_rgb and modify_hsl, card against CPU: 1e-6 (the
    hue's division by 6 goes through a device tensor, so the card divides
    as the CPU does)."""
    from tpu_darktable_torch.ops import color

    rgb = _rand(21, (300, 401, 3), 'cpu')
    rgb[0, :3] = torch.tensor([[0.5, 0.5, 0.5], [0.0, 0.0, 0.0], [0.9, 0.3, 0.3]])
    hsl = color.rgb_to_hsl(rgb)
    assert (color.rgb_to_hsl(rgb.to(dev)).cpu() - hsl).abs().max().item() <= 1e-6
    assert (color.hsl_to_rgb(hsl.to(dev)).cpu() - color.hsl_to_rgb(hsl)).abs().max().item() <= 1e-6
    card = color.modify_hsl(rgb.to(dev), *adjust).cpu()
    assert (card - color.modify_hsl(rgb, *adjust)).abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize('h,w', [(64, 80), (200, 264), (3000, 4096)])
@pytest.mark.parametrize('pattern', ['RGGB', 'GBRG'])
def test_dual_demosaic_on_card(dev, pattern, h, w):
    """dual_demosaic on the card (RCD through rcd_interior from 96 px up)
    against the CPU's plain path: 1e-6; one launch where the kernel path
    runs."""
    from tpu_darktable_torch.ops.rcd import dual_demosaic

    x = _rand(22, (h, w), 'cpu')
    kernels.reset_launches()
    card = dual_demosaic(x.to(dev), BayerPattern[pattern], threshold=0.2, wb=(1.8, 1.0, 1.4))
    assert kernels.launches['rcd_interior'] == (1 if min(h, w) >= 96 else 0)
    cpu = dual_demosaic(x, BayerPattern[pattern], threshold=0.2, wb=(1.8, 1.0, 1.4))
    assert (card.cpu() - cpu).abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['aces', 'adaptive_aces', 'reinhard', 'linear', 'filmic'])
def test_tonemaps_make_no_host_wait(dev, kind):
    """No tonemap makes the host wait for the card (a constant made on the
    card from a Python number would: plain ACES' exposure, filmic's white
    point)."""
    from tpu_darktable_torch.ops import tonemap

    rgb = _rand(41, (64, 96, 3), dev)
    metrics = tonemap.compute_image_metrics([rgb])
    params = tonemap.TonemapParameters(gamma=1.5, intensity=2.0, light_adapt=0.8, vibrance=0.5)
    fn = {'aces': lambda: tonemap.aces_tonemap(rgb, params),
          'adaptive_aces': lambda: tonemap.aces_tonemap(rgb, params, metrics),
          'reinhard': lambda: tonemap.reinhard_tonemap(rgb, metrics, params),
          'linear': lambda: tonemap.linear_tonemap(rgb, metrics, params),
          'filmic': lambda: tonemap.filmic_tonemap(rgb, params, metrics)}[kind]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert torch.equal(out.cpu(), fn().cpu())


def _full_frames(dev, w, h, n):
    from tpu_darktable_torch.ops.packed import encode12_float

    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return torch.stack([encode12_float(torch.from_numpy(np.clip(
        0.4 + 0.3 * np.sin(xx / (9.0 + i)) * np.cos(yy / 7.0) + rng.normal(0, 0.04, (h, w)),
        0, 1).astype(np.float32).reshape(-1))) for i in range(n)]).to(dev)


@pytest.mark.cuda
def test_sharded_programs_on_card(dev):
    """parallel/ on a mesh of the one card repeated: batch sharding bit for
    bit with the unsharded program, 3 row bands and a (2, 3) grid within 1
    count of it (strict_alias off), each launching FULL's three kernels once
    a band block of a frame."""
    from tpu_darktable_torch import parallel
    from tpu_darktable_torch.pipeline.config import Debayer, ImageProcessingSettings, ToneMapper
    from tpu_darktable_torch.pipeline.image_processor import build_pipeline_fn
    from tpu_darktable_torch.ops.bayer import PackedFormat

    w, h = 256, 192   # 3 bands of 64 rows, blocks of 192
    s = ImageProcessingSettings(debayer=Debayer.rcd, postprocess=True, enable_denoise=True,
                                enable_bilateral=True, tone_mapping=ToneMapper.adaptive_aces)
    f32 = dict(dtype=torch.float32, device=dev)
    state = (torch.tensor([1.2, 1.0, 1.1], **f32), torch.zeros(2, **f32), torch.zeros(5, **f32),
             torch.ones((), **f32))
    frames = _full_frames(dev, w, h, 4)
    args = (s, (w, h), BayerPattern.RGGB, PackedFormat.Packed12, True)

    fn = build_pipeline_fn(*args)
    sharded = parallel.sharded_pipeline(fn, parallel.make_mesh([dev] * 4))
    for a, b in zip(sharded(frames, *state), fn(frames, *state)):
        assert torch.equal(a, b)

    unsharded = build_pipeline_fn(*args, rcd_strict_alias=False)
    cases = (
        (parallel.build_spatial_pipeline_fn(*args, parallel.make_mesh([dev] * 3), halo=64),
         frames[0], 1),
        (parallel.build_grid_pipeline_fn(*args, parallel.make_grid_mesh(2, 3, [dev] * 6),
                                         halo=64), frames[:2], 2),
    )
    for program, data, n_frames in cases:
        want, want_bounds, want_metrics = unsharded(data.reshape(n_frames, -1), *state)
        kernels.reset_launches()
        out, bounds, metrics = program(data, *state)
        assert all(kernels.launches[k] == 3 * n_frames
                   for k in ('rcd_interior', 'color_smooth_diffs', 'bilateral_band'))
        assert (out.int() - want.reshape(out.shape).int()).abs().max().item() <= 1
        assert (bounds - want_bounds).abs().max().item() <= 1e-6
        assert torch.allclose(metrics, want_metrics, rtol=1e-5, atol=1e-6)


# ---- the batched program as a CUDA graph (tpu_darktable_torch/_graph.py)

def _graph_case(dev, case, w=256, h=192, n_batches=3, batch=2):
    """The graphed ImageProcessor and the eager build_pipeline_fn of one
    settings case on the same batches: their outputs, bounds and metrics
    a batch, and the launches of each."""
    from test_torch_graph import case_frames, case_settings
    import tpu_darktable_torch as tt

    s = case_settings(case)
    frames = case_frames(w, h, n_batches * batch, seed=21).to(dev)
    batches = [frames[i * batch:(i + 1) * batch] for i in range(n_batches)]
    fn = tt.build_pipeline_fn(s, (w, h), BayerPattern.RGGB, tt.PackedFormat.Packed12, True)
    f32 = dict(dtype=torch.float32, device=dev)
    wb = torch.tensor([1.2, 1.0, 1.1], **f32)
    bounds, metrics = torch.zeros(2, **f32), torch.zeros(5, **f32)
    kernels.reset_launches()
    eager = []
    for k, b in enumerate(batches):
        alpha = torch.full((), 1.0 if k == 0 else s.moving_average, **f32)
        out, bounds, metrics = fn(b, wb, bounds, metrics, alpha)
        eager.append((out, bounds, metrics))
    eager_launches = dict(kernels.launches)
    proc = tt.ImageProcessor((w, h), BayerPattern.RGGB, tt.PackedFormat.Packed12, s,
                             device=dev, white_balance=(1.2, 1.0, 1.1))
    kernels.reset_launches()
    graphed = [(proc.process_batch(b), proc.bounds, proc.metrics) for b in batches]
    return proc, batches, eager, graphed, eager_launches, dict(kernels.launches)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['full', 'laplacian', 'ppg', 'bilinear', 'aces', 'reinhard',
                                  'linear', 'filmic', 'sigma_s3', 'denoise_f32'])
def test_graphed_process_batch_equals_eager(dev, case):
    """Three batches of 2 at 256x192: the first eager, then a capture, then
    two replays, bit for bit with the eager program (uint8 output, bounds
    and metrics), and the launches of each kernel that ran equal to the
    eager program's: one a frame."""
    proc, _, eager, graphed, eager_launches, launches = _graph_case(dev, case)
    assert len(proc._fused._captured) == 1
    for (a, ab, am), (b, bb, bm) in zip(eager, graphed):
        assert torch.equal(a, b) and torch.equal(ab, bb) and torch.equal(am, bm)
    assert launches == eager_launches
    if case in ('full', 'laplacian'):
        assert all(launches[k] == 6 for k in ('rcd_interior', 'color_smooth_diffs',
                                              'bilateral_band'))
        stages = 3 if case == 'laplacian' else 2   # the LAB kernels: once a luminance stage
        assert launches['lab_split'] == launches['lab_merge'] == 6 * stages
        assert sum(launches.values()) == 18 + 12 * stages


@pytest.mark.cuda
def test_graph_outputs_survive_the_next_call(dev):
    """A tensor a call returned (the uint8 batch, the bounds and metrics
    the processor keeps) is unchanged after the next call."""
    proc, batches, _, graphed, _, _ = _graph_case(dev, 'full')
    kept = [tuple(t.clone() for t in g) for g in graphed]
    proc.process_batch(batches[0])
    proc.process_batch(batches[2])
    for g, k in zip(graphed, kept):
        assert all(torch.equal(a, b) for a, b in zip(g, k))


@pytest.mark.cuda
def test_new_batch_size_captures_again(dev):
    """Batches of 2, 1, 2, 1: one capture a batch size, each replay equal to
    the eager program on the same state."""
    from test_torch_graph import case_frames, case_settings
    import tpu_darktable_torch as tt

    w, h = 256, 192
    s = case_settings('full')
    frames = case_frames(w, h, 6, seed=22).to(dev)
    batches = [frames[0:2], frames[2:3], frames[3:5], frames[5:6]]
    proc = tt.ImageProcessor((w, h), BayerPattern.RGGB, tt.PackedFormat.Packed12, s,
                             device=dev, white_balance=(1.2, 1.0, 1.1))
    fn = tt.build_pipeline_fn(s, (w, h), BayerPattern.RGGB, tt.PackedFormat.Packed12, True)
    f32 = dict(dtype=torch.float32, device=dev)
    wb = torch.tensor([1.2, 1.0, 1.1], **f32)
    bounds, metrics = torch.zeros(2, **f32), torch.zeros(5, **f32)
    for k, b in enumerate(batches):
        alpha = torch.full((), 1.0 if k == 0 else s.moving_average, **f32)
        out, bounds, metrics = fn(b, wb, bounds, metrics, alpha)
        assert torch.equal(proc.process_batch(b), out)
        assert torch.equal(proc.bounds, bounds) and torch.equal(proc.metrics, metrics)
    assert len(proc._fused._captured) == 2


@pytest.mark.cuda
def test_update_settings_drops_the_graphs(dev):
    """update_settings replaces the wrapper: the old graphs and their pool
    go, and the new settings capture their own program."""
    import gc
    import weakref
    from test_torch_graph import case_settings

    proc, batches, _, _, _, _ = _graph_case(dev, 'full')
    old = weakref.ref(proc._fused)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    proc.update_settings(case_settings('reinhard'))
    gc.collect()
    torch.cuda.empty_cache()
    assert old() is None and proc._fused._captured == {}
    assert torch.cuda.memory_reserved() < reserved
    proc.process_batch(batches[0])
    proc.process_batch(batches[1])
    assert len(proc._fused._captured) == 1


@pytest.mark.cuda
def test_replay_outlives_the_device_caches(dev):
    """After the capture, every device cache cleared, the allocator's cache
    emptied and the freed memory overwritten: the replays still equal the
    eager program bit for bit (the graph holds the constants it read)."""
    import gc
    from test_torch_graph import case_settings
    import tpu_darktable_torch as tt
    from tpu_darktable_torch import _device

    for case in ('full', 'bilinear', 'sigma_s3', 'denoise_f32', 'laplacian'):
        proc, batches, eager, _, _, _ = _graph_case(dev, case, n_batches=1)
        _device.clear_caches()
        gc.collect()
        torch.cuda.empty_cache()
        junk = [torch.full((1 << 20,), float('nan'), device=dev) for _ in range(64)]
        proc.bounds = proc.metrics = None    # the first batch's state again
        out = proc.process_batch(batches[0])
        del junk
        assert torch.equal(out, eager[0][0]), case
        assert torch.equal(proc.bounds, eager[0][1]) and torch.equal(proc.metrics, eager[0][2])


@pytest.mark.cuda
def test_replay_makes_no_host_wait(dev):
    """A replayed process_batch (a batch on the card) runs under CUDA sync
    debugging set to 'error' without raising."""
    proc, batches, eager, _, _, _ = _graph_case(dev, 'full')
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        out = proc.process_batch(batches[1])
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert out.shape == eager[1][0].shape


# ---- the workspaces, the timing chains and the sharded stages as CUDA graphs

def _card_input(kind, seed, dev, w=256, h=192):
    rng = np.random.default_rng(seed)
    if kind == 'mosaic':
        return torch.from_numpy((0.2 + 0.6 * rng.random((h, w, 1))).astype(np.float32)).to(dev)
    rgb = torch.from_numpy((0.15 + 0.7 * rng.random((h, w, 3))).astype(np.float32)).to(dev)
    if kind == 'lum':
        from tpu_darktable_torch.ops import color

        return color.compute_luminance(rgb)
    return rgb


# label -> (the owner's maker on a device, its input's kind, a call with a
# value: the noise, detail or nothing); the third call of each test takes
# the second value
def _workspace_cases():
    import tpu_darktable_torch as tt

    p, size = BayerPattern.RGGB, (256, 192)
    strong = tt.LaplacianParams(shadows=0.6, highlights=1.4, clarity=0.3)
    f16 = dict(spectral_dtype=torch.float16, storage_dtype=torch.float16)
    return {
        'bilinear5x5_demosaic': (lambda d: None, 'mosaic',
                                 lambda o, x, v: tt.bilinear5x5_demosaic(x, p), (None, None)),
        'Bilinear5x5': (lambda d: tt.Bilinear5x5(p), 'mosaic', lambda o, x, v: o.process(x),
                        (None, None)),
        'PPG': (lambda d: tt.PPG(d, size, p, median_threshold=2.0), 'mosaic',
                lambda o, x, v: o.process(x), (None, None)),
        'RCD': (lambda d: tt.RCD(d, size, p), 'mosaic', lambda o, x, v: o.process(x),
                (None, None)),
        'PostProcess': (lambda d: tt.PostProcess(d, size, p, color_smoothing_passes=3,
                                                 green_eq_local=True, green_eq_global=True),
                        'rgb', lambda o, x, v: o.process(x), (None, None)),
        'Wiener.process': (lambda d: tt.Wiener(d, size), 'rgb',
                           lambda o, x, v: o.process(x, v), (0.05, 0.02)),
        'Wiener.process f16': (lambda d: tt.Wiener(d, size, **f16), 'rgb',
                               lambda o, x, v: o.process(x, v), (0.05, 0.02)),
        'Wiener.process_luminance': (lambda d: tt.Wiener(d, size), 'rgb',
                                     lambda o, x, v: o.process_luminance(x, v), (0.05, 0.1)),
        'Wiener.process_log_luminance': (lambda d: tt.Wiener(d, size, **f16), 'rgb',
                                         lambda o, x, v: o.process_log_luminance(x, v),
                                         (0.075, 0.03)),
        'Wiener.process_log': (lambda d: tt.Wiener(d, size, overlap_factor=2), 'rgb',
                               lambda o, x, v: o.process_log(x, v), (0.05, 0.08)),
        'Laplacian.process': (lambda d: tt.Laplacian(d, size), 'lum',
                              lambda o, x, v: o.process(x), (None, None)),
        'Laplacian.process_rgb': (lambda d: tt.Laplacian(d, size, strong), 'rgb',
                                  lambda o, x, v: o.process_rgb(x), (None, None)),
        'Bilateral.process': (lambda d: tt.Bilateral(d, size, sigma_s=2.0, sigma_r=0.2), 'lum',
                              lambda o, x, v: o.process(x, v), (0.4, -0.6)),
        'Bilateral.process_rgb sigma_s 3': (
            lambda d: tt.Bilateral(d, size, sigma_s=3.0, sigma_r=0.2), 'rgb',
            lambda o, x, v: o.process_rgb(x, v), (0.4, 1.1)),
        'Bilateral.process_log_rgb': (lambda d: tt.Bilateral(d, size, sigma_s=2.0, sigma_r=0.2),
                                      'rgb', lambda o, x, v: o.process_log_rgb(x, v, 1e-4),
                                      (0.4, 0.9)),
    }


WORKSPACE_CASES = ['bilinear5x5_demosaic', 'Bilinear5x5', 'PPG', 'RCD', 'PostProcess',
                   'Wiener.process', 'Wiener.process f16', 'Wiener.process_luminance',
                   'Wiener.process_log_luminance', 'Wiener.process_log', 'Laplacian.process',
                   'Laplacian.process_rgb', 'Bilateral.process', 'Bilateral.process_rgb sigma_s 3',
                   'Bilateral.process_log_rgb']


def _eager_owner(make, dev):
    """The same class with its graphs taken out: each call runs eagerly."""
    owner = make(dev)
    if owner is None:
        return None
    owner._graphs = owner._graphs.fn
    return owner


def _eager_call(call, owner, x, v):
    from tpu_darktable_torch import debayer

    if owner is None:
        return debayer._bilinear.fn(x, BayerPattern.RGGB)
    return call(owner, x, v)


@pytest.mark.cuda
@pytest.mark.parametrize('label', WORKSPACE_CASES)
def test_graphed_workspace_equals_eager(dev, label):
    """Three calls on new inputs, the third with a changed noise or
    detail: the first eager and captured, then replays (or a new capture
    for a new detail), each bit for bit with the eager method and with the
    eager method's launches."""
    from tpu_darktable_torch import debayer

    make, kind, call, (v1, v2) = _workspace_cases()[label]
    owner, eager = make(dev), _eager_owner(make, dev)
    graphs = debayer._bilinear if owner is None else owner._graphs
    graphs._captured.clear()
    for k, v in enumerate((v1, v1, v2)):
        x = _card_input(kind, 30 + k, dev)
        kernels.reset_launches()
        want = _eager_call(call, eager, x, v)
        want_launches = dict(kernels.launches)
        kernels.reset_launches()
        got = call(owner, x, v)
        assert torch.equal(got, want), (label, k)
        assert dict(kernels.launches) == want_launches, (label, k)
    keys = 2 if label.startswith('Bilateral') else 1
    assert len(graphs._captured) == keys


@pytest.mark.cuda
def test_processor_graphs_replay_in_any_order(dev):
    """One processor's batched program and its four piecewise workspaces
    share a memory pool: captured in one order and replayed in others, each
    output equals the eager program's bit for bit."""
    from test_torch_graph import case_frames, case_settings
    import tpu_darktable_torch as tt

    w, h = 256, 192
    s = case_settings('full')
    frames = case_frames(w, h, 6, seed=23).to(dev)
    proc = tt.ImageProcessor((w, h), BayerPattern.RGGB, tt.PackedFormat.Packed12, s,
                             device=dev, white_balance=(1.2, 1.0, 1.1))
    ref = tt.ImageProcessor((w, h), BayerPattern.RGGB, tt.PackedFormat.Packed12, s,
                            device=dev, white_balance=(1.2, 1.0, 1.1))
    ref._fused = ref._fused.fn
    for name in ('rcd_workspace', 'postprocess_workspace', 'wiener_workspace', 'bil_workspace'):
        ws = getattr(ref, name)
        ws._graphs = ws._graphs.fn

    def piecewise(p, frame):
        rgb = p.debayer(p.load_bytes(frame))
        return p.process_rgb(rgb, tt.compute_image_bounds([rgb], stride=8))

    def batched(p, batch):
        p.bounds = p.metrics = None
        return p.process_batch(batch), p.bounds, p.metrics

    steps = [('batched', frames[0:2]), ('piecewise', frames[2]), ('piecewise', frames[3]),
             ('batched', frames[4:6]), ('piecewise', frames[5]), ('batched', frames[0:2])]
    for k, (kind, data) in enumerate(steps):
        run = batched if kind == 'batched' else piecewise
        got, want = run(proc, data), run(ref, data)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (k, kind)
    assert len(proc._fused._captured) == 1
    assert all(len(getattr(proc, n)._graphs._captured) == 1
               for n in ('rcd_workspace', 'postprocess_workspace', 'wiener_workspace',
                         'bil_workspace'))


@pytest.mark.cuda
def test_workspace_replay_outlives_the_device_caches(dev):
    """After the capture, every device cache cleared, the allocator's cache
    emptied and the freed memory overwritten: each workspace's replay still
    equals the eager method bit for bit."""
    import gc
    from tpu_darktable_torch import _device

    cases = _workspace_cases()
    for label in ('PPG', 'RCD', 'PostProcess', 'Wiener.process_log_luminance',
                  'Laplacian.process_rgb', 'Bilateral.process_rgb sigma_s 3'):
        make, kind, call, (v1, _) = cases[label]
        owner = make(dev)
        call(owner, _card_input(kind, 40, dev), v1)
        x = _card_input(kind, 41, dev)
        want = call(_eager_owner(make, dev), x, v1)
        _device.clear_caches()
        gc.collect()
        torch.cuda.empty_cache()
        junk = [torch.full((1 << 20,), float('nan'), device=dev) for _ in range(64)]
        got = call(owner, x, v1)
        del junk
        assert torch.equal(got, want), label


@pytest.mark.cuda
def test_sharded_processor_replays_bit_for_bit(dev):
    """ImageProcessor(mesh=make_mesh([cuda] * 4)) over three batches of 8:
    each stage captured once for all four shards and replayed, every batch
    bit for bit with the unsharded graphed processor, and the launches one
    of each of FULL's kernels a frame."""
    from test_torch_graph import case_frames, case_settings
    import tpu_darktable_torch as tt
    from tpu_darktable_torch import parallel

    w, h = 256, 192
    s = case_settings('full')
    frames = case_frames(w, h, 24, seed=24).to(dev)
    mk = lambda mesh: tt.ImageProcessor((w, h), BayerPattern.RGGB, tt.PackedFormat.Packed12, s,
                                        device=dev, white_balance=(1.2, 1.0, 1.1), mesh=mesh)
    sharded, single = mk(parallel.make_mesh([dev] * 4)), mk(None)
    for k in range(3):
        batch = frames[8 * k:8 * (k + 1)]
        kernels.reset_launches()
        out = sharded.process_batch(batch)
        launches = dict(kernels.launches)
        assert torch.equal(out, single.process_batch(batch)), k
        assert torch.equal(sharded.bounds, single.bounds)
        assert torch.equal(sharded.metrics, single.metrics)
        assert all(launches[n] == 8 for n in ('rcd_interior', 'color_smooth_diffs',
                                              'bilateral_band')), (k, launches)
    assert [len(g._captured) for g in sharded._fused.graphs] == [1, 1, 1]


@pytest.mark.cuda
def test_benchmark_op_replays_its_chain(dev):
    """benchmark_op's chain on the card: captured once, and the launches
    of the timed replays counted (RCD: one rcd_interior a call)."""
    from tpu_darktable_torch.ops import rcd
    from tpu_darktable_torch.utils import timing

    x = _card_input('mosaic', 50, dev)[..., 0]
    kernels.reset_launches()
    dt = timing.benchmark_op(lambda v: rcd.rcd_demosaic(v, BayerPattern.RGGB)[..., 1], x,
                             iters=3, warmup=2)
    # the eager first call, then two warm-up replays and the timed one
    assert dt > 0 and kernels.launches['rcd_interior'] == 3 * 4


@pytest.mark.cuda
def test_sharded_graphs_over_distinct_cards(dev):
    """With two cards or more: the batch-sharded processor and the 3-band
    program over distinct cards, each card capturing its own stages (one
    capture a stage and card), equal to the unsharded program on the
    first card (batch sharding bit for bit, bands within 1 count)."""
    from test_torch_graph import case_frames, case_settings
    import tpu_darktable_torch as tt
    from tpu_darktable_torch import parallel

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip('needs two CUDA devices or more')
    cards = [torch.device('cuda', i) for i in range(n)]
    w, h = 256, 192
    s = case_settings('full')
    frames = case_frames(w, h, 2 * n, seed=25).to(cards[0])
    mk = lambda mesh: tt.ImageProcessor((w, h), BayerPattern.RGGB, tt.PackedFormat.Packed12, s,
                                        device=cards[0], white_balance=(1.2, 1.0, 1.1),
                                        mesh=mesh)
    sharded, single = mk(parallel.make_mesh(cards)), mk(None)
    for k in range(3):
        assert torch.equal(sharded.process_batch(frames), single.process_batch(frames)), k
        assert torch.equal(sharded.bounds, single.bounds)
    assert [len(g._captured) for g in sharded._fused.graphs] == [n, n, n]
    args = (s, (w, h), BayerPattern.RGGB, tt.PackedFormat.Packed12, True)
    f32 = dict(dtype=torch.float32, device=cards[0])
    state = (torch.tensor([1.2, 1.0, 1.1], **f32), torch.zeros(2, **f32), torch.zeros(5, **f32),
             torch.ones((), **f32))
    bands = parallel.build_spatial_pipeline_fn(
        *args, parallel.make_mesh([cards[i % n] for i in range(3)]), halo=64)
    want = tt.build_pipeline_fn(*args, rcd_strict_alias=False)(frames[:1], *state)[0][0]
    for _ in range(2):
        out = bands(frames[0], *state)[0]
        assert out.device == cards[0]
        assert (out.int() - want.int()).abs().max().item() <= 1


# ---- the JPEG stages and the band programs' glue as CUDA graphs

def _plain_jpeg_stages():
    from tpu_darktable_torch.ops import jpeg as jp

    stages = jp._Stages()
    stages.dct, stages.scan = jp._jpeg_device_stage, jp._scan
    return stages


@pytest.mark.cuda
@pytest.mark.parametrize('restart_interval', [0, 5, None], ids=['off', '5', 'auto'])
@pytest.mark.parametrize('subsampling', [0, 1, 2], ids=['444', '422', 'gray'])
def test_graphed_jpeg_equals_eager_and_host_scan(dev, subsampling, restart_interval):
    """A Jpeg's DCT stage and entropy scan captured on its first encode and
    replayed after: over two frames and qualities 90 and 75 (one capture a
    stage), the bytes equal the eager encode on the card and the host scan
    of the CPU's coefficients, bit for bit; a replayed encode_async makes
    the host wait nowhere."""
    import tpu_darktable_torch as tt
    from tpu_darktable_torch.ops import jpeg as jp

    plain = _plain_jpeg_stages()
    jpeg = tt.Jpeg()
    frames = [_jpeg_image(seed, 480, 640) for seed in (31, 32)]
    for quality in (90, 75):
        for img in frames:
            args = (quality, 3, subsampling)
            got = jpeg.encode(img.to(dev), quality, subsampling=subsampling,
                              restart_interval=restart_interval)
            eager = jp._encode(plain, img.to(dev), *args, False, restart_interval, 'device', None)
            host = jp._encode(plain, img, *args, False, restart_interval, 'host', None)
            assert np.array_equal(got, eager) and np.array_equal(got, host), (quality,)
    assert len(jpeg._stages.dct._captured) == 1 and len(jpeg._stages.scan._captured) == 1
    on_card = frames[0].to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        pending = jpeg.encode_async(on_card, 90, subsampling=subsampling,
                                    restart_interval=restart_interval)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    want = jp._encode(plain, frames[0], 90, 3, subsampling, False, restart_interval, 'host',
                      None)
    assert np.array_equal(pending.result(), want)


@pytest.mark.cuda
@pytest.mark.parametrize('entropy', ['device', 'host'])
def test_two_threads_through_one_jpeg_on_card(dev, entropy):
    """Two host threads encode different frames through one Jpeg at once,
    five times each (its graphs captured before): every encode gives its
    own frame's eager bytes."""
    import threading

    import tpu_darktable_torch as tt
    from tpu_darktable_torch.ops import jpeg as jp

    plain = _plain_jpeg_stages()
    frames = [_jpeg_image(seed, 480, 640).to(dev) for seed in (33, 34)]
    want = [jp._encode(plain, f, 90, 3, 1, False, None, entropy, None) for f in frames]
    jpeg = tt.Jpeg()
    jpeg.encode(frames[0], 90, entropy=entropy)
    start = threading.Barrier(2)
    got = {0: [], 1: []}

    def encode(k):
        start.wait()
        for _ in range(5):
            got[k].append(jpeg.encode(frames[k], 90, entropy=entropy))

    threads = [threading.Thread(target=encode, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(jpeg._stages.dct._captured) == 1
    for k in (0, 1):
        assert len(got[k]) == 5 and all(np.array_equal(d, want[k]) for d in got[k])


@pytest.mark.cuda
@pytest.mark.parametrize('device_jpeg', [True, False], ids=['device JPEG', 'host JPEG'])
def test_streaming_replays_the_jpeg_stages_on_card(dev, device_jpeg):
    """The streaming executor at 256x192, batch 2, 6 frames: the encoder's
    graphs captured once on the processor's pool (host mode: by a worker
    thread), and every frame's bytes equal an eager encoder's of the
    same frame."""
    from test_torch_graph import case_frames, case_settings
    import tpu_darktable_torch as tt
    from tpu_darktable_torch.ops import jpeg as jp
    from tpu_darktable_torch.pipeline.streaming import StreamingExecutor

    w, h = 256, 192
    proc = tt.ImageProcessor((w, h), BayerPattern.RGGB, tt.PackedFormat.Packed12,
                             case_settings('full'), device=dev, white_balance=(1.2, 1.0, 1.1))
    frames = [(f'f{i}', f) for i, f in enumerate(case_frames(w, h, 6, seed=26))]
    ex = StreamingExecutor(proc, batch_size=2, jpeg_quality=90, keep_images=True,
                           device_jpeg=device_jpeg)
    results = ex.run(frames)
    stages = ex._jpeg._stages
    assert stages.dct.pool is proc._graph_pool
    assert [len(stages.dct._captured), len(stages.scan._captured)] == \
        [1, 1 if device_jpeg else 0]
    plain = _plain_jpeg_stages()
    for r in results:
        assert r.error is None
        want = jp._encode(plain, torch.from_numpy(r.image), 90, 3, 1, False, None, 'host', None)
        assert r.jpeg == np.asarray(want).tobytes(), r.name


_BAND_GLUE_CASES = {
    'bands 3 full': ({}, None),
    'bands 3 full laplacian': (dict(enable_laplacian=True, lap_clarity=0.3), None),
    'grid 2x3 full': ({}, (2, 3)),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', list(_BAND_GLUE_CASES))
def test_band_glue_graphed_equals_eager_on_card(dev, case):
    """The band programs at 256x192 (3 bands of 64 rows, blocks of 192) with
    their per-device glue graphed, against a copy whose glue (green eq,
    the Laplacian's LAB steps and full-frame Laplacian) runs eagerly
    between its graphed stage groups: bit for bit over two calls; one
    capture a step for all blocks; no host wait on the replays."""
    import dataclasses

    from test_torch_graph import case_frames, case_settings
    import tpu_darktable_torch as tt
    from tpu_darktable_torch import parallel

    kw, grid = _BAND_GLUE_CASES[case]
    w, h = 256, 192
    s = dataclasses.replace(case_settings('full'), **kw)
    args = (s, (w, h), BayerPattern.RGGB, tt.PackedFormat.Packed12, True)
    f32 = dict(dtype=torch.float32, device=dev)
    state = (torch.tensor([1.2, 1.0, 1.1], **f32), torch.zeros(2, **f32), torch.zeros(5, **f32),
             torch.ones((), **f32))
    frames = case_frames(w, h, 2, seed=27).to(dev)
    if grid is None:
        build = lambda: parallel.build_spatial_pipeline_fn(*args, parallel.make_mesh([dev] * 3),
                                                           halo=64)
        data = frames[0]
    else:
        build = lambda: parallel.build_grid_pipeline_fn(
            *args, parallel.make_grid_mesh(*grid, [dev] * 6), halo=64)
        data = frames
    graphed, eager = build(), build()
    for name in ('green_eq', 'lab', 'laplacian', 'lab_modify'):
        eager.graphs[name] = eager.graphs[name].fn
    for _ in range(2):
        for a, b in zip(graphed(data, *state), eager(data, *state)):
            assert torch.equal(a, b)
    used = {'front', 'green_eq', 'back', 'tonemap'}
    used |= {'lab', 'laplacian', 'lab_modify'} if s.enable_laplacian else set()
    assert {n for n, g in graphed.graphs.items() if g._captured} == used
    assert all(len(graphed.graphs[n]._captured) == 1 for n in used)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        graphed(data, *state)
    finally:
        torch.cuda.set_sync_debug_mode('default')


# ---- the tracer (utils/timing.py) on the card

def _camera(name, w, h):
    import json
    from pathlib import Path

    from tpu_darktable_torch.pipeline.camera_settings import CameraSettings

    path = Path(__file__).resolve().parent.parent / 'tpu_darktable_torch' / 'camera_settings'
    d = json.loads((path / f'{name}.json').read_text())
    return CameraSettings.from_dict(dict(d, image_size=[w, h]))


def _stream_frames(cs, n, seed):
    """(name, packed bytes on the host) of n smooth noisy mosaics."""
    from tpu_darktable_torch.ops.bayer import PackedFormat
    from tpu_darktable_torch.ops.packed import encode12_float

    w, h = cs.image_size
    names = list(cs.transform) if isinstance(cs.transform, dict) else ['frame']
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        mosaic = np.clip(0.4 + 0.3 * np.sin(xx / (9.0 + i)) * np.cos(yy / 7.0)
                         + rng.normal(0, 0.04, (h, w)), 0, 1).astype(np.float32)
        packed = encode12_float(torch.from_numpy(mosaic.reshape(-1)),
                                ids_format=cs.packed_format is PackedFormat.Packed12_IDS)
        out.append((names[i % len(names)], packed.numpy()))
    return out


def _stream_through(dev, cs, frames, batch, traced):
    """The executor's results (uint8 frames and JFIF bytes, device JPEG) of
    a fresh processor, with the tracer on or off for the whole run."""
    from tpu_darktable_torch.pipeline.image_processor import ImageProcessor
    from tpu_darktable_torch.pipeline.streaming import StreamingExecutor
    from tpu_darktable_torch.utils import timing

    timing.reset()
    if traced:
        timing.enable()
    try:
        proc = ImageProcessor.from_camera_settings(cs, device=dev)
        ex = StreamingExecutor(proc, batch_size=batch, jpeg_quality=90, keep_images=True,
                               device_jpeg=True)
        results = ex.run(frames)
        marks = timing.marks()
    finally:
        timing.disable()
    return results, marks


@pytest.mark.cuda
@pytest.mark.parametrize('camera,batch', [('artichoke', 2), ('beetroot', 12)],
                         ids=['FULL', 'rig'])
def test_tracing_leaves_the_outputs_bit_identical(dev, camera, batch):
    """FULL (the artichoke camera) and the rig at 1024x768, three batches
    through the streaming executor with device JPEG: the uint8 frames and
    the JFIF bytes with the tracer on equal those with it off, and the
    traced run records every mark of every call (RCD's interior mark a
    frame on the card's kernel path)."""
    cs = _camera(camera, 1024, 768)
    frames = _stream_frames(cs, 3 * batch, seed=41)
    plain, none = _stream_through(dev, cs, frames, batch, traced=False)
    traced, marks = _stream_through(dev, cs, frames, batch, traced=True)
    assert none == []
    assert [r.name for r in plain] == [r.name for r in traced]
    for a, b in zip(plain, traced):
        assert a.error is None and b.error is None
        assert np.array_equal(a.image, b.image) and a.jpeg == b.jpeg, a.name
    per_frame = ['decode', 'rcd.interior', 'demosaic', 'postprocess']
    back = ['normalize', 'denoise', 'bilateral']
    want = ['begin'] + per_frame * batch + ['bounds'] + back * batch + ['metrics', 'tonemap']
    calls = {}
    for m in marks:
        calls.setdefault(m.call, []).append(m.name)
    program = [c for c in calls.values() if c[0] == 'begin']
    assert program == [want] * 3
    assert [c for c in calls.values() if c[0] == 'jpeg.begin'] == \
        [['jpeg.begin', 'jpeg.dct', 'jpeg.scan']] * (3 * batch)
    assert {m.device.type for m in marks} == {'cuda'}


@pytest.mark.cuda
@pytest.mark.parametrize('keep_images', [True, False], ids=['images', 'JPEG only'])
def test_rig_drains_beside_a_paced_feed_on_card(dev, keep_images):
    """The rig at 1024x768, two captures of 12 and a partial one of 5,
    through the streaming executor with device JPEG, each run from a fresh
    processor: fed at once; paced by 1 s before each capture, so that each
    capture is drained before the next one's flush (`stream.early_drains`
    2); and paced by 20 ms, less than a capture's card
    time, so that the drainer's readbacks overlap the next flush and the
    partial batch's first call and its capture.  The paced runs' JFIF
    bytes and images equal the unpaced run's, bit for bit."""
    import time

    from tpu_darktable_torch.pipeline.image_processor import ImageProcessor
    from tpu_darktable_torch.pipeline.streaming import StreamingExecutor
    from tpu_darktable_torch.utils import timing

    cs = _camera('beetroot', 1024, 768)
    frames = _stream_frames(cs, 2 * 12 + 5, seed=44)

    def run(pace):
        def feed():
            for i, f in enumerate(frames):
                if i % 12 == 0:
                    time.sleep(pace)
                yield f

        timing.reset()
        proc = ImageProcessor.from_camera_settings(cs, device=dev)
        ex = StreamingExecutor(proc, batch_size=12, jpeg_quality=90, keep_images=keep_images,
                               device_jpeg=True)
        results = ex.run(feed())
        return results, timing.counters()['stream.early_drains']

    at_once, _ = run(0.0)
    for pace, want in ((1.0, 2), (0.02, None)):
        paced, early = run(pace)
        if want is not None:
            assert early == want, pace
        assert [r.name for r in paced] == [r.name for r in at_once] == [n for n, _ in frames]
        for a, b in zip(at_once, paced):
            assert a.error is None and b.error is None, (a.error, b.error)
            assert a.jpeg[:2] == b'\xff\xd8' and a.jpeg == b.jpeg, (pace, a.name)
            if keep_images:
                assert np.array_equal(a.image, b.image), (pace, a.name)
            else:
                assert a.image is None and b.image is None


@pytest.mark.cuda
def test_marks_sum_to_the_events_span_of_the_calls(dev):
    """FULL at 4096x3000, batches of 2 on the card, replayed: the card time
    from each call's first mark to its last, summed over four calls, is
    within 5% of the CUDA events' span around the same process_batch
    calls (which adds the graph's copy-in and the clones of its outputs)."""
    from test_torch_graph import case_frames, case_settings
    import tpu_darktable_torch as tt
    from tpu_darktable_torch.utils import timing

    w, h = 4096, 3000
    timing.reset()
    timing.enable()
    try:
        proc = tt.ImageProcessor((w, h), BayerPattern.RGGB, tt.PackedFormat.Packed12,
                                 case_settings('full'), device=dev,
                                 white_balance=(1.2, 1.0, 1.1))
        frames = case_frames(w, h, 2, seed=42).to(dev)
        proc.process_batch(frames)          # eager, then the capture
        proc.process_batch(frames)
        torch.cuda.synchronize()
        timing.reset()
        spans = []
        for _ in range(4):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            proc.process_batch(frames)
            ev[1].record()
            spans.append(ev)
        torch.cuda.synchronize()
        marks = timing.marks()
    finally:
        timing.disable()
    events_ms = sum(a.elapsed_time(b) for a, b in spans)
    calls = {}
    for m in marks:
        calls.setdefault(m.call, []).append(m.ns)
    assert len(calls) == 4
    marks_ms = sum(max(ns) - min(ns) for ns in calls.values()) * 1e-6
    assert 0.95 * events_ms <= marks_ms <= events_ms, (marks_ms, events_ms)


@pytest.mark.cuda
def test_traced_processor_on_a_card_that_is_not_the_current_one(dev):
    """With two cards or more: FULL at 256x192 through the streaming
    executor with device JPEG on cuda:1 while cuda:0 stays the current
    device.  With the tracer on, the eager first call, the capture, the
    replays and every JPEG encode mark on cuda:1's streams and ring, and
    the frames and JFIF bytes equal those with the tracer off."""
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two CUDA devices or more')
    card = torch.device('cuda', 1)
    torch.cuda.set_device(0)
    cs = _camera('artichoke', 256, 192)
    frames = _stream_frames(cs, 3 * 2, seed=43)
    plain, _ = _stream_through(card, cs, frames, 2, traced=False)
    traced, marks = _stream_through(card, cs, frames, 2, traced=True)
    assert torch.cuda.current_device() == 0
    for a, b in zip(plain, traced, strict=True):
        assert a.error is None and b.error is None
        assert np.array_equal(a.image, b.image) and a.jpeg == b.jpeg, a.name
    calls = {}
    for m in marks:
        calls.setdefault(m.call, []).append(m.name)
    assert sum(c[0] == 'begin' for c in calls.values()) == 3
    assert sum(c == ['jpeg.begin', 'jpeg.dct', 'jpeg.scan'] for c in calls.values()) == 6
    assert {m.device for m in marks} == {card}


@pytest.mark.cuda
@pytest.mark.parametrize('w,h', [(512, 384), (1024, 768), (4096, 3000)])
def test_laplacian_camera_card_against_the_cpu_path(dev, monkeypatch, w, h):
    """FULL with the local Laplacian, the benchmark's `artichoke_lap`
    settings, on a batch of 2 of its scenes: the card's uint8 output against
    the port's CPU path, with the bilateral stage on its kernel and on its
    plain version.  The kernel rounds as the CPU's plain chain does (bit for
    bit on the plane the program hands it); PyTorch's CUDA division by a
    Python scalar multiplies by the reciprocal, so the plain chain on the
    card departs from both.  The card-vs-CPU gap is then the same with
    either bilateral route (the card's plain stages', through the float16
    pyramids: 4, 8, 12 counts at these sizes), and the kernel route sits
    0-3 counts from the card's plain route, which the benchmark's reference
    follows.  Counts are printed for the record."""
    import tpu_darktable_torch.ops.bilateral as ops_bilateral
    from isp_bench import scene, spec
    from tpu_darktable_torch.pipeline.camera_settings import CameraSettings
    from tpu_darktable_torch.pipeline.image_processor import ImageProcessor

    cam = dict(spec.config('artichoke_lap')['camera'], image_size=[w, h])
    cs = CameraSettings.from_dict(cam)
    frames = torch.from_numpy(scene.frame_pool(cam, 2, 2**31 + 1234, 'cpu'))
    planes = []

    def kernel_route(lum, **kw):
        if not torch.cuda.is_current_stream_capturing():
            planes.append((lum.clone(), kw))
        return bilateral_band(lum, **kw)

    def run(device, route):
        monkeypatch.setattr(ops_bilateral, 'bilateral_band', route)
        proc = ImageProcessor.from_camera_settings(cs, device=device)
        return proc.process_batch(frames.to(device)).cpu().to(torch.int16)

    card = run(dev, kernel_route)
    card_plain = run(dev, bilateral_band_plain)
    cpu = run('cpu', bilateral_band_plain)

    def gap(a, b):
        d = (a - b).abs()
        return int(d.max()), float((d > 0).float().mean())

    to_cpu, plain_to_cpu, routes = gap(card, cpu), gap(card_plain, cpu), gap(card, card_plain)
    print(f'laplacian camera {w}x{h}: card vs cpu {to_cpu}, card (plain bilateral) vs cpu '
          f'{plain_to_cpu}, kernel vs plain route on the card {routes}')

    lum, kw = planes[0]
    assert torch.equal(bilateral_band(lum, **kw).cpu(), bilateral_band_plain(lum.cpu(), **kw))
    sr = kw['sigma_r']
    recip = torch.tensor(1.0) / torch.tensor(sr, dtype=torch.float32)
    assert torch.equal((lum / sr).cpu(), lum.cpu() * recip)
    assert not torch.equal((lum / sr).cpu(), lum.cpu() / sr)

    assert abs(to_cpu[0] - plain_to_cpu[0]) <= 1
    assert to_cpu[0] <= 12 and to_cpu[1] < 1e-3
    assert routes[0] <= 3 and routes[1] < 1e-4
