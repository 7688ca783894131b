"""The port's JPEG encoder against the JAX package's, on the CPU.

The DCT stage (ops/jpeg.py:_jpeg_device_stage) reproduces the arithmetic of
XLA's CPU code for the JAX stage (fused multiply-adds where XLA fuses them,
the dot's four accumulation chains), so the quantised coefficients are
compared coefficient for coefficient: each may differ by at most 1, and the
share that differs is stated and held at 0 (on this CPU none differs).  The
bitstreams are compared byte for byte with JAX's: with JAX's encode of the
same image where the coefficients agree, and always with JAX's entropy scan
of the port's own coefficients.  Pillow decodes every output (PSNR > 35 dB,
as tests/test_jpeg.py holds JAX's).
"""

import io

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from tpu_darktable import jpeg as jjpeg
from tpu_darktable.ops import jpeg as J

import tpu_darktable_torch as tt
from tpu_darktable_torch.native import get_lib, jpeg_encode_baseline_native
from tpu_darktable_torch.ops import jpeg as T

torch.set_num_threads(1)


def _test_image(h=96, w=128):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = 128 + 100 * np.sin(xx / 9.0)
    g = 128 + 80 * np.cos(yy / 13.0)
    b = 128 + 60 * np.sin((xx + yy) / 17.0)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _noisy_image(seed, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / 23) * np.cos(yy / 17), 128 + 70 * np.cos(xx / 11),
                    128 + 50 * np.sin((xx + yy) / 31)], -1)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0**2 / mse)


def _encode(img, *args, **kw):
    return T.encode_jpeg(img, *args, device='cpu', **kw)


def _as_input(img, fmt):
    """The (H, W, 3) RGB image laid out as input format `fmt`."""
    if fmt in (0, 2):
        img = img[..., ::-1]
    return np.ascontiguousarray(np.moveaxis(img, -1, 0) if fmt in (0, 1) else img)


def _stages(img, quality, fmt, subsampling):
    """(JAX blocks, port blocks, (h, w, qy, qc, n_comp)) of one image."""
    h, w, qy, qc, jb, n = J._prepare_device_stage(img, quality, fmt, subsampling)
    _, _, _, _, tb, _ = T._prepare_device_stage(img, quality, fmt, subsampling, 'cpu')
    return [np.asarray(b) for b in jb], [b.numpy() for b in tb], (h, w, qy, qc, n)


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('size', [(61, 45), (96, 128)])
@pytest.mark.parametrize('fmt', [3, 2, 1, 0], ids=['RGBI', 'BGRI', 'RGB', 'BGR'])
@pytest.mark.parametrize('subsampling', [0, 1, 2], ids=['444', '422', 'gray'])
def test_device_stage_matches_jax(subsampling, fmt, size, seed):
    """Quantised zigzag blocks against JAX's _jpeg_device_stage: the same
    shapes and dtype, each coefficient within 1, and none differs."""
    h, w = size
    img = _as_input(_noisy_image(seed, h, w), fmt)
    jb, tb, _ = _stages(img, 90, fmt, subsampling)
    assert [b.shape for b in tb] == [b.shape for b in jb]
    assert all(b.dtype == np.int16 for b in tb)
    diff = max(int(np.abs(a.astype(int) - b.astype(int)).max()) for a, b in zip(jb, tb))
    share = sum(int((a != b).sum()) for a, b in zip(jb, tb)) / sum(a.size for a in jb)
    assert diff <= 1, diff
    assert share == 0.0, f'{share:.3e} of the coefficients differ from JAX'


@pytest.mark.parametrize('quality', [1, 50, 90, 100])
def test_quality_to_tables(quality):
    for a, b in zip(J.quality_to_tables(quality), T.quality_to_tables(quality)):
        np.testing.assert_array_equal(a, b)


def _jax_bytes_of(tb, meta, subsampling, restart_interval):
    """JAX's host entropy scan of the port's blocks."""
    h, w, qy, qc, n = meta
    return J._host_entropy_bitstream([jnp.asarray(b) for b in tb], h, w, qy, qc, subsampling,
                                     n, restart_interval)


@pytest.mark.parametrize('restart_interval', [0, 5, None], ids=['off', '5', 'auto'])
@pytest.mark.parametrize('subsampling', [0, 1, 2], ids=['444', '422', 'gray'])
def test_host_entropy_bytes_match_jax(subsampling, restart_interval):
    img = _noisy_image(7, 80, 136)
    got = _encode(img, 90, 3, subsampling, restart_interval=restart_interval, entropy='host')
    jb, tb, meta = _stages(img, 90, 3, subsampling)
    ri = T._resolve_restart_interval(restart_interval, meta[1], subsampling, meta[4], tb)
    np.testing.assert_array_equal(got, _jax_bytes_of(tb, meta, subsampling, ri))
    if all(np.array_equal(a, b) for a, b in zip(jb, tb)):
        ref = J.encode_jpeg(img, 90, 3, subsampling, restart_interval=restart_interval,
                            entropy='host')
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('subsampling', [0, 1, 2], ids=['444', '422', 'gray'])
def test_progressive_bytes_match_jax(subsampling):
    img = _noisy_image(8, 72, 88)
    got = _encode(img, 92, 3, subsampling, progressive=True)
    jb, tb, (h, w, qy, qc, _) = _stages(img, 92, 3, subsampling)
    from tpu_darktable.ops.jpeg import _encode_progressive

    np.testing.assert_array_equal(got, _encode_progressive(tb, h, w, qy, qc, subsampling))
    if all(np.array_equal(a, b) for a, b in zip(jb, tb)):
        np.testing.assert_array_equal(
            got, J.encode_jpeg(img, 92, 3, subsampling, progressive=True))


def _decode(data, mode='RGB'):
    return np.asarray(Image.open(io.BytesIO(np.asarray(data).tobytes())).convert(mode))


def _luma(img):
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


@pytest.mark.parametrize('subsampling', [0, 1])
def test_encode_decodes(subsampling):
    img = _test_image()
    decoded = _decode(_encode(img, quality=94, input_format=3, subsampling=subsampling))
    assert decoded.shape == img.shape
    assert _psnr(img, decoded) > 35.0


def test_gray():
    img = _test_image()
    decoded = _decode(_encode(img, quality=90, input_format=3, subsampling=2), 'L')
    assert _psnr(_luma(img), decoded) > 35.0


def test_bgr_and_planar_formats():
    img = _test_image()
    bgr = _encode(img[..., ::-1].copy(), quality=94, input_format=2, subsampling=0)
    planar = _encode(np.moveaxis(img, -1, 0).copy(), quality=94, input_format=1, subsampling=0)
    assert _psnr(img, _decode(bgr)) > 35.0
    assert _psnr(img, _decode(planar)) > 35.0
    # a planar tensor input gives the bytes of the interleaved array
    np.testing.assert_array_equal(
        T.encode_jpeg(torch.from_numpy(np.moveaxis(img, -1, 0).copy()), 94, 1, 0),
        _encode(img, 94, 3, 0))


def test_quality_affects_size():
    img = _test_image()
    assert len(_encode(img, quality=95)) > len(_encode(img, quality=30))


def test_odd_sizes():
    img = _test_image(h=33, w=47)
    decoded = _decode(_encode(img, quality=90, subsampling=1))
    assert decoded.shape == img.shape
    assert _psnr(img, decoded) > 30.0


def test_wrapper_class():
    img = _test_image()
    data = tt.Jpeg().encode(img, quality=94, input_format=tt.InputFormat.RGBI, device='cpu')
    assert _psnr(img, _decode(data)) > 35.0
    ref = jjpeg.Jpeg().encode(img, quality=94, input_format=jjpeg.InputFormat.RGBI)
    np.testing.assert_array_equal(data, ref)


@pytest.mark.parametrize('subsampling', [0, 1, 2])
def test_progressive_decodes(subsampling):
    img = _test_image()
    data = _encode(img, quality=94, input_format=3, subsampling=subsampling, progressive=True)
    if subsampling == 2:
        assert _psnr(_luma(img), _decode(data, 'L')) > 35.0
    else:
        assert _psnr(img, _decode(data)) > 35.0


def test_progressive_blank_and_size():
    blank = np.full((64, 64, 3), 128, dtype=np.uint8)   # all-zero AC bands: EOB runs
    assert _psnr(blank, _decode(_encode(blank, quality=90, progressive=True))) > 40.0
    img = _test_image(160, 160)
    assert len(_encode(img, quality=94, progressive=True)) < \
        len(_encode(img, quality=94, progressive=False)) * 1.1


@pytest.mark.parametrize('subsampling', [0, 1, 2])
def test_restart_markers_decode_identical(subsampling):
    """The restart-interval scan carries a DRI segment and decodes to the
    pixels of the serial scan."""
    img = _test_image(80, 96)
    base = _encode(img, 90, 3, subsampling, restart_interval=0)
    rst = _encode(img, 90, 3, subsampling, restart_interval=5)
    assert b'\xff\xdd' not in base.tobytes()[:800]
    assert b'\xff\xdd' in rst.tobytes()[:800]
    np.testing.assert_array_equal(_decode(base), _decode(rst))


def test_restart_thread_count_invariant():
    assert get_lib() is not None, 'g++ builds the native library on this host'
    rng = np.random.default_rng(11)
    blocks = np.zeros((240, 64), np.int16)
    blocks[:, 0] = rng.integers(-200, 200, 240)
    blocks[rng.integers(0, 240, 900), rng.integers(1, 64, 900)] = \
        rng.integers(-40, 40, 900).astype(np.int16)
    H = T._HUFF
    tables = tuple((H[('dc', t)][0], H[('dc', t)][1], H[('ac', t)][0], H[('ac', t)][1])
                   for t in (0, 1))
    outs = [jpeg_encode_baseline_native([blocks], 2, tables, restart_interval=16, n_threads=nt)
            for nt in (1, 2, 5, 0)]
    for o in outs[1:]:
        np.testing.assert_array_equal(outs[0], o)


def test_restart_auto_threshold():
    """Auto stays off below 4096 MCUs and is one MCU row above."""
    small = _encode(_test_image(64, 64), 90, 3, 1)
    assert b'\xff\xdd' not in small.tobytes()[:800]
    big = _encode(_test_image(256, 512), 90, 3, 2)        # 32 x 64 = 2048 MCUs: off
    assert b'\xff\xdd' not in big.tobytes()[:800]
    bigger = _encode(_test_image(512, 512), 90, 3, 2)     # 4096 MCUs: a row of 64
    assert b'\xff\xdd\x00\x04\x00\x40' in bigger.tobytes()[:800]


def _raises(fn):
    with pytest.raises(Exception) as info:
        fn()
    return info


@pytest.mark.parametrize('case', ['dtype', 'interleaved_shape', 'planar_shape', 'entropy',
                                  'progressive_device', 'restart_16_bits'])
def test_errors_match_jax(case):
    """The same exception type (JpegException) and message as JAX's."""
    img = _test_image(16, 16)
    args = {
        'dtype': ((img.astype(np.float32),), {}),
        'interleaved_shape': ((img[..., :2].copy(),), {}),
        'planar_shape': ((img,), dict(input_format=1)),
        'entropy': ((img,), dict(entropy='devcie', progressive=True)),
        'progressive_device': ((img,), dict(entropy='device', progressive=True)),
        'restart_16_bits': ((img,), dict(restart_interval=70000)),
    }[case]
    j = _raises(lambda: J.encode_jpeg(*args[0], **args[1]))
    t = _raises(lambda: _encode(*args[0], **args[1]))
    assert j.type is J.JpegException and t.type is T.JpegException
    assert str(t.value) == str(j.value)


def test_array_input_needs_the_card_unless_cpu():
    """An array goes to the card by default; without one that raises, and
    nothing falls back to the CPU.  A tensor stays on its device."""
    img = _test_image(16, 16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='cuda'):
            T.encode_jpeg(img)
    np.testing.assert_array_equal(T.encode_jpeg(torch.from_numpy(img)), _encode(img))
