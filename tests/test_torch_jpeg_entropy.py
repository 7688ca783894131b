"""The port's device entropy scan on CPU tensors: byte for byte against the
native C++ scan (the oracle of tests/test_jpeg_entropy.py), the async split
against the synchronous encode, the overflow fallback against the host
path, and the bitstring concatenation against a Python model of bit strings
(words are 32-bit values carried in int64, masked after every left shift).

On a card (`-m cuda`; the module imports JAX only inside the one test that
compares with it, so it runs where JAX is not installed:
`python -m pytest tests/test_torch_jpeg_entropy.py -m cuda --noconftest`):
the hand kernel of csrc/jpeg_entropy.cu at the benchmark cells' frame
shapes against the native scan and the plain version run on the card, and
the JPEG graphs replaying it with their launch counts.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from tpu_darktable_torch import kernels
from tpu_darktable_torch.kernels.jpeg_entropy import jpeg_entropy, jpeg_entropy_plain
from tpu_darktable_torch.native import get_lib, jpeg_encode_baseline_native
from tpu_darktable_torch.ops import jpeg as T
from tpu_darktable_torch.ops import jpeg_entropy as te
from tpu_darktable_torch.utils import timing

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native():
    assert get_lib() is not None, 'g++ builds the native library on this host'


def _tables():
    H = T._HUFF
    return tuple((H[('dc', t)][0], H[('dc', t)][1], H[('ac', t)][0], H[('ac', t)][1])
                 for t in (0, 1))


def _image(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / 23) * np.cos(yy / 17), 128 + 70 * np.cos(xx / 11),
                    128 + 50 * np.sin((xx + yy) / 31)], -1)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


def _blocks_for(rng, h, w, subsampling, quality=90):
    """Realistic quantized blocks: smooth image + noise through the port's
    DCT stage, as CPU tensors."""
    qy, qc = T.quality_to_tables(quality)
    return T._jpeg_device_stage(torch.from_numpy(_image(rng, h, w)),
                                torch.from_numpy(qy.astype(np.float32)),
                                torch.from_numpy(qc.astype(np.float32)),
                                subsampling=subsampling, swap_br=False)


def _native_body(comp_blocks, subsampling, restart_interval):
    return jpeg_encode_baseline_native([np.asarray(b) for b in comp_blocks], subsampling,
                                       _tables(), restart_interval=restart_interval)


@pytest.mark.parametrize('subsampling', [0, 1, 2])
@pytest.mark.parametrize('restart_interval', [0, 5, 16])
def test_device_entropy_matches_native(rng, subsampling, restart_interval):
    comp_blocks = _blocks_for(rng, 48, 80, subsampling)
    ref = _native_body(comp_blocks, subsampling, restart_interval)
    got = te.entropy_encode_device(comp_blocks, subsampling, restart_interval)
    assert got is not None
    np.testing.assert_array_equal(got, ref)
    # and JAX's device scan of the same blocks
    from tpu_darktable.ops import jpeg_entropy as jje

    np.testing.assert_array_equal(
        got, jje.entropy_encode_device([b.numpy() for b in comp_blocks], subsampling,
                                       restart_interval))


def test_device_entropy_extreme_coefficients():
    """Hand-built blocks hitting ZRL folding (runs of 16/32/48 zeros),
    all-zero AC, EOB-less blocks (nonzero at position 63), and large
    magnitudes (10-bit sizes)."""
    blocks = np.zeros((8, 64), dtype=np.int16)
    blocks[0, 0] = 500
    blocks[1, 0] = -500                      # big negative DC swing
    blocks[1, 63] = 3                        # no EOB
    blocks[2, 0] = 0                         # all-zero AC -> immediate EOB
    blocks[3, 1] = 1
    blocks[3, 18] = -1                       # run of 16 -> 1 ZRL
    blocks[4, 1] = 2
    blocks[4, 34] = -7                       # run of 32 -> 2 ZRLs
    blocks[5, 1] = 1
    blocks[5, 50] = 1023                     # run of 48 -> 3 ZRLs, size 10
    blocks[6, 2] = -1023
    blocks[7, 63] = -1                       # lone last coefficient
    for ri in (0, 3):
        got = te.entropy_encode_device([torch.from_numpy(blocks)], 2, ri)
        assert got is not None, ri
        np.testing.assert_array_equal(got, _native_body([blocks], 2, ri))


def test_device_entropy_random_blocks(rng):
    """Adversarial random coefficients (dense, large) across 444 MCUs."""
    mk = lambda n: (rng.integers(-80, 80, (n, 64)) *
                    (rng.random((n, 64)) < 0.25)).astype(np.int16)
    comp_blocks = [mk(12), mk(12), mk(12)]
    for ri in (0, 4):
        got = te.entropy_encode_device([torch.from_numpy(b) for b in comp_blocks], 0, ri,
                                       cap_bytes_per_interval=1 << 16)
        assert got is not None
        np.testing.assert_array_equal(got, _native_body(comp_blocks, 0, ri))


def test_device_entropy_overflow_returns_none(rng):
    """A tiny capacity must be detected, not silently truncated."""
    comp_blocks = _blocks_for(rng, 48, 80, 2)
    assert te.entropy_encode_device(comp_blocks, 2, 4, cap_bytes_per_interval=8) is None


def test_full_encode_device_entropy_matches_host(rng):
    """encode_jpeg(entropy='device') == encode_jpeg(entropy='host'), whole
    file, for every subsampling and restart mode."""
    img = _image(rng, 56, 72)
    for subsampling, ri in ((0, None), (1, 0), (2, 7), (1, 3)):
        host = T.encode_jpeg(img, quality=88, subsampling=subsampling, restart_interval=ri,
                             entropy='host', device='cpu')
        dev = T.encode_jpeg(img, quality=88, subsampling=subsampling, restart_interval=ri,
                            entropy='device', device='cpu')
        np.testing.assert_array_equal(dev, host)


def test_entropy_auto_and_env(rng, monkeypatch):
    """'auto' picks the host scan for a CPU tensor; TD_JPEG_DEVICE_ENTROPY=1
    forces the device scan, with the same bytes."""
    img = torch.from_numpy(_image(rng, 40, 48))
    calls = []
    real = T._dispatch   # the encoder's device scan, through its graph
    monkeypatch.setattr(T, '_dispatch', lambda *a, **k: calls.append(1) or real(*a, **k))
    auto = T.encode_jpeg(img, quality=90)
    assert calls == []
    monkeypatch.setenv('TD_JPEG_DEVICE_ENTROPY', '1')
    np.testing.assert_array_equal(T.encode_jpeg(img, quality=90), auto)
    assert calls == [1]


def _async_images():
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    img = np.clip(np.stack([128 + 100 * np.sin(xx / 9.0), 128 + 80 * np.cos(yy / 13.0),
                            128 + 60 * np.sin((xx + yy) / 17.0)], -1), 0, 255).astype(np.uint8)
    return [img, np.ascontiguousarray(img[:64, :80][:, ::-1])]


def test_encode_async_matches_sync():
    """encode_jpeg_async (enqueue now, finalize later) gives the bytes of the
    synchronous device-entropy path, also with both dispatched before either
    is finalized (the streaming double-buffer pattern)."""
    imgs = _async_images()
    sync = [T.encode_jpeg(im, quality=90, entropy='device', device='cpu') for im in imgs]
    handles = [T.encode_jpeg_async(im, quality=90, device='cpu') for im in imgs]
    for h, s in zip(handles, sync):
        np.testing.assert_array_equal(h.result(), s)


def test_encode_async_overflow_host_fallback():
    """A tiny per-interval capacity forces the overflow; PendingJpeg falls
    back to the host path, with its bytes."""
    img = _async_images()[0]
    host = T.encode_jpeg(img, quality=90, entropy='host', device='cpu')
    pend = T.encode_jpeg_async(img, quality=90, device='cpu')
    pend._pending = te.entropy_encode_device_dispatch(
        pend._comp_blocks_dev, 1, pend._meta[-1], cap_bytes_per_interval=8)
    np.testing.assert_array_equal(pend.result(), host)


def test_jpeg_wrapper_encode_async():
    from tpu_darktable_torch.jpeg import Jpeg

    img = _async_images()[0]
    got = Jpeg().encode_async(img, quality=92, device='cpu').result()
    np.testing.assert_array_equal(got, Jpeg().encode(img, quality=92, entropy='device',
                                                     device='cpu'))


def _to_bits(words, length):
    return ''.join(format(int(w), '032b') for w in words)[:length]


def _strings(draw_lists):
    """Left-aligned bitstrings (one row each) of the given bit strings."""
    n_w = max(1, max((len(s) + 31) // 32 for s in draw_lists))
    words = np.zeros((len(draw_lists), n_w), np.int64)
    for i, s in enumerate(draw_lists):
        padded = s + '0' * (n_w * 32 - len(s))
        words[i] = [int(padded[j:j + 32], 2) for j in range(0, n_w * 32, 32)]
    return torch.from_numpy(words), torch.tensor([len(s) for s in draw_lists])


@settings(max_examples=60, deadline=None)
@given(st.lists(st.text(alphabet='01', max_size=100), min_size=1, max_size=9),
       st.integers(min_value=1, max_value=8))
def test_concat_pairs_matches_bit_strings(bit_strings, out_w):
    """One doubling level joins pairs of strings exactly as string
    concatenation does, truncated to out_w words; the odd string passes
    through; lengths stay exact; every word stays a 32-bit value."""
    words, lens = _strings(bit_strings)
    out, out_l = te._concat_pairs(words, lens, out_w)
    pairs = [bit_strings[i] + bit_strings[i + 1] for i in range(0, len(bit_strings) - 1, 2)]
    if len(bit_strings) % 2:
        pairs.append(bit_strings[-1])
    assert out.shape == (len(pairs), out_w)
    assert ((out >= 0) & (out <= 0xFFFFFFFF)).all()
    for row, n, want in zip(out, out_l, pairs):
        assert int(n) == len(want)
        cap = min(len(want), out_w * 32)
        assert _to_bits(row, cap) == want[:cap]
        assert _to_bits(row, out_w * 32)[cap:] == '0' * (out_w * 32 - cap)



@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; chip_smoke.py runs the scan kernel on the card')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('h,w,ri', [(4096, 3000, 188), (2472, 2062, 129)])
def test_kernel_scan_at_cell_shapes_on_card(card, h, w, ri):
    """The benchmark cells' frames after their rotation (artichoke 3000x4096,
    the rig's 2062x2472), 4:2:2 q90 at the auto restart interval: the
    kernel's stream and small readback equal the plain version's run on the
    card, word for word, and its JFIF bytes the native host scan's."""
    img = torch.from_numpy(_image(np.random.default_rng(h), h, w)).to(card)
    qy, qc = T.quality_to_tables(90)
    blocks = T._jpeg_device_stage(img, torch.from_numpy(qy.astype(np.float32)).to(card),
                                  torch.from_numpy(qc.astype(np.float32)).to(card),
                                  subsampling=1, swap_br=False)
    assert T._resolve_restart_interval(None, w, 1, 3, blocks) == ri
    cap_words = ri * 4 * 40 // 4
    kernels.reset_launches()
    words, small = jpeg_entropy(blocks, 1, ri, cap_words)
    assert kernels.launches['jpeg_entropy'] == 3
    plain_words, plain_small = jpeg_entropy_plain(blocks, 1, ri, cap_words)
    assert torch.equal(small, plain_small) and not small[-1]
    assert torch.equal(words, plain_words)
    host = T.encode_jpeg(img, 90, entropy='host')
    np.testing.assert_array_equal(T.encode_jpeg(img, 90, entropy='device'), host)
    body = te.entropy_encode_device_finalize({'stream': words.cpu(), 'small': small.cpu(),
                                              'n_iv': small.numel() - 2, 'event': None})
    np.testing.assert_array_equal(body, _native_body([b.cpu() for b in blocks], 1, ri))


@pytest.mark.cuda
@pytest.mark.parametrize('h,w', [(480, 640), (1080, 1920)])
def test_jpeg_graphs_replay_the_kernel_on_card(card, h, w):
    """A Jpeg's scan graph replays the kernel: its first encode runs it
    eagerly (3 launches counted) and captures it, each replay adds the 3
    its capture record holds; the bytes equal the host scan's, through
    encode and encode_async, and no encode falls back to the host at q90
    (at 1080x1920 one interval a row of MCUs, at 480x640 one a frame)."""
    from tpu_darktable_torch.jpeg import Jpeg

    img = torch.from_numpy(_image(np.random.default_rng(w), h, w)).to(card)
    host = T.encode_jpeg(img, 90, entropy='host')
    jpeg = Jpeg()
    fallbacks = timing.counters().get('jpeg.host_fallbacks', 0)
    kernels.reset_launches()
    np.testing.assert_array_equal(jpeg.encode(img, 90), host)
    assert kernels.launches['jpeg_entropy'] == 3
    assert len(jpeg._stages.scan._captured) == 1
    for n in range(2, 5):
        np.testing.assert_array_equal(jpeg.encode(img, 90), host)
        assert kernels.launches['jpeg_entropy'] == 3 * n
    pending = [jpeg.encode_async(img, 90) for _ in range(2)]
    for p in pending:
        np.testing.assert_array_equal(p.result(), host)
    assert kernels.launches['jpeg_entropy'] == 3 * 6
    assert len(jpeg._stages.scan._captured) == 1
    assert timing.counters().get('jpeg.host_fallbacks', 0) == fallbacks
