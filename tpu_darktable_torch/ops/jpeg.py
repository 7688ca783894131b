"""Baseline and progressive JPEG encoder (counterpart of
tpu_darktable/ops/jpeg.py): the DCT stage on the image's device, the
entropy scan on the device or on the host.

- colour conversion, chroma subsampling, the 8x8 DCT, quantisation and
  zigzag run as torch ops on the image's device (`_jpeg_device_stage`);
- the entropy scan runs either on the device (ops/jpeg_entropy.py: only the
  packed stream is read back) or on the host (the native C++ scan of
  native/bitpack.cpp, with a numpy version for a host without a compiler);
- `progressive=True` encodes spectral-selection scans with optimised
  Huffman tables on the host (ops/jpeg_progressive.py).

Where the JAX package jits the DCT stage and the device entropy scan, the
port runs them through `_graph.Graphed` (`_Stages`): on a card the first
call of each key runs eagerly and captures a CUDA graph, later calls
replay it.  The DCT stage is keyed on the image's shape and device,
`subsampling` and `swap_br`; the quant tables are tensor arguments, so
every quality replays one capture with its own tables.  The scan is keyed
on the block shapes, `subsampling`, the restart interval and the capacity.
A `tpu_darktable_torch.jpeg.Jpeg` owns its pair; the free functions here
share one.  The constants both read (the DCT matrix, the zigzag order, the
Huffman tables) are device constants made once per device
(`_device.constant_on`), never host copies, which a replay could not
repeat.

The bytes are the JAX package's for the same coefficients.  The device
stage reproduces the arithmetic of the JAX stage as XLA compiles it for
the CPU: products and sums in a fixed order, a fused multiply-add where
XLA fuses one (taken in float64, where the product of two float32 values
is exact, then rounded once to float32).  Every op is elementwise, so the
card and the CPU compute the same bits.  quality -> table scaling follows
libjpeg.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .._device import constant_on, resolve_device
from .._graph import GraphPool, Graphed
from ..native import jpeg_encode_baseline_native, pack_bits
from ..utils import timing
from .jpeg_entropy import _dispatch, _scan, entropy_encode_device_finalize


class JpegException(Exception):
    """Mirror of the reference JpegException (csrc/jpeg_encoder.h:20-27)."""


# ---------------------------------------------------------------------------
# Tables (ITU-T T.81 Annex K)
# ---------------------------------------------------------------------------

_QUANT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int32).reshape(8, 8)

_QUANT_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
], dtype=np.int32).reshape(8, 8)

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10,
    17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)

_DC_LUMA_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
_DC_LUMA_VALS = list(range(12))
_DC_CHROMA_BITS = [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]
_DC_CHROMA_VALS = list(range(12))

_AC_LUMA_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
_AC_LUMA_VALS = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
    0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
    0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
    0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
    0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
]
_AC_CHROMA_BITS = [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]
_AC_CHROMA_VALS = [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
    0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
    0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
    0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
    0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
    0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
]


def _canonical_codes(bits, vals):
    """(code, length) lookup arrays indexed by symbol value."""
    codes = np.zeros(256, dtype=np.uint32)
    lengths = np.zeros(256, dtype=np.uint8)
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = code
            lengths[vals[k]] = length
            code += 1
            k += 1
        code <<= 1
    return codes, lengths


_HUFF = {
    ('dc', 0): _canonical_codes(_DC_LUMA_BITS, _DC_LUMA_VALS),
    ('ac', 0): _canonical_codes(_AC_LUMA_BITS, _AC_LUMA_VALS),
    ('dc', 1): _canonical_codes(_DC_CHROMA_BITS, _DC_CHROMA_VALS),
    ('ac', 1): _canonical_codes(_AC_CHROMA_BITS, _AC_CHROMA_VALS),
}


def quality_to_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """libjpeg/nvJPEG quality scaling of the Annex-K tables."""
    quality = int(np.clip(quality, 1, 100))
    scale = 5000 // quality if quality < 50 else 200 - quality * 2

    def _scale(base):
        t = (base.astype(np.int64) * scale + 50) // 100
        return np.clip(t, 1, 255).astype(np.int32)

    return _scale(_QUANT_LUMA), _scale(_QUANT_CHROMA)


def _dct_matrix() -> np.ndarray:
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    m = 0.5 * np.cos((2 * x + 1) * u * np.pi / 16.0)
    m[0] *= 1.0 / np.sqrt(2.0)
    return m.astype(np.float32)


# the DCT matrix's float32 values as float64, and the zigzag order, which
# the device stage takes from the device caches
_DCT64 = _dct_matrix().astype(np.float64)
_ZIGZAG64 = _ZIGZAG.astype(np.int64)


# ---------------------------------------------------------------------------
# The device stage
# ---------------------------------------------------------------------------

def _f32(c: float) -> float:
    """The float32 value of a constant, as the float64 that equals it."""
    return float(np.float32(c))


def _fma(a: torch.Tensor, c, acc: torch.Tensor | None) -> torch.Tensor:
    """float32(a * c + acc) with one rounding: the product of two float32
    values is exact in float64.  `c` is a float32 value (a Python float from
    _f32, or a float64 tensor holding float32 values)."""
    p = a.double() * c
    return (p if acc is None else p + acc.double()).float()


def _dct_rows(a: torch.Tensor, d64: torch.Tensor) -> torch.Tensor:
    """out[..., u] = sum_k a[..., k] * d[u, k], summed as XLA's CPU dot
    emitter sums 8 terms: four fused multiply-add chains over k = s, s + 4,
    then (c0 + c1) + (c2 + c3)."""
    chains = []
    for s in range(4):
        acc = _fma(a[..., s, None], d64[:, s], None)
        chains.append(_fma(a[..., s + 4, None], d64[:, s + 4], acc))
    return (chains[0] + chains[1]) + (chains[2] + chains[3])


def _plane_to_quantized_blocks(plane: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """(H8, W8) plane (level-shifted float32) -> (n_blocks, 64) int16 zigzag."""
    h, w = plane.shape
    dev = plane.device
    blocks = plane.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3).reshape(-1, 8, 8)
    d64 = constant_on(_DCT64, dev)
    # f[n, u, v] = sum_x sum_y d[u, x] b[n, x, y] d[v, y]: x first, as XLA
    # orders the einsum's two dots
    t = _dct_rows(blocks.transpose(1, 2), d64)      # (n, y, u)
    f = _dct_rows(t.transpose(1, 2), d64)           # (n, u, v)
    # A tensor divisor: CUDA divides by a Python scalar as a product with its
    # reciprocal.  torch.round rounds half to even, as jnp.round does.
    # int16 halves the readback; |DCT| <= 8 * 128 and q >= 1, so it fits.
    q = torch.round(f / qtable).to(torch.int16)
    zz = constant_on(_ZIGZAG64, dev)
    return q.reshape(-1, 64).index_select(1, zz)


def _pad_to(x: torch.Tensor, mh: int, mw: int) -> torch.Tensor:
    """Edge padding of an (H, W) plane up to multiples of (mh, mw)."""
    h, w = x.shape
    ph = (mh - h % mh) % mh
    pw = (mw - w % mw) % mw
    if pw:
        x = torch.cat([x, x[:, -1:].expand(h, pw)], dim=1)
    if ph:
        x = torch.cat([x, x[-1:].expand(ph, x.shape[1])], dim=0)
    return x


def _jpeg_device_stage(image_u8: torch.Tensor, qy: torch.Tensor, qc: torch.Tensor,
                       subsampling: int, swap_br: bool):
    """uint8 (H, W, 3) image -> per-component quantized zigzag blocks, on the
    image's device.  qy, qc: (8, 8) float32 tables on that device."""
    img = image_u8.to(torch.float32)
    if swap_br:
        img = img.flip(-1)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    # XLA's CPU code fuses a product into the add or subtract that follows it
    y = _fma(b, _f32(0.114), _fma(r, _f32(0.299), g * _f32(0.587))) - 128.0

    if subsampling == 2:  # GRAY
        return (_plane_to_quantized_blocks(_pad_to(y, 8, 8), qy),)

    cb = _fma(b, 0.5, _fma(r, _f32(-0.168735892), -(g * _f32(0.331264108))))
    cr = _fma(b, _f32(-0.081312411), _fma(r, 0.5, -(g * _f32(0.418687589))))

    if subsampling == 1:  # 422
        yp = _pad_to(y, 8, 16)
        cbp = _pad_to(cb, 8, 16)
        crp = _pad_to(cr, 8, 16)
        cb_ds = (cbp[:, 0::2] + cbp[:, 1::2]) * 0.5
        cr_ds = (crp[:, 0::2] + crp[:, 1::2]) * 0.5
        return (
            _plane_to_quantized_blocks(yp, qy),
            _plane_to_quantized_blocks(cb_ds, qc),
            _plane_to_quantized_blocks(cr_ds, qc),
        )

    # 444
    return (
        _plane_to_quantized_blocks(_pad_to(y, 8, 8), qy),
        _plane_to_quantized_blocks(_pad_to(cb, 8, 8), qc),
        _plane_to_quantized_blocks(_pad_to(cr, 8, 8), qc),
    )


class _Stages:
    """The encoder's two compiled programs, the counterparts of JAX's jitted
    `_jpeg_device_stage` and `_entropy_pack_device`, on one GraphPool
    (`pool`, a new one if None).  Their captures go when the owner drops
    them."""

    def __init__(self, pool: GraphPool | None = None):
        self.dct = Graphed(_jpeg_device_stage, pool)
        self.scan = Graphed(_scan, self.dct.pool)


# the free functions' programs (a Jpeg owns its own)
_FREE = _Stages()


def _bit_size(v: np.ndarray) -> np.ndarray:
    """JPEG magnitude category: bits needed for |v| (0 for 0)."""
    a = np.abs(v.astype(np.int64))
    size = np.zeros(a.shape, dtype=np.int64)
    nz = a > 0
    size[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return size


def _extra_bits(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    """Amplitude bits: v if v >= 0 else v - 1 masked to `size` bits."""
    v64 = v.astype(np.int64)
    raw = np.where(v64 >= 0, v64, v64 - 1)
    mask = (1 << size) - 1
    return (raw & mask).astype(np.uint32)


def _component_emissions(blocks: np.ndarray, ranks: np.ndarray, table_id: int):
    """Vectorized (code, length, sort-key) emission streams for one component.

    blocks: (N, 64) int32 zigzag coefficients in component scan order.
    ranks: (N,) global block rank in the interleaved MCU stream.
    """
    n = blocks.shape[0]
    dc_codes_lut, dc_lens_lut = _HUFF[('dc', table_id)]
    ac_codes_lut, ac_lens_lut = _HUFF[('ac', table_id)]

    # --- DC ---
    dc = blocks[:, 0].astype(np.int64)
    diff = np.diff(dc, prepend=0)
    size = _bit_size(diff)
    hcode = dc_codes_lut[size]
    hlen = dc_lens_lut[size].astype(np.int64)
    extra = _extra_bits(diff, size)
    dc_code = (hcode.astype(np.uint64) << size.astype(np.uint64)) | extra
    dc_len = hlen + size
    dc_key_rank = ranks
    dc_key_order = np.zeros(n, dtype=np.int64)

    # --- AC ---
    ac = blocks[:, 1:].astype(np.int64)  # (N, 63)
    nz = ac != 0
    idx = np.broadcast_to(np.arange(63, dtype=np.int64), ac.shape)
    prev = np.where(nz, idx, -1)
    prev_max = np.maximum.accumulate(prev, axis=1)
    prev_before = np.concatenate(
        [np.full((n, 1), -1, dtype=np.int64), prev_max[:, :-1]], axis=1
    )
    run = idx - prev_before - 1

    bi, pi = np.nonzero(nz)
    vals = ac[bi, pi]
    runs = run[bi, pi]
    zrl_count = runs // 16
    rrem = runs % 16
    sizes = _bit_size(vals)
    sym = (rrem << 4) | sizes
    sym_code = (
        (ac_codes_lut[sym].astype(np.uint64) << sizes.astype(np.uint64))
        | _extra_bits(vals, sizes)
    )
    sym_len = ac_lens_lut[sym].astype(np.int64) + sizes

    # expand each nonzero into (zrl_count ZRLs + 1 symbol)
    reps = zrl_count + 1
    total = int(reps.sum())
    gid = np.repeat(np.arange(len(bi)), reps)
    starts = np.cumsum(reps) - reps
    pos_in_group = np.arange(total) - starts[gid]
    is_sym = pos_in_group == zrl_count[gid]
    zrl_code = np.uint64(ac_codes_lut[0xF0])
    zrl_len = int(ac_lens_lut[0xF0])
    ac_code = np.where(is_sym, sym_code[gid], zrl_code)
    ac_len = np.where(is_sym, sym_len[gid], zrl_len)
    ac_key_rank = ranks[bi[gid]]
    # intra-block order: 1.. in stream order (already sorted by (block, pos))
    block_change = np.diff(bi[gid], prepend=-1) != 0
    ac_order = np.arange(total) - np.maximum.accumulate(np.where(block_change, np.arange(total), 0)) + 1

    # --- EOB: blocks whose last nonzero is before position 62 (or empty) ---
    any_nz = nz.any(axis=1)
    last_nz = np.where(any_nz, prev_max[:, -1], -1)
    needs_eob = last_nz < 62
    eob_blocks = np.nonzero(needs_eob)[0]
    eob_code = np.full(len(eob_blocks), ac_codes_lut[0x00], dtype=np.uint64)
    eob_len = np.full(len(eob_blocks), ac_lens_lut[0x00], dtype=np.int64)
    eob_rank = ranks[eob_blocks]
    eob_order = np.full(len(eob_blocks), 1 << 20, dtype=np.int64)

    codes = np.concatenate([dc_code, ac_code.astype(np.uint64), eob_code])
    lens = np.concatenate([dc_len, ac_len, eob_len])
    key_rank = np.concatenate([dc_key_rank, ac_key_rank, eob_rank])
    key_order = np.concatenate([dc_key_order, ac_order, eob_order])
    return codes, lens, key_rank, key_order


def _component_ranks(n_blocks: int, comp: int, subsampling: int, n_comp: int):
    """Global rank of each block of component `comp` in the MCU stream."""
    b = np.arange(n_blocks, dtype=np.int64)
    if n_comp == 1:
        return b
    if subsampling == 1:  # 422: MCU = [Y0, Y1, Cb, Cr]
        if comp == 0:
            return (b // 2) * 4 + (b % 2)
        return b * 4 + 1 + comp  # comp 1 -> +2, comp 2 -> +3
    return b * n_comp + comp  # 444


def _u16(v):
    return bytes([(v >> 8) & 0xFF, v & 0xFF])


def _dht_segment(bits, vals, tc, th) -> bytes:
    payload = bytes(bits) + bytes(vals)
    return b'\xff\xc4' + _u16(3 + len(payload)) + bytes([(tc << 4) | th]) + payload


def _encode_progressive(comp_blocks, h, w, qy, qc, subsampling: int) -> np.ndarray:
    """Progressive (spectral selection) bitstream with optimized Huffman:
    one interleaved DC scan, then one full-band AC scan per component."""
    from .jpeg_progressive import (
        ac_scan_symbols,
        build_optimal_huffman,
        dc_scan_symbols,
        encode_scan,
    )

    n_comp = len(comp_blocks)
    out = bytearray()
    out += b'\xff\xd8'
    out += b'\xff\xe0' + _u16(16) + b'JFIF\x00\x01\x01\x00' + _u16(1) + _u16(1) + b'\x00\x00'

    def _dqt(table, tid):
        return b'\xff\xdb' + _u16(67) + bytes([tid]) + bytes(
            int(table.reshape(-1)[_ZIGZAG[i]]) for i in range(64)
        )

    out += _dqt(qy, 0)
    if n_comp == 3:
        out += _dqt(qc, 1)

    # SOF2 = progressive DCT
    out += b'\xff\xc2' + _u16(8 + 3 * n_comp) + bytes([8]) + _u16(h) + _u16(w) + bytes([n_comp])
    if n_comp == 1:
        out += bytes([1, 0x11, 0])
    else:
        y_sampling = 0x21 if subsampling == 1 else 0x11
        out += bytes([1, y_sampling, 0, 2, 0x11, 1, 3, 0x11, 1])

    ranks = [
        _component_ranks(cb.shape[0], comp, subsampling, n_comp)
        for comp, cb in enumerate(comp_blocks)
    ]

    # ---- DC scan (interleaved, Ss=Se=0) ----
    syms, extra, sizes, comps = dc_scan_symbols(comp_blocks, ranks)
    tbl_of_comp = np.where(comps == 0, 0, 1)
    dc_tables = {}
    for tid in sorted(set(tbl_of_comp.tolist())):
        freqs = np.bincount(syms[tbl_of_comp == tid], minlength=256)
        dc_tables[tid] = build_optimal_huffman(freqs)
        out += _dht_segment(dc_tables[tid][0], dc_tables[tid][1], 0, tid)

    hcodes = np.zeros(len(syms), dtype=np.uint64)
    hlens = np.zeros(len(syms), dtype=np.int64)
    for tid, (_, _, codes, lens) in dc_tables.items():
        sel = tbl_of_comp == tid
        hcodes[sel] = codes[syms[sel]]
        hlens[sel] = lens[syms[sel]]
    merged = (hcodes << sizes.astype(np.uint64)) | extra.astype(np.uint64)
    mlens = hlens + sizes
    body = pack_bits(merged.astype(np.uint32), mlens.astype(np.uint8))

    out += b'\xff\xda' + _u16(6 + 2 * n_comp) + bytes([n_comp])
    if n_comp == 1:
        out += bytes([1, 0x00])
    else:
        out += bytes([1, 0x00, 2, 0x10, 3, 0x10])
    out += bytes([0, 0, 0x00])  # Ss=0, Se=0, AhAl=0
    out += bytes(body)

    # ---- AC scans (non-interleaved, Ss=1, Se=63) ----
    for comp, blocks in enumerate(comp_blocks):
        th = 0 if comp == 0 else 1
        s, e, el = ac_scan_symbols(blocks)
        freqs = np.bincount(s, minlength=256)
        if freqs.sum() == 0:
            freqs[0x00] = 1  # degenerate empty scan still needs a table
        bits, vals, codes, lens = build_optimal_huffman(freqs)
        out += _dht_segment(bits, vals, 1, th)
        body = encode_scan(s, e, el, codes, lens)
        out += b'\xff\xda' + _u16(6 + 2) + bytes([1, comp + 1, (0 << 4) | th])
        out += bytes([1, 63, 0x00])  # Ss=1, Se=63, AhAl=0
        out += bytes(body)

    out += b'\xff\xd9'
    return np.frombuffer(bytes(out), dtype=np.uint8)


def _build_headers(h, w, qy, qc, subsampling: int, n_comp: int,
                   restart_interval: int = 0) -> bytes:
    out = bytearray()
    out += b'\xff\xd8'  # SOI
    out += b'\xff\xe0' + _u16(16) + b'JFIF\x00\x01\x01\x00' + _u16(1) + _u16(1) + b'\x00\x00'

    def _dqt(table, tid):
        return b'\xff\xdb' + _u16(67) + bytes([tid]) + bytes(
            int(table.reshape(-1)[_ZIGZAG[i]]) for i in range(64)
        )

    out += _dqt(qy, 0)
    if n_comp == 3:
        out += _dqt(qc, 1)

    # SOF0
    out += b'\xff\xc0' + _u16(8 + 3 * n_comp) + bytes([8]) + _u16(h) + _u16(w) + bytes([n_comp])
    if n_comp == 1:
        out += bytes([1, 0x11, 0])
    else:
        y_sampling = 0x21 if subsampling == 1 else 0x11
        out += bytes([1, y_sampling, 0])
        out += bytes([2, 0x11, 1])
        out += bytes([3, 0x11, 1])

    def _dht(bits, vals, tc, th):
        payload = bytes(bits) + bytes(vals)
        return b'\xff\xc4' + _u16(3 + len(payload)) + bytes([(tc << 4) | th]) + payload

    out += _dht(_DC_LUMA_BITS, _DC_LUMA_VALS, 0, 0)
    out += _dht(_AC_LUMA_BITS, _AC_LUMA_VALS, 1, 0)
    if n_comp == 3:
        out += _dht(_DC_CHROMA_BITS, _DC_CHROMA_VALS, 0, 1)
        out += _dht(_AC_CHROMA_BITS, _AC_CHROMA_VALS, 1, 1)

    if restart_interval > 0:  # DRI (T.81 B.2.4.4)
        out += b'\xff\xdd' + _u16(4) + _u16(restart_interval)

    # SOS
    out += b'\xff\xda' + _u16(6 + 2 * n_comp) + bytes([n_comp])
    if n_comp == 1:
        out += bytes([1, 0x00])
    else:
        out += bytes([1, 0x00, 2, 0x11, 3, 0x11])
    out += bytes([0, 63, 0])
    return bytes(out)


def _use_device_entropy(entropy: str, blocks: torch.Tensor) -> bool:
    if entropy != 'auto':
        return entropy == 'device'
    env = os.environ.get('TD_JPEG_DEVICE_ENTROPY')
    if env is not None:
        return env.lower() not in ('0', 'false', '')
    return blocks.is_cuda


def encode_jpeg(
    image,
    quality: int = 94,
    input_format: int = 3,
    subsampling: int = 1,
    progressive: bool = False,
    restart_interval: int | None = None,
    entropy: str = 'auto',
    device=None,
) -> np.ndarray:
    """Encode a uint8 image to a baseline JFIF bitstream.

    Args:
        image: (H, W, 3) interleaved (formats RGBI=3 / BGRI=2) or (3, H, W)
            planar (RGB=1 / BGR=0) uint8 tensor or array.  A tensor is
            encoded on its own device; an array goes to `device`.
        quality: 1-100 (libjpeg semantics).
        input_format: 0=BGR, 1=RGB, 2=BGRI, 3=RGBI (csrc/jpeg_encoder.h:6-11).
        subsampling: 0=444, 1=422, 2=GRAY (csrc/jpeg_encoder.h:13-17).
        progressive: spectral-selection progressive with optimized Huffman
            (matching the reference's nvJPEG configuration).
        restart_interval: MCUs per restart interval.  None = auto (one MCU
            row on large images - the host scan then runs in threads, one
            interval each); 0 = off; > 0 = explicit.
        entropy: 'device' packs the entropy stream on the image's device and
            reads back only the compressed bytes; 'host' reads back the int16
            coefficients and packs them on the CPU; 'auto' (default) picks
            'device' for a CUDA tensor, 'host' otherwise.  Env override:
            TD_JPEG_DEVICE_ENTROPY=0/1.  Identical bytes either way; a
            device capacity overflow falls back to 'host' automatically.
        device: where an array input is encoded (None = the card); a tensor
            input stays on its device.

    Returns:
        numpy uint8 bitstream.
    """
    return _encode(_FREE, image, quality, input_format, subsampling, progressive,
                   restart_interval, entropy, device)


def _encode(stages: _Stages, image, quality, input_format, subsampling, progressive,
            restart_interval, entropy, device):
    """encode_jpeg through the programs of `stages`."""
    (h, w, qy, qc, comp_blocks_dev, n_comp) = _prepare_device_stage(
        image, quality, input_format, subsampling, device, stages.dct)

    if entropy not in ('auto', 'device', 'host'):
        raise JpegException("entropy must be 'auto', 'device' or 'host'")

    if progressive:
        if entropy == 'device':
            raise JpegException(
                "entropy='device' supports baseline only; the progressive "
                'scan scripts are host-side (use entropy='
                "'auto'/'host' with progressive=True)")
        comp_blocks = [cb.cpu().numpy() for cb in comp_blocks_dev]
        return _encode_progressive(comp_blocks, h, w, qy, qc, subsampling)

    restart_interval = _resolve_restart_interval(
        restart_interval, w, subsampling, n_comp, comp_blocks_dev)

    if _use_device_entropy(entropy, comp_blocks_dev[0]):
        body = entropy_encode_device_finalize(
            _dispatch(stages.scan, comp_blocks_dev, subsampling, restart_interval))
        if body is not None:  # None = capacity overflow -> host fallback
            return _assemble(body, h, w, qy, qc, subsampling, n_comp, restart_interval)

    return _host_entropy_bitstream(
        comp_blocks_dev, h, w, qy, qc, subsampling, n_comp, restart_interval)


def _prepare_device_stage(image, quality, input_format, subsampling, device=None,
                          stage=None):
    """Shared encode prologue: validate the layout, build the quant tables
    and enqueue the DCT/quant/zigzag stage on the image's device, through
    `stage` (the free functions' graphed stage if None; the plain
    `_jpeg_device_stage` runs it eagerly).

    A tensor input stays on its device: with entropy='device' only the
    compressed stream crosses to the host (the reference's nvJPEG contract,
    jpeg_encoder.cu:117-173, where frames are consumed from GPU memory)."""
    is_tensor = isinstance(image, torch.Tensor)
    arr = image if is_tensor else np.asarray(image)
    if arr.dtype != (torch.uint8 if is_tensor else np.uint8):
        raise JpegException('Input image should be uint8')
    interleaved = input_format in (2, 3)
    if interleaved:
        if arr.ndim != 3 or arr.shape[2] != 3:
            raise JpegException('for interleaved (BGRI, RGBI) expected (H, W, 3)')
    else:
        if arr.ndim != 3 or arr.shape[0] != 3:
            raise JpegException('for planar (BGR, RGB) expected (3, H, W)')
        arr = arr.permute(1, 2, 0) if is_tensor else np.moveaxis(arr, 0, -1)
    swap_br = input_format in (0, 2)
    if not is_tensor:
        arr = torch.from_numpy(np.ascontiguousarray(arr)).to(resolve_device(device))

    h, w = arr.shape[:2]
    qy, qc = quality_to_tables(quality)
    dev = arr.device
    stage = _FREE.dct if stage is None else stage
    comp_blocks_dev = stage(arr, constant_on(qy.astype(np.float32), dev),
                            constant_on(qc.astype(np.float32), dev), subsampling, swap_br)
    return h, w, qy, qc, comp_blocks_dev, len(comp_blocks_dev)


def _resolve_restart_interval(restart_interval, w, subsampling, n_comp,
                              comp_blocks_dev):
    mcu_w = 16 if (subsampling == 1 and n_comp == 3) else 8
    mcus_per_row = (w + mcu_w - 1) // mcu_w
    n_mcu = comp_blocks_dev[1].shape[0] if (subsampling == 1 and n_comp == 3) \
        else comp_blocks_dev[0].shape[0]
    if restart_interval is None:
        # Auto: one MCU row per interval once the image is big enough for
        # thread parallelism to pay (the DRI/RST overhead is ~2 bytes/row).
        restart_interval = mcus_per_row if n_mcu >= 4096 else 0
    restart_interval = int(restart_interval)
    if restart_interval > 65535:
        raise JpegException('restart_interval must fit in 16 bits')
    return restart_interval


def _assemble(body, h, w, qy, qc, subsampling, n_comp, restart_interval):
    header = _build_headers(h, w, qy, qc, subsampling, n_comp, restart_interval)
    return np.concatenate([
        np.frombuffer(header, dtype=np.uint8),
        body,
        np.frombuffer(b'\xff\xd9', dtype=np.uint8),
    ])


class PendingJpeg:
    """Handle for an in-flight device-entropy encode.

    All device work (DCT/quant/zigzag + Huffman bit packing) is enqueued at
    construction, and on a card the small results are copied into pinned
    host memory behind an event; :meth:`result` waits for that event (not
    for the whole device), reads back the packed stream and finalizes.  A
    streaming caller constructs PendingJpegs for batch N right after
    enqueuing batch N's ISP, enqueues batch N+1, and only then calls
    result() - so batch N's readback overlaps batch N+1's device compute."""

    def __init__(self, pending, comp_blocks_dev, h, w, qy, qc, subsampling,
                 n_comp, restart_interval):
        self._pending = pending
        self._comp_blocks_dev = comp_blocks_dev
        self._meta = (h, w, qy, qc, subsampling, n_comp, restart_interval)

    def result(self) -> np.ndarray:
        """Wait for the device work and return the full JFIF bitstream
        (the `jpeg.result` span; `jpeg.wait` inside it, where the host
        waits for the card)."""
        h, w, qy, qc, subsampling, n_comp, restart_interval = self._meta
        with timing.span('jpeg.result'):
            body = entropy_encode_device_finalize(self._pending)
            if body is not None:
                return _assemble(body, h, w, qy, qc, subsampling, n_comp,
                                 restart_interval)
            # Device capacity overflow: lossless host-path fallback from the
            # retained coefficient blocks.
            timing.count('jpeg.host_fallbacks')
            return _host_entropy_bitstream(
                self._comp_blocks_dev, h, w, qy, qc, subsampling, n_comp,
                restart_interval)


def encode_jpeg_async(
    image,
    quality: int = 94,
    input_format: int = 3,
    subsampling: int = 1,
    restart_interval: int | None = None,
    device=None,
) -> PendingJpeg:
    """Enqueue a device-entropy JPEG encode without waiting for it.

    Same bytes as ``encode_jpeg(..., entropy='device')`` (incl. the lossless
    host fallback on capacity overflow), but returns a :class:`PendingJpeg`
    immediately; call ``.result()`` to obtain the bitstream.  Baseline only.
    """
    return _encode_async(_FREE, image, quality, input_format, subsampling, restart_interval,
                         device)


def _encode_async(stages: _Stages, image, quality, input_format, subsampling,
                  restart_interval, device) -> PendingJpeg:
    """encode_jpeg_async through the programs of `stages`, a traced call
    whose marks split the DCT stage (`jpeg.begin` to `jpeg.dct`) from the
    entropy scan (to `jpeg.scan`)."""
    dev = image.device if isinstance(image, torch.Tensor) else resolve_device(device)
    with timing.call('jpeg.begin', dev):
        (h, w, qy, qc, comp_blocks_dev, n_comp) = _prepare_device_stage(
            image, quality, input_format, subsampling, device, stages.dct)
        timing.mark('jpeg.dct')
        restart_interval = _resolve_restart_interval(
            restart_interval, w, subsampling, n_comp, comp_blocks_dev)
        pending = _dispatch(stages.scan, comp_blocks_dev, subsampling, restart_interval)
        timing.mark('jpeg.scan')
    return PendingJpeg(pending, comp_blocks_dev, h, w, qy, qc, subsampling,
                       n_comp, restart_interval)


def _host_entropy_bitstream(comp_blocks_dev, h, w, qy, qc, subsampling,
                            n_comp, restart_interval):
    """Host-side entropy paths: native C++ single-pass scan, then the pure
    numpy version.  Reads back the int16 coefficient blocks."""
    comp_blocks = [cb.cpu().numpy() for cb in comp_blocks_dev]

    # Fast path: single-pass C++ entropy scan (the nvJPEG-entropy analog).
    tables = (
        (_HUFF[('dc', 0)][0], _HUFF[('dc', 0)][1], _HUFF[('ac', 0)][0], _HUFF[('ac', 0)][1]),
        (_HUFF[('dc', 1)][0], _HUFF[('dc', 1)][1], _HUFF[('ac', 1)][0], _HUFF[('ac', 1)][1]),
    )
    body_native = jpeg_encode_baseline_native(
        comp_blocks, subsampling, tables, restart_interval=restart_interval
    )
    if body_native is not None:
        return _assemble(body_native, h, w, qy, qc, subsampling, n_comp, restart_interval)

    if restart_interval > 0:
        import warnings

        warnings.warn(
            'native bitpack library unavailable: the numpy version emits no '
            'restart markers; encoding without restart intervals',
            RuntimeWarning,
            stacklevel=2,
        )

    all_codes, all_lens, all_rank, all_order = [], [], [], []
    for comp, blocks in enumerate(comp_blocks):
        table_id = 0 if comp == 0 else 1
        ranks = _component_ranks(blocks.shape[0], comp, subsampling, n_comp)
        c, l, kr, ko = _component_emissions(blocks, ranks, table_id)
        all_codes.append(c)
        all_lens.append(l)
        all_rank.append(kr)
        all_order.append(ko)

    codes = np.concatenate(all_codes)
    lens = np.concatenate(all_lens)
    key_rank = np.concatenate(all_rank)
    key_order = np.concatenate(all_order)
    order = np.lexsort((key_order, key_rank))
    body = pack_bits(codes[order].astype(np.uint32), lens[order].astype(np.uint8))
    return _assemble(body, h, w, qy, qc, subsampling, n_comp, 0)


__all__ = ['JpegException', 'PendingJpeg', 'encode_jpeg', 'encode_jpeg_async',
           'quality_to_tables']
