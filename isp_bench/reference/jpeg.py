"""The reference JPEG encoder: baseline JFIF, 4:2:2, restart intervals.

The tables, the colour conversion, the DCT and the quantisation are a
frozen copy of tpu_darktable_torch/ops/jpeg.py (its device stage is plain
elementwise torch, float64 products rounded once to float32, so it gives
the same bits on every device).  The entropy scan below is this module's
own: numpy, one restart interval after another, with the DC predictor
reset, 1-bit padding and an RSTn marker between intervals (ITU-T T.81
B.2.1.2 and F.1.2), and 0xFF00 stuffing.  It imports nothing of the
measured package.
"""

from __future__ import annotations

import numpy as np
import torch


def constant_on(values, device):
    return torch.as_tensor(values).to(torch.device(device))


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


_DCT64 = _dct_matrix().astype(np.float64)


_ZIGZAG64 = _ZIGZAG.astype(np.int64)


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



def _mcu_of_block(n_blocks: int, comp: int, subsampling: int, n_comp: int) -> np.ndarray:
    """The MCU that each block of component `comp` belongs to."""
    b = np.arange(n_blocks, dtype=np.int64)
    if n_comp == 3 and subsampling == 1 and comp == 0:
        return b // 2
    return b


def _emissions(blocks: np.ndarray, table_id: int, first_in_interval: np.ndarray):
    """(code, length, block, order-in-block) of every Huffman emission of
    one component's (N, 64) zigzag blocks, in block order.  The DC
    predictor restarts at 0 where `first_in_interval` holds."""
    dc_codes, dc_lens = _HUFF[('dc', table_id)]
    ac_codes, ac_lens = _HUFF[('ac', table_id)]
    n = blocks.shape[0]
    dc = blocks[:, 0].astype(np.int64)
    prev = np.concatenate([[0], dc[:-1]])
    diff = dc - np.where(first_in_interval, 0, prev)
    size = _bit_size(diff)
    codes = [(dc_codes[size].astype(np.uint64) << size.astype(np.uint64))
             | _extra_bits(diff, size).astype(np.uint64)]
    lens = [dc_lens[size].astype(np.int64) + size]
    block = [np.arange(n, dtype=np.int64)]
    order = [np.zeros(n, dtype=np.int64)]

    ac = blocks[:, 1:].astype(np.int64)
    bi, pi = np.nonzero(ac)                       # row-major: block, then position
    vals = ac[bi, pi]
    first = np.concatenate([[True], bi[1:] != bi[:-1]]) if len(bi) else np.zeros(0, bool)
    prev_pos = np.where(first, -1, np.concatenate([[-1], pi[:-1]]))
    run = pi - prev_pos - 1
    n_zrl = run // 16
    sizes = _bit_size(vals)
    sym = ((run % 16) << 4) | sizes
    sym_code = ((ac_codes[sym].astype(np.uint64) << sizes.astype(np.uint64))
                | _extra_bits(vals, sizes).astype(np.uint64))
    sym_len = ac_lens[sym].astype(np.int64) + sizes
    # each nonzero coefficient: its ZRL (16 zeros) emissions, then its symbol
    reps = n_zrl + 1
    gid = np.repeat(np.arange(len(bi)), reps)
    k = np.arange(len(gid)) - np.repeat(np.cumsum(reps) - reps, reps)
    is_sym = k == n_zrl[gid]
    codes.append(np.where(is_sym, sym_code[gid], np.uint64(ac_codes[0xF0])))
    lens.append(np.where(is_sym, sym_len[gid], int(ac_lens[0xF0])))
    block.append(bi[gid])
    order.append(1 + np.arange(len(gid)))         # increasing within a block
    # EOB where the last nonzero coefficient is not position 63
    last = np.full(n, -1, dtype=np.int64)
    last[bi] = pi                                 # the last write per block wins
    eob = np.nonzero(last < 62)[0]
    codes.append(np.full(len(eob), ac_codes[0x00], dtype=np.uint64))
    lens.append(np.full(len(eob), int(ac_lens[0x00]), dtype=np.int64))
    block.append(eob)
    order.append(np.full(len(eob), 1 << 40, dtype=np.int64))
    return (np.concatenate(codes), np.concatenate(lens), np.concatenate(block),
            np.concatenate(order))


def entropy_scan(comp_blocks, subsampling: int, restart_interval: int) -> np.ndarray:
    """The scan's bytes: stuffed entropy-coded intervals joined by RSTn."""
    n_comp = len(comp_blocks)
    n_mcu = comp_blocks[1].shape[0] if (n_comp == 3 and subsampling == 1) else comp_blocks[0].shape[0]
    ri = restart_interval if restart_interval > 0 else n_mcu
    all_codes, all_lens, all_key = [], [], []
    for comp, blocks in enumerate(comp_blocks):
        n = blocks.shape[0]
        interval = _mcu_of_block(n, comp, subsampling, n_comp) // ri
        first = np.concatenate([[True], interval[1:] != interval[:-1]])
        codes, lens, blk, order = _emissions(blocks, 0 if comp == 0 else 1, first)
        rank = _component_ranks(n, comp, subsampling, n_comp)[blk]
        all_codes.append(codes)
        all_lens.append(lens)
        all_key.append((rank, order))
    codes = np.concatenate(all_codes)
    lens = np.concatenate(all_lens)
    rank = np.concatenate([k[0] for k in all_key])
    order = np.concatenate([k[1] for k in all_key])
    sort = np.lexsort((order, rank))
    codes, lens, rank = codes[sort], lens[sort], rank[sort]
    blocks_per_mcu = 4 if (n_comp == 3 and subsampling == 1) else n_comp
    interval = (rank // blocks_per_mcu) // ri
    n_iv = int(interval.max()) + 1
    # pad every interval with 1 bits to a whole byte
    iv_bits = np.bincount(interval, weights=lens, minlength=n_iv).astype(np.int64)
    pad = (-iv_bits) % 8
    ends = np.cumsum(np.bincount(interval, minlength=n_iv))
    codes = np.insert(codes, ends, ((np.uint64(1) << pad.astype(np.uint64)) - np.uint64(1)))
    lens = np.insert(lens, ends, pad)
    total = int(lens.sum())
    starts = np.cumsum(lens) - lens
    idx = np.repeat(np.arange(len(lens)), lens)
    j = np.arange(total, dtype=np.int64) - starts[idx]
    shift = (lens[idx] - 1 - j).astype(np.uint64)
    bits = ((codes[idx] >> shift) & np.uint64(1)).astype(np.uint8)
    data = np.packbits(bits)
    iv_bytes = (iv_bits + pad) // 8
    bounds = np.cumsum(iv_bytes)[:-1]            # where RSTn markers go
    ff = np.nonzero(data == 0xFF)[0]
    stuffed = np.insert(data, ff + 1, 0)
    at = bounds + np.searchsorted(ff, bounds)   # each 0xFF before a bound moved it by one
    marks = (0xD0 + np.arange(len(bounds)) % 8).astype(np.uint8)
    out = np.insert(stuffed, np.repeat(at, 2),
                    np.stack([np.full(len(bounds), 0xFF, np.uint8), marks], 1).reshape(-1))
    return out.astype(np.uint8)


def restart_interval_auto(w: int, subsampling: int, n_comp: int, n_mcu: int) -> int:
    """One MCU row per interval on a large image, else none."""
    mcu_w = 16 if (subsampling == 1 and n_comp == 3) else 8
    return (w + mcu_w - 1) // mcu_w if n_mcu >= 4096 else 0


def encode(image_u8: torch.Tensor, quality: int, subsampling: int = 1) -> np.ndarray:
    """Baseline JFIF bytes of an (H, W, 3) uint8 RGB image, the DCT on the
    image's device, the scan on the host, restart intervals as the encoder
    picks them by default."""
    h, w = image_u8.shape[:2]
    qy, qc = quality_to_tables(quality)
    dev = image_u8.device
    comp = _jpeg_device_stage(image_u8, constant_on(qy.astype(np.float32), dev),
                              constant_on(qc.astype(np.float32), dev), subsampling, False)
    comp = [c.cpu().numpy() for c in comp]
    n_comp = len(comp)
    n_mcu = comp[1].shape[0] if (subsampling == 1 and n_comp == 3) else comp[0].shape[0]
    ri = restart_interval_auto(w, subsampling, n_comp, n_mcu)
    header = np.frombuffer(_build_headers(h, w, qy, qc, subsampling, n_comp, ri), np.uint8)
    return np.concatenate([header, entropy_scan(comp, subsampling, ri),
                           np.array([0xFF, 0xD9], np.uint8)])
