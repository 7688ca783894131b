"""JPEG baseline entropy coding on the device: Huffman emission and bit
packing as torch integer ops (counterpart of tpu_darktable/ops/jpeg_entropy.py).

The reference encodes the whole JPEG on the GPU via nvJPEG and returns only
the compressed bitstream (csrc/jpeg_encoder.cu:117-173).  Here the entropy
stage runs on the coefficients' device so that only the packed stream
(~2-6 MB a 12 MP frame) is read back, not the int16 coefficients:

- per-coefficient Huffman emissions (DC size/diff codes, AC run-length
  symbols with folded ZRLs, EOB) are built as fixed-slot left-aligned
  bitstrings (2 words + a bit length, one slot per coefficient plus an EOB
  slot; empty slots have length 0);
- slots are concatenated by hierarchical doubling: each level joins
  adjacent pairs of strings with a bit shift and a whole-word shift;
- each restart interval is byte-aligned with 1-padding exactly like the
  C++ BitWriter (native/bitpack.cpp:106-113), then the intervals are
  word-compacted into one dense stream;
- the host receives the packed words plus per-interval byte counts, applies
  0xFF stuffing, and joins intervals with RSTn markers.

The body is byte-identical to the native C++ scan
(native/bitpack.cpp: jpeg_encode_baseline_rst) for the same restart
interval, which is how it is tested.

torch has no shifts on uint32, so a 32-bit word is carried in an int64 and
masked to 32 bits after every left shift and every complement.  Where the
JAX code selects through trees of `where` (gathers are slow on the TPU),
this code gathers: a table lookup and a whole-word shift are one gather
each on the GPU.

Capacity: intermediate doubling levels use exact worst-case capacities
until they exceed the per-interval cap; the final per-interval bit lengths
are exact, so any overflow of the cap is detected and reported for a
lossless host-path fallback.

The scan (`_scan`, the counterpart of JAX's jitted `_entropy_pack_device`)
runs through a `_graph.Graphed` that its caller owns (ops/jpeg.py
`_Stages`).  It calls kernels/jpeg_entropy.py: on a card the hand kernel of
csrc/jpeg_entropy.cu (three launches), on the CPU `_entropy_pack_device`
below, its plain version; both give the stream as int32 words.  Their
tables are device constants made once per device, and nothing in either
waits for the host, so on a card the scan replays as one CUDA graph.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .._device import constant_on
from ..kernels.jpeg_entropy import blocks_per_mcu, jpeg_entropy
from ..utils import timing

# Worst-case bits for a single slot item (Annex-K tables: up to three folded
# ZRLs at <=12 bits each plus a 16-bit AC code and 10 amplitude bits).
_MAX_ITEM_BITS = 62
# Worst-case bits for one block's full emission stream (DC 27 + 63 AC * 26).
_MAX_BLOCK_BITS = 1665
_SLOTS = 65  # DC + AC positions 1..63 + EOB
_MASK = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Left-aligned multi-word bitstrings
#
# A batch of bitstrings is (words: int64[..., n, W] holding 32-bit values,
# lens: int64[..., n]).  Bit i of a string is bit (31 - i % 32) of word
# i // 32.  All bits at positions >= len are zero (required: concatenation
# ORs strings together).
# ---------------------------------------------------------------------------


def _shift_right_bits(w, s):
    """Shift word array right by s bits (0 <= s < 32), s broadcast over words."""
    s = s[..., None]
    prev = F.pad(w, (1, 0))[..., :-1]
    hi = torch.where(s == 0, 0, (prev << (32 - s)) & _MASK)
    return (w >> s) | hi


def _shift_right_words(w, wo):
    """Shift word array right by wo whole words (one gather)."""
    j = torch.arange(w.shape[-1], device=w.device)
    src = j - wo[..., None]
    out = torch.gather(w, -1, src.clamp(min=0))
    return torch.where(src >= 0, out, 0)


def _widen(w, out_w: int):
    cur = w.shape[-1]
    if cur >= out_w:
        return w[..., :out_w]
    return F.pad(w, (0, out_w - cur))


def _concat_pairs(words, lens, out_w: int):
    """One doubling level: concatenate adjacent string pairs.

    words: (..., n, W) int64, lens: (..., n) int64.
    Returns ((..., ceil(n/2), out_w), (..., ceil(n/2),)).  Odd n carries the
    last string through unmodified.  Bits that would exceed out_w * 32 are
    silently dropped; lens stay exact so overflow is detectable later.
    """
    n = words.shape[-2]
    odd = n % 2
    n_even = n - odd
    a_w, b_w = words[..., 0:n_even:2, :], words[..., 1:n_even:2, :]
    a_l, b_l = lens[..., 0:n_even:2], lens[..., 1:n_even:2]

    a_wide = _widen(a_w, out_w)
    b_shift = _shift_right_words(_shift_right_bits(_widen(b_w, out_w), a_l & 31), a_l >> 5)
    out = a_wide | b_shift
    out_l = a_l + b_l

    if odd:
        tail_w = _widen(words[..., n_even:n, :], out_w)
        out = torch.cat([out, tail_w], dim=-2)
        out_l = torch.cat([out_l, lens[..., n_even:n]], dim=-1)
    return out, out_l


def _capacity_schedule(n_items: int, item_bits: int, cap_w: int,
                       block_bound: bool):
    """Per-level output word capacities for doubling n_items -> 1.

    item_bits: exact worst-case bits of one input string.  block_bound
    additionally applies the per-block worst case (valid only when the
    input strings are the per-coefficient emission slots).
    """
    caps = []
    n = n_items
    items_per_string = 1
    while n > 1:
        items_per_string *= 2
        bits = items_per_string * item_bits
        if block_bound:
            bits = min(bits, (items_per_string // _SLOTS + 2) * _MAX_BLOCK_BITS)
        caps.append(min((bits + 31) // 32, cap_w))
        n = (n + 1) // 2
    if caps:
        caps[-1] = cap_w  # final level always at full capacity
    return caps


def _pack_doubling(words, lens, cap_w: int, item_bits: int,
                   block_bound: bool = False):
    """Concatenate all strings along the second-to-last axis down to one.
    Each level's input is released as soon as the next level exists."""
    for out_w in _capacity_schedule(
            words.shape[-2], item_bits, cap_w, block_bound):
        words, lens = _concat_pairs(words, lens, out_w)
    return words[..., 0, :], lens[..., 0]


# ---------------------------------------------------------------------------
# Emission synthesis
# ---------------------------------------------------------------------------


def _select_tree(index, table: torch.Tensor):
    """LUT lookup: table[index] (one gather; the JAX code builds a tree of
    selects because gathers are slow on the TPU)."""
    return table[index]


def _bit_size(v):
    """JPEG magnitude category of an integer tensor (0 for 0): frexp's
    exponent is exact for |v| < 2**24."""
    return torch.frexp(v.abs().to(torch.float32)).exponent.to(torch.int64)


def _extra_bits(v, size):
    """Amplitude bits: v if v >= 0 else v - 1, masked to `size` bits."""
    raw = torch.where(v >= 0, v, v - 1)
    return raw & ((1 << size) - 1)


def _left_align(val, length):
    """Left-align a value of `length` exact bits (<= 32) into one word."""
    return torch.where(length > 0, (val << (32 - length)) & _MASK, 0)


def _huff_numpy_tables(codes: np.ndarray, lens: np.ndarray):
    """Pack (len << 20) | code into one int64 LUT (code <= 16 bits)."""
    return lens.astype(np.int64) << 20 | codes.astype(np.int64)


def _zrl_prefixes(zrl_code: int, zrl_len: int) -> np.ndarray:
    """(3, 4) int64: hi word, lo word and length of 0..3 left-aligned ZRLs."""
    out = np.zeros((3, 4), np.int64)
    for k in range(4):
        bits = 0
        for _ in range(k):
            bits = (bits << zrl_len) | zrl_code
        blen = k * zrl_len
        if blen:
            out[:, k] = ((bits << (64 - blen) >> 32) & _MASK, (bits << (64 - blen)) & _MASK, blen)
    return out


def _component_items(blocks, dc_diff, dc_lut, ac_lut, zrl_prefs,
                     eob_code: int, eob_len: int):
    """Per-block emission slots for one component's blocks.

    blocks: (..., 64) int64 zigzag; dc_diff: (...,) int64 DC differences;
    dc_lut, ac_lut: (len << 20) | code tables on the blocks' device;
    zrl_prefs: _zrl_prefixes on the device.
    Returns (hi, lo, len) int64 arrays of shape (..., 65) - slot 0 is DC,
    slots 1..63 the AC positions, slot 64 the EOB.
    """
    # --- DC: huff(size) ++ extra ---
    dsize = _bit_size(dc_diff)
    dlut = _select_tree(dsize, dc_lut)
    dc_val = ((dlut & 0xFFFFF) << dsize) | _extra_bits(dc_diff, dsize)
    dc_len = (dlut >> 20) + dsize
    dc_hi = _left_align(dc_val, dc_len)

    # --- AC: run-lengths via cumulative max of last-nonzero index ---
    ac = blocks[..., 1:]  # (..., 63)
    nz = ac != 0
    idx = torch.arange(63, device=ac.device).expand_as(ac)
    prev_max = torch.where(nz, idx, -1).cummax(dim=-1).values
    prev_before = F.pad(prev_max, (1, 0), value=-1)[..., :-1]
    run = idx - prev_before - 1
    del idx, prev_max, prev_before

    zc = run >> 4          # folded ZRL count, 0..3
    size = _bit_size(ac)
    alut = _select_tree(((run & 15) << 4) | size, ac_lut)
    del run
    base_val = ((alut & 0xFFFFF) << size) | _extra_bits(ac, size)
    base_len = (alut >> 20) + size
    base_hi = _left_align(base_val, base_len)
    del alut, base_val, size

    # ZRL prefix: left-aligned constants for 0..3 repetitions
    p_hi, p_lo, p_len = zrl_prefs[0][zc], zrl_prefs[1][zc], zrl_prefs[2][zc]
    del zc

    # item = prefix ++ base (prefix <= 36 bits, base <= 26, total <= 62)
    b_shift_hi = torch.where(p_len > 0, base_hi >> p_len, base_hi)
    b_shift_lo = torch.where(p_len > 0, (base_hi << (32 - p_len)) & _MASK, 0)
    # prefix can exceed 32 bits (2-3 ZRLs): place base across (hi, lo)
    over = p_len >= 32
    b_over_lo = torch.where(
        p_len == 32, base_hi,
        torch.where(over, base_hi >> (p_len - 32).clamp(min=0), 0),
    )
    ac_hi = torch.where(nz, p_hi | torch.where(over, 0, b_shift_hi), 0)
    ac_lo = torch.where(nz, p_lo | torch.where(over, b_over_lo, b_shift_lo), 0)
    ac_len = torch.where(nz, p_len + base_len, 0)
    del b_shift_hi, b_shift_lo, b_over_lo, base_hi, base_len, p_hi, p_lo, p_len, over

    # --- EOB: emitted iff the last AC coefficient is zero ---
    needs_eob = blocks[..., 63] == 0
    e_hi = torch.where(needs_eob, (eob_code << (32 - eob_len)) & _MASK, 0)
    e_len = torch.where(needs_eob, eob_len, 0)

    zero = torch.zeros_like(dc_hi)
    hi = torch.cat([dc_hi[..., None], ac_hi, e_hi[..., None]], dim=-1)
    lo = torch.cat([zero[..., None], ac_lo, zero[..., None]], dim=-1)
    ln = torch.cat([dc_len[..., None], ac_len, e_len[..., None]], dim=-1)
    return hi, lo, ln


# ---------------------------------------------------------------------------
# Full scan assembly
# ---------------------------------------------------------------------------


def _interleave_to_mcus(comp_blocks, subsampling: int):
    """Per-component (N, 64) blocks -> (n_mcu, bpm, 64) in MCU scan order,
    plus the per-MCU-slot component index (0 = luma, else chroma)."""
    n_comp = len(comp_blocks)
    if n_comp == 1:
        return comp_blocks[0][:, None, :], [0]
    y, cb, cr = comp_blocks
    if subsampling == 1:  # 422: [Y0 Y1 Cb Cr]
        n_mcu = cb.shape[0]
        yy = y.reshape(n_mcu, 2, 64)
        return torch.cat([yy, cb[:, None, :], cr[:, None, :]], dim=1), [0, 0, 1, 2]
    # 444: [Y Cb Cr]
    return torch.cat([y[:, None, :], cb[:, None, :], cr[:, None, :]], dim=1), [0, 1, 2]


def _dc_diffs(mcu_blocks, comp_of_slot, n_iv: int):
    """Per-interval DC differences with per-component prediction chains.

    mcu_blocks: (n_iv, M, bpm, 64) int64.  Returns (n_iv, M, bpm) diffs.
    """
    per_slot = [None] * len(comp_of_slot)
    for comp in sorted(set(comp_of_slot)):
        slots = [i for i, c in enumerate(comp_of_slot) if c == comp]
        # a component's slots are consecutive in the MCU layout
        if slots != list(range(slots[0], slots[-1] + 1)):
            raise AssertionError(f'component slots not consecutive: {slots}')
        dc = mcu_blocks[..., slots[0]: slots[-1] + 1, 0]  # (n_iv, M, k)
        flat = dc.reshape(n_iv, -1)                        # chain order
        prev = F.pad(flat, (1, 0))[:, :-1]
        d = (flat - prev).reshape(dc.shape)
        for j, sl in enumerate(slots):
            per_slot[sl] = d[..., j]
    return torch.stack(per_slot, dim=-1)


def _luts(device: torch.device):
    """The Huffman and ZRL tables of both table ids, as device constants on
    `device`."""
    from .jpeg import _HUFF  # canonical Annex-K tables

    luts = {}
    for tid in (0, 1):
        ac_c, ac_l = _HUFF[('ac', tid)]
        luts[tid] = dict(
            dc=constant_on(_huff_numpy_tables(*_HUFF[('dc', tid)])[:16], device),
            ac=constant_on(_huff_numpy_tables(ac_c, ac_l), device),
            zrl=constant_on(_zrl_prefixes(int(ac_c[0xF0]), int(ac_l[0xF0])), device),
            eob=(int(ac_c[0x00]), int(ac_l[0x00])),
        )
    return luts


def _entropy_pack_device(comp_blocks, subsampling: int,
                         restart_interval: int, cap_words: int):
    """Device-side scan: blocks -> (stream words, per-interval byte counts,
    total words, overflow flag), all tensors on the blocks' device.

    comp_blocks: tuple of (N, 64) integer tensors.  restart_interval in MCUs
    (> 0); the stream is n_iv independent byte-aligned segments.
    cap_words: per-interval packed capacity in 32-bit words.
    """
    dev = comp_blocks[0].device
    luts = _luts(dev)
    mcus, comp_of_slot = _interleave_to_mcus(
        [cb.to(torch.int64) for cb in comp_blocks], subsampling)
    n_mcu, bpm = mcus.shape[0], mcus.shape[1]
    ri = restart_interval
    n_iv = -(-n_mcu // ri)
    pad_mcu = n_iv * ri - n_mcu
    if pad_mcu:
        mcus = F.pad(mcus, (0, 0, 0, 0, 0, pad_mcu))
    mcus = mcus.reshape(n_iv, ri, bpm, 64)

    dc_diff = _dc_diffs(mcus, comp_of_slot, n_iv)

    # one (n_iv, ri, 65) set of slots per MCU slot, each with its table
    his, los, lns = [], [], []
    for slot, comp in enumerate(comp_of_slot):
        t = luts[0 if comp == 0 else 1]
        hi, lo, ln = _component_items(
            mcus[:, :, slot, :], dc_diff[:, :, slot], t['dc'], t['ac'], t['zrl'], *t['eob'])
        his.append(hi)
        los.append(lo)
        lns.append(ln)
    del mcus, dc_diff, hi, lo, ln
    hi = torch.stack(his, dim=2)   # (n_iv, ri, bpm, 65)
    lo = torch.stack(los, dim=2)
    ln = torch.stack(lns, dim=2)
    del his, los, lns

    if pad_mcu:  # emissions of padding MCUs must vanish
        mcu_idx = torch.arange(n_iv * ri, device=dev).reshape(n_iv, ri)
        valid = (mcu_idx < n_mcu)[..., None, None]
        hi = torch.where(valid, hi, 0)
        lo = torch.where(valid, lo, 0)
        ln = torch.where(valid, ln, 0)

    n_items = ri * bpm * _SLOTS
    words = torch.stack([hi, lo], dim=-1).reshape(n_iv, n_items, 2)
    lens = ln.reshape(n_iv, n_items)
    del hi, lo, ln

    iv_words, iv_bits = _pack_doubling(
        words, lens, cap_words, _MAX_ITEM_BITS, block_bound=True)
    del words, lens

    # Byte-align each interval with 1-padding (BitWriter.finish semantics).
    pad_bits = (-iv_bits) % 8
    ones = torch.full_like(pad_bits, _MASK)
    pad_hi = torch.where(pad_bits > 0, (0xFF << 24) & ~(ones >> pad_bits) & _MASK, 0)
    pad_str = F.pad(pad_hi[:, None], (0, cap_words - 1))
    stacked = torch.stack([iv_words, pad_str], dim=1)      # (n_iv, 2, cap)
    lens2 = torch.stack([iv_bits, pad_bits], dim=1)
    iv_words, iv_bits_padded = _concat_pairs(stacked, lens2, cap_words)
    iv_words = iv_words[:, 0, :]
    iv_bits_padded = iv_bits_padded[:, 0]

    overflow = torch.any(iv_bits_padded > cap_words * 32)
    iv_bytes = iv_bits_padded // 8

    # Word-compact the intervals into one dense stream (word-granular
    # concatenation: lengths rounded up to whole words, so the bit shift in
    # _concat_pairs is always zero).
    iv_wlen = ((iv_bytes + 3) // 4) * 32                  # bits, word multiple
    total_cap = n_iv * cap_words
    stream, total_bits = _pack_doubling(
        iv_words[None], iv_wlen[None], total_cap, cap_words * 32)
    return stream[0], iv_bytes, total_bits[0] // 32, overflow


def _scan(subsampling: int, restart_interval: int, cap_words: int, *comp_blocks):
    """The scan as its Graphed runs it (each block tensor an argument of its
    own, so the capture key holds its shape): the stream's int32 words, and
    the per-interval byte counts, the word count and the overflow flag in
    one int64 tensor, the small readback (kernels/jpeg_entropy.py)."""
    return jpeg_entropy(comp_blocks, subsampling, restart_interval, cap_words)


def _stuff_bytes(seg: np.ndarray) -> np.ndarray:
    """0xFF -> 0xFF 0x00 stuffing (vectorized)."""
    is_ff = seg == 0xFF
    if not is_ff.any():
        return seg
    reps = np.where(is_ff, 2, 1)
    out = np.zeros(int(reps.sum()), dtype=np.uint8)
    pos = np.concatenate(([0], np.cumsum(reps)[:-1]))
    out[pos] = seg
    return out


def entropy_encode_device_dispatch(comp_blocks, subsampling: int,
                                   restart_interval: int,
                                   cap_bytes_per_interval: int | None = None):
    """Enqueue the device entropy scan; return the pending handles.

    The returned dict holds tensors whose computation is enqueued but not
    waited for - pass it to :func:`entropy_encode_device_finalize` for the
    readback and the byte finalization.  On a card the per-interval byte
    counts, the word count and the overflow flag are copied into pinned host
    memory behind an event here, so finalize waits for this encode only,
    not for work enqueued after it.

    comp_blocks: per-component (N, 64) zigzag coefficient tensors (or
    arrays, taken to the CPU).
    restart_interval: MCUs per interval (> 0), or 0 for a single segment.
    The scan replays the free functions' graph (ops/jpeg.py)."""
    from .jpeg import _FREE

    return _dispatch(_FREE.scan, comp_blocks, subsampling, restart_interval,
                     cap_bytes_per_interval)


def _dispatch(scan, comp_blocks, subsampling: int, restart_interval: int,
              cap_bytes_per_interval: int | None = None):
    """entropy_encode_device_dispatch with the scan run by `scan` (a
    Graphed of `_scan`, or `_scan` itself to run it eagerly)."""
    comp_blocks = tuple(torch.as_tensor(cb) for cb in comp_blocks)
    bpm = blocks_per_mcu(len(comp_blocks), subsampling)
    n_mcu = comp_blocks[1].shape[0] if bpm == 4 else comp_blocks[0].shape[0]
    ri = int(restart_interval) if restart_interval > 0 else n_mcu
    n_iv = -(-n_mcu // ri)
    if cap_bytes_per_interval is None:
        # ~6x the long-run typical rate at quality <= 95; overflow falls
        # back losslessly, so this is a performance knob, not a correctness
        # bound.
        cap_bytes_per_interval = max(4096, ri * bpm * 40)
    cap_words = -(-int(cap_bytes_per_interval) // 4)

    stream, small = scan(subsampling, ri, cap_words, *comp_blocks)
    pending = {'stream': stream, 'n_iv': n_iv, 'event': None}
    if stream.is_cuda:
        host = torch.empty(small.shape, dtype=small.dtype, pin_memory=True)
        host.copy_(small, non_blocking=True)
        pending['event'] = torch.cuda.Event()
        pending['event'].record()
        small = host
    pending['small'] = small
    return pending


def _read_stream(pending, used: int) -> np.ndarray:
    """The first `used` words of the packed stream on the host.  On a card
    the copy runs on a side stream that waits only for this encode."""
    stream = pending['stream']
    if not stream.is_cuda:
        return stream[:used].numpy()
    host = torch.empty(used, dtype=stream.dtype, pin_memory=True)
    side = torch.cuda.Stream(device=stream.device)
    side.wait_event(pending['event'])
    with torch.cuda.stream(side):
        host.copy_(stream[:used], non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    done.synchronize()
    return host.numpy()


def entropy_encode_device_finalize(pending):
    """Host side of the device entropy scan: read back the packed words and
    assemble the scan body (stuffing + RSTn markers).  Returns the body
    bytes (numpy uint8) or None if the device capacity overflowed (caller
    falls back to the host path)."""
    if pending['event'] is not None:
        with timing.span('jpeg.wait'):
            pending['event'].synchronize()
    small = pending['small'].numpy()
    n_iv = pending['n_iv']
    iv_bytes, used, overflow = small[:n_iv], int(small[n_iv]), bool(small[n_iv + 1])
    if overflow:
        return None
    words = _read_stream(pending, used)            # the only bulk transfer
    raw = np.frombuffer(words.astype('>i4').tobytes(), dtype=np.uint8)

    parts = []
    off_words = 0
    for i in range(n_iv):
        nb = int(iv_bytes[i])
        seg = raw[off_words * 4: off_words * 4 + nb]
        parts.append(_stuff_bytes(seg))
        if i + 1 < n_iv:
            parts.append(np.frombuffer(
                bytes([0xFF, 0xD0 + (i % 8)]), dtype=np.uint8))
        off_words += (nb + 3) // 4
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8)


def entropy_encode_device(comp_blocks, subsampling: int,
                          restart_interval: int,
                          cap_bytes_per_interval: int | None = None):
    """Full baseline entropy scan with the bit packing on the device
    (dispatch + finalize; see the _dispatch/_finalize pair for the
    overlapped streaming form).  Returns the scan body bytes (numpy uint8,
    stuffed, with RSTn markers between intervals) or None if the device
    capacity overflowed (caller falls back to the host path)."""
    return entropy_encode_device_finalize(entropy_encode_device_dispatch(
        comp_blocks, subsampling, restart_interval, cap_bytes_per_interval))


__all__ = ['entropy_encode_device', 'entropy_encode_device_dispatch',
           'entropy_encode_device_finalize']
