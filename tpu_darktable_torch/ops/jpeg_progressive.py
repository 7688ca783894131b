"""Progressive JPEG (spectral selection) + optimized Huffman tables
(counterpart of tpu_darktable/ops/jpeg_progressive.py, a copy: host numpy).

Completes the encoder's parity with the reference's nvJPEG configuration
(csrc/jpeg_encoder.cu:117-130: optimized Huffman always on, progressive via
NVJPEG_ENCODING_PROGRESSIVE_DCT_HUFFMAN).  The DCT/quantization runs on the
image's device (ops/jpeg.py); this module handles the entropy layer:

- optimal length-limited Huffman construction (the libjpeg/Annex-K
  frequency-merge procedure with the 16-bit limit adjustment);
- progressive scan script: one interleaved DC scan, then one full-band AC
  scan per component with EOB-run coding (Ss=1, Se=63, Ah=Al=0);
- all symbol/run computation vectorized in numpy, bit-packing via the
  native C++ packer.
"""

from __future__ import annotations

import numpy as np

from ..native import pack_bits


def build_optimal_huffman(freqs: np.ndarray):
    """Optimal JPEG Huffman code from symbol frequencies.

    The libjpeg jpeg_gen_optimal_table algorithm: merge lowest-frequency
    pairs tracking code sizes via an 'others' chain, then fold lengths > 16
    down (Annex K.2 adjust_bits), reserving one all-ones codepoint.

    Returns (bits[16], values[list]) for the DHT segment plus
    (codes[256], lengths[256]) lookup arrays.
    """
    freq = freqs.astype(np.int64).copy()
    assert freq.shape[0] <= 256
    freq = np.concatenate([freq, np.zeros(257 - freq.shape[0], dtype=np.int64)])
    freq[256] = 1  # reserved: guarantees no real symbol gets all-ones code

    codesize = np.zeros(257, dtype=np.int64)
    others = np.full(257, -1, dtype=np.int64)

    while True:
        nz = np.nonzero(freq > 0)[0]
        if len(nz) <= 1:
            break
        # two smallest (ties: highest symbol value first, per libjpeg)
        order = nz[np.lexsort((-nz, freq[nz]))]
        c1, c2 = int(order[0]), int(order[1])
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = int(others[c1])
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = int(others[c2])
            codesize[c2] += 1

    bits = np.zeros(33, dtype=np.int64)
    for size in codesize[codesize > 0]:
        bits[min(int(size), 32)] += 1

    # limit to 16 bits (libjpeg adjust)
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    # remove the reserved codepoint
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1

    # symbols sorted by (codesize, value), excluding the reserved 256
    syms = np.arange(256)
    sizes = codesize[:256]
    used = sizes > 0
    order = np.lexsort((syms[used], sizes[used]))
    values = syms[used][order].tolist()

    bits16 = bits[1:17].astype(int).tolist()
    assert sum(bits16) == len(values)

    codes = np.zeros(256, dtype=np.uint32)
    lengths = np.zeros(256, dtype=np.uint8)
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits16[length - 1]):
            codes[values[k]] = code
            lengths[values[k]] = length
            code += 1
            k += 1
        code <<= 1
    return bits16, values, codes, lengths


def _bit_size(v: np.ndarray) -> np.ndarray:
    a = np.abs(v.astype(np.int64))
    size = np.zeros(a.shape, dtype=np.int64)
    nz = a > 0
    size[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return size


def _extra_bits(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    v64 = v.astype(np.int64)
    raw = np.where(v64 >= 0, v64, v64 - 1)
    return (raw & ((1 << size) - 1)).astype(np.uint32)


def dc_scan_symbols(comp_blocks, ranks_per_comp):
    """Interleaved DC scan: per-component diffs in global MCU order.

    Returns (symbols, codes_wo_huffman, order) where symbols are the DC size
    categories (for Huffman optimization) and codes carry the extra bits.
    """
    all_syms, all_extra, all_sizes, all_rank, comp_ids = [], [], [], [], []
    for comp, blocks in enumerate(comp_blocks):
        dc = blocks[:, 0].astype(np.int64)
        diff = np.diff(dc, prepend=0)
        size = _bit_size(diff)
        all_syms.append(size)
        all_extra.append(_extra_bits(diff, size))
        all_sizes.append(size)
        all_rank.append(ranks_per_comp[comp])
        comp_ids.append(np.full(len(dc), comp, dtype=np.int64))
    syms = np.concatenate(all_syms)
    extra = np.concatenate(all_extra)
    sizes = np.concatenate(all_sizes)
    ranks = np.concatenate(all_rank)
    comps = np.concatenate(comp_ids)
    order = np.argsort(ranks, kind='stable')
    return syms[order], extra[order], sizes[order], comps[order]


def ac_scan_symbols(blocks: np.ndarray):
    """Full-band (1-63) progressive AC scan symbols for one component.

    Returns (symbols uint8, extra uint32, extra_len int64) in emission order,
    with EOB-run coding (T.81 G.1.2.2): runs of blocks whose band tail is
    all zero collapse into EOBn symbols.
    """
    n = blocks.shape[0]
    ac = blocks[:, 1:].astype(np.int64)
    nz = ac != 0
    idx = np.broadcast_to(np.arange(63, dtype=np.int64), ac.shape)
    prev = np.where(nz, idx, -1)
    prev_max = np.maximum.accumulate(prev, axis=1)
    prev_before = np.concatenate([np.full((n, 1), -1, dtype=np.int64), prev_max[:, :-1]], axis=1)
    run = idx - prev_before - 1

    bi, pi = np.nonzero(nz)
    vals = ac[bi, pi]
    runs = run[bi, pi]
    zrl_count = runs // 16
    rrem = runs % 16
    sizes = _bit_size(vals)

    # expand ZRLs + symbol per nonzero
    reps = zrl_count + 1
    total = int(reps.sum())
    gid = np.repeat(np.arange(len(bi)), reps)
    starts = np.cumsum(reps) - reps
    pos_in_group = np.arange(total) - starts[gid]
    is_sym = pos_in_group == zrl_count[gid]
    sym = np.where(is_sym, (rrem[gid] << 4) | sizes[gid], 0xF0).astype(np.uint8)
    extra = np.where(is_sym, _extra_bits(vals, sizes)[gid], 0).astype(np.uint32)
    extra_len = np.where(is_sym, sizes[gid], 0)
    coeff_block = bi[gid]
    coeff_order = pos_in_group + 1  # order within block (after any EOB flush)

    # EOB runs: block needs EOB if its band tail is zero (incl. empty blocks)
    any_nz = nz.any(axis=1)
    last_nz = np.where(any_nz, prev_max[:, -1], -1)
    needs_eob = last_nz < 62
    has_content = any_nz

    # run starts: block b starts a run if needs_eob[b] and (has_content[b] or
    # b == 0 or previous run was flushed...).  Equivalent formulation: runs
    # are maximal sequences of consecutive needs_eob blocks not split by a
    # content block's symbols.  A content block with needs_eob starts its run
    # AFTER its own symbols; a no-content block joins the current run.
    # Compute run ids: a new run starts at block b when needs_eob[b] and
    # (has_content[b] or b == 0 or not needs_eob[b-1] ... or the previous
    # block ended a run because THIS block has content).  Simpler scan over
    # content blocks:
    # Run boundaries: every content block flushes the pending run before its
    # symbols.  Pending run length before content block b = number of
    # needs_eob "credits" issued since the last flush.  Credits: each block
    # with needs_eob adds 1 (content blocks add theirs after their symbols).
    credit = needs_eob.astype(np.int64)
    flush_points = np.nonzero(has_content)[0]  # flush before these blocks
    ccum = np.concatenate([[0], np.cumsum(credit)])  # credits before block b
    # pending before flush i = credits issued since the previous flush
    pend = np.diff(ccum[flush_points], prepend=0) if len(flush_points) else np.empty(0, np.int64)
    flushed_total = int(ccum[flush_points][-1]) if len(flush_points) else 0
    final_run = int(ccum[n]) - flushed_total

    # EOBn emissions.  Runs > 32767 (only possible with >32767 consecutive
    # all-zero-band blocks) split into multiple EOBn symbols.
    keep = pend > 0
    eb_block = flush_points[keep]
    eb_len = pend[keep]
    eb_order = np.full(len(eb_block), -100, dtype=np.int64)
    if final_run > 0:
        eb_block = np.append(eb_block, n - 1)
        eb_len = np.append(eb_len, final_run)
        eb_order = np.append(eb_order, 1 << 20)

    if len(eb_len) and eb_len.max() > 32767:
        blocks_l, lens_l, orders_l = [], [], []
        for b, length, o in zip(eb_block, eb_len, eb_order):
            length = int(length)
            while length > 32767:
                blocks_l.append(b); lens_l.append(32767); orders_l.append(o)
                o += 1
                length -= 32767
            blocks_l.append(b); lens_l.append(length); orders_l.append(o)
        eb_block = np.asarray(blocks_l, dtype=np.int64)
        eb_len = np.asarray(lens_l, dtype=np.int64)
        eb_order = np.asarray(orders_l, dtype=np.int64)

    if len(eb_len):
        cat = np.floor(np.log2(eb_len)).astype(np.int64)
        eob_syms = (cat << 4).astype(np.uint8)
        eob_extra = (eb_len - (1 << cat)).astype(np.uint32)
        eob_elen = cat
    else:
        eob_syms = np.empty(0, np.uint8)
        eob_extra = np.empty(0, np.uint32)
        eob_elen = np.empty(0, np.int64)

    all_sym = np.concatenate([sym, eob_syms])
    all_extra = np.concatenate([extra, eob_extra])
    all_elen = np.concatenate([extra_len, eob_elen])
    all_block = np.concatenate([coeff_block, eb_block])
    all_order = np.concatenate([coeff_order, eb_order])

    order = np.lexsort((all_order, all_block))
    return all_sym[order], all_extra[order], all_elen[order]


def encode_scan(symbols, extra, extra_len, codes_lut, lens_lut):
    """Merge Huffman codes with extra bits and pack."""
    hcodes = codes_lut[symbols].astype(np.uint64)
    hlens = lens_lut[symbols].astype(np.int64)
    merged = (hcodes << extra_len.astype(np.uint64)) | extra.astype(np.uint64)
    mlens = hlens + extra_len
    return pack_bits(merged.astype(np.uint32), mlens.astype(np.uint8))
