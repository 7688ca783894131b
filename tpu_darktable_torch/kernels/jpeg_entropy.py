"""JPEG baseline entropy scan: wrapper of csrc/jpeg_entropy.cu and its plain
version.

Replaces no TPU kernel: the JAX package's device scan
(tpu_darktable/ops/jpeg_entropy.py) is plain JAX, and the port's plain
version is ops/jpeg_entropy.py `_entropy_pack_device`, which this wrapper
runs for CPU tensors.  On the card the scan is bound neither by bytes nor by
operations but by the chain of bit offsets, each item's the sum of all the
lengths before it; the kernel breaks the chain into prefix sums (in a warp,
in a chunk of 64 blocks, over the chunks and intervals in one CTA) and
emits each chunk's words from shared memory (see the source's note).

Both routes return the stream as int32 words (the bits of a uint32, the
first bit in bit 31) and the small int64 tensor [bytes of each interval,
total words, overflow], equal for the same blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from . import launch
from .._device import constant_on

CHUNK = 64   # blocks a CTA of the lengths and emit launches (csrc)


def blocks_per_mcu(n_comp: int, subsampling: int) -> int:
    """Blocks an MCU: 1 (GRAY), 4 (4:2:2: Y0 Y1 Cb Cr) or 3 (4:4:4)."""
    if n_comp == 1:
        return 1
    return 4 if subsampling == 1 else 3


def jpeg_entropy(comp_blocks, subsampling: int, restart_interval: int, cap_words: int):
    """Per-component (N, 64) int16 zigzag blocks (one for GRAY, else Y, Cb,
    Cr) -> (stream, small): the scan's intervals of `restart_interval` MCUs
    (> 0), each byte-aligned with 1-bits and rounded up to whole words, one
    after another in int32 words; `small` the per-interval bytes, the total
    words and the overflow flag (an interval over `cap_words` words).
    On an overflow the stream is not defined: the caller encodes on the
    host."""
    comp_blocks = tuple(comp_blocks)
    if len(comp_blocks) not in (1, 3):
        raise ValueError(f'expected 1 or 3 components, got {len(comp_blocks)}')
    dev = comp_blocks[0].device
    for b in comp_blocks:
        if b.dtype != torch.int16 or b.ndim != 2 or b.shape[1] != 64:
            raise RuntimeError(f'blocks must be (N, 64) int16, got {b.dtype} {tuple(b.shape)}')
        if b.device != dev:
            raise RuntimeError(f'blocks on {dev} and {b.device}')
    bpm = blocks_per_mcu(len(comp_blocks), subsampling)
    n_mcu = comp_blocks[1].shape[0] if bpm == 4 else comp_blocks[0].shape[0]
    want = [n_mcu * (2 if (bpm == 4 and i == 0) else 1) for i in range(len(comp_blocks))]
    if [b.shape[0] for b in comp_blocks] != want:
        raise RuntimeError(f'block counts {[b.shape[0] for b in comp_blocks]} do not make '
                           f'{n_mcu} MCUs of {bpm} blocks')
    if n_mcu < 1 or restart_interval < 1 or cap_words < 1:
        raise ValueError(f'need blocks, restart_interval >= 1 and cap_words >= 1, got '
                         f'{n_mcu} MCUs, {restart_interval}, {cap_words}')
    if dev.type == 'cpu':
        return jpeg_entropy_plain(comp_blocks, subsampling, restart_interval, cap_words)
    if not all(b.is_contiguous() for b in comp_blocks):
        raise RuntimeError('jpeg_entropy: blocks must be contiguous')
    ri = int(restart_interval)
    n_iv = -(-n_mcu // ri)
    n_chunks = n_iv * -(-(ri * bpm) // CHUNK)
    words = torch.empty(n_iv * cap_words, dtype=torch.int32, device=dev)
    small = torch.empty(n_iv + 2, dtype=torch.int64, device=dev)
    bits = torch.empty(n_chunks * CHUNK, dtype=torch.int32, device=dev)
    scratch = torch.empty(n_chunks + 2 * n_iv, dtype=torch.int64, device=dev)
    launch('jpeg_entropy', dev, *(comp_blocks + (None, None))[:3],
           constant_on(table_entries().view(np.int32), dev), n_mcu, ri, bpm, int(cap_words), bits,
           scratch, scratch[n_chunks:], scratch[n_chunks + n_iv:], small, words)
    return words, small


def jpeg_entropy_plain(comp_blocks, subsampling: int, restart_interval: int, cap_words: int):
    """Plain PyTorch version: `_entropy_pack_device` (fixed emission slots
    joined by pairwise doubling), its int64-held words as int32."""
    from ..ops.jpeg_entropy import _entropy_pack_device

    stream, iv_bytes, total_words, overflow = _entropy_pack_device(
        comp_blocks, subsampling, restart_interval, cap_words)
    words = (stream - ((stream >> 31) << 32)).to(torch.int32)
    return words, torch.cat([iv_bytes, total_words[None], overflow[None].to(torch.int64)])


def table_entries() -> np.ndarray:
    """(2, 16 + 256) uint32: for table ids 0 (luma) and 1 (chroma) the DC
    entries by size, then the AC entries by symbol, each (length << 16) |
    code."""
    from ..ops.jpeg import _HUFF

    out = np.zeros((2, 16 + 256), np.uint32)
    for tid in (0, 1):
        for col, kind, n in ((0, 'dc', 16), (16, 'ac', 256)):
            codes, lens = _HUFF[(kind, tid)]
            out[tid, col:col + n] = (lens[:n].astype(np.uint32) << 16) | codes[:n].astype(np.uint32)
    return out


__all__ = ['blocks_per_mcu', 'jpeg_entropy', 'jpeg_entropy_plain', 'table_entries']
