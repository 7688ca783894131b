"""Native (C++) host helpers: JPEG bit packing, the baseline entropy scan and
the host packed-12 decode.

`bitpack.cpp` is compiled with g++ at first use into a shared library bound
with ctypes.  It is built into `build/native/` at the root of the checkout
(a user cache directory for an installed package, or TD_TORCH_BUILD_DIR;
`_paths.build_root`) and named by a hash of its source and flags, so an
unchanged source is not rebuilt.  Every entry point has a numpy version for
a host without a compiler.  The ctypes calls release the GIL, so the scan
runs in parallel in threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from .._paths import build_root

SOURCE = Path(__file__).resolve().parent / 'bitpack.cpp'
GXX_FLAGS = ['-O3', '-shared', '-fPIC', '-pthread']

_LIB = None
_TRIED = False
_LOCK = threading.Lock()


def build_dir() -> Path:
    return build_root('native')


def lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + ' '.join(GXX_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f'libtd_torch_native-{digest}.so'


def _build_lib() -> Path | None:
    out = lib_path()
    if out.exists():
        return out
    with tempfile.NamedTemporaryFile(suffix='.so', dir=out.parent, delete=False) as tmp:
        tmp_path = Path(tmp.name)
    try:
        subprocess.run(['g++', *GXX_FLAGS, '-o', str(tmp_path), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp_path.unlink(missing_ok=True)
        return None
    tmp_path.replace(out)   # atomic: concurrent builds each publish a whole file
    return out


def _bind(lib):
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    ll = ctypes.c_longlong
    lib.jpeg_pack_bits.restype = ll
    lib.jpeg_pack_bits.argtypes = [u32p, u8p, ll, u8p, ll]
    lib.decode12_u16_host.restype = None
    lib.decode12_u16_host.argtypes = [u8p, ctypes.POINTER(ctypes.c_uint16), ll, ctypes.c_int]
    tables = [u32p, u8p, u32p, u8p, u32p, u8p, u32p, u8p]
    lib.jpeg_encode_baseline.restype = ll
    lib.jpeg_encode_baseline.argtypes = [i16p, ll, i16p, i16p, ll, ctypes.c_int, *tables, u8p, ll]
    lib.jpeg_encode_baseline_rst.restype = ll
    lib.jpeg_encode_baseline_rst.argtypes = [i16p, ll, i16p, i16p, ll, ctypes.c_int, *tables,
                                             ll, ctypes.c_int, u8p, ll]
    return lib


def get_lib():
    """The loaded native library, built first if needed; None where it
    cannot be built or loaded."""
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            path = _build_lib()
            if path is not None:
                try:
                    _LIB = _bind(ctypes.CDLL(str(path)))
                except OSError:
                    _LIB = None
        return _LIB


def pack_bits(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Pack (code, length) emissions MSB-first with JPEG 0xFF stuffing.

    Uses the C++ packer when available, else a numpy version.
    """
    codes = np.ascontiguousarray(codes, dtype=np.uint32)
    lengths = np.ascontiguousarray(lengths, dtype=np.uint8)
    lib = get_lib()
    if lib is not None:
        capacity = int(lengths.astype(np.int64).sum() // 8 * 2 + 64)
        out = np.empty(capacity, dtype=np.uint8)
        n = lib.jpeg_pack_bits(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(codes),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            capacity,
        )
        if n >= 0:
            return out[:n]
    return _pack_bits_numpy(codes, lengths)


def jpeg_encode_baseline_native(
    comp_blocks, subsampling: int, tables,
    restart_interval: int = 0, n_threads: int = 0,
) -> np.ndarray | None:
    """Single-pass C++ baseline entropy scan; None if the library is missing.

    comp_blocks: list of (n, 64) int16 zigzag coefficient arrays (1 or 3).
    tables: ((dc0c, dc0l, ac0c, ac0l), (dc1c, dc1l, ac1c, ac1l)).
    restart_interval: MCUs per restart interval; > 0 switches to the
        thread-parallel scan joined with RSTn markers (byte-identical for
        any n_threads).  The caller must emit a matching DRI segment.
    n_threads: worker threads for the restart path (0 = hardware count).
    """
    lib = get_lib()
    if lib is None:
        return None
    i16p = ctypes.POINTER(ctypes.c_int16)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    yb = np.ascontiguousarray(comp_blocks[0], dtype=np.int16)
    ny = yb.shape[0]
    if len(comp_blocks) == 3:
        cbb = np.ascontiguousarray(comp_blocks[1], dtype=np.int16)
        crb = np.ascontiguousarray(comp_blocks[2], dtype=np.int16)
        nc = cbb.shape[0]
        cb_ptr = cbb.ctypes.data_as(i16p)
        cr_ptr = crb.ctypes.data_as(i16p)
    else:
        nc = 0
        cb_ptr = ctypes.cast(None, i16p)
        cr_ptr = ctypes.cast(None, i16p)

    (dc0c, dc0l, ac0c, ac0l), (dc1c, dc1l, ac1c, ac1l) = tables
    args = []
    for arr, typ in ((dc0c, u32p), (dc0l, u8p), (ac0c, u32p), (ac0l, u8p),
                     (dc1c, u32p), (dc1l, u8p), (ac1c, u32p), (ac1l, u8p)):
        a = np.ascontiguousarray(arr, dtype=np.uint32 if typ is u32p else np.uint8)
        args.append((a, a.ctypes.data_as(typ)))  # keep refs alive

    n_mcu = ny if nc == 0 else (nc if subsampling == 1 else ny)
    n_iv = (n_mcu + restart_interval - 1) // restart_interval if restart_interval else 1
    cap = int((ny + 2 * nc) * 64 * 4 + 4096 + 2 * n_iv)
    out = np.empty(cap, dtype=np.uint8)
    if restart_interval > 0:
        n = lib.jpeg_encode_baseline_rst(
            yb.ctypes.data_as(i16p), ny, cb_ptr, cr_ptr, nc, subsampling,
            *(p for _, p in args),
            restart_interval, n_threads,
            out.ctypes.data_as(u8p), cap,
        )
    else:
        n = lib.jpeg_encode_baseline(
            yb.ctypes.data_as(i16p), ny, cb_ptr, cr_ptr, nc, subsampling,
            *(p for _, p in args),
            out.ctypes.data_as(u8p), cap,
        )
    if n < 0:
        return None
    return out[:n]


def _pack_bits_numpy(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Vectorized numpy bit packer (for a host without the library)."""
    lengths64 = lengths.astype(np.int64)
    total_bits = int(lengths64.sum())
    offsets = np.concatenate(([0], np.cumsum(lengths64)[:-1]))
    n_bytes = (total_bits + 7) // 8

    # Place each emission into an 8-byte window starting at its byte offset.
    buf = np.zeros(n_bytes + 8, dtype=np.uint8)
    byte_idx = offsets // 8
    bit_in_byte = offsets % 8
    shift = 64 - bit_in_byte - lengths64
    vals = codes.astype(np.uint64) << shift.astype(np.uint64)
    for b in range(8):
        part = ((vals >> np.uint64(8 * (7 - b))) & np.uint64(0xFF)).astype(np.uint8)
        np.bitwise_or.at(buf, byte_idx + b, part)
    buf = buf[:n_bytes]
    # pad final partial byte with 1s
    rem = total_bits % 8
    if rem:
        buf[-1] |= (1 << (8 - rem)) - 1
    # 0xFF byte stuffing
    is_ff = buf == 0xFF
    if is_ff.any():
        reps = np.where(is_ff, 2, 1)
        out = np.zeros(int(reps.sum()), dtype=np.uint8)
        pos = np.concatenate(([0], np.cumsum(reps)[:-1]))
        out[pos] = buf
        return out
    return buf


def decode12_u16_host(packed: np.ndarray, ids_format: bool = False) -> np.ndarray:
    """Host-side packed-12 decode (the layouts of ops/packed.py) for file loaders."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    if packed.size % 3:
        raise ValueError('packed length must be multiple of 3')
    n_pairs = packed.size // 3
    lib = get_lib()
    if lib is not None:
        out = np.empty(n_pairs * 2, dtype=np.uint16)
        lib.decode12_u16_host(
            packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            n_pairs,
            1 if ids_format else 0,
        )
        return out
    t = packed.reshape(-1, 3).astype(np.uint16)
    if ids_format:
        p0 = (t[:, 0] << 4) | (t[:, 2] & 0xF)
        p1 = (t[:, 1] << 4) | (t[:, 2] >> 4)
    else:
        p0 = ((t[:, 1] & 0xF) << 8) | t[:, 0]
        p1 = (t[:, 2] << 4) | (t[:, 1] >> 4)
    return np.stack((p0, p1), axis=1).reshape(-1)


__all__ = ['decode12_u16_host', 'get_lib', 'jpeg_encode_baseline_native', 'pack_bits']
