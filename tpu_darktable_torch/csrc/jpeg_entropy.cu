// JPEG baseline entropy scan for Hopper (sm_90a): the Huffman emission and
// bit packing of quantized zigzag blocks into the packed stream that
// ops/jpeg_entropy.py reads back, in three launches.
//
// Replaces no TPU kernel: the JAX package's scan (tpu_darktable/ops/
// jpeg_entropy.py, `_entropy_pack_device`) is plain JAX, fixed-slot
// emissions joined by pairwise doubling, and so was the port's plain version
// (`_entropy_pack_device`, which the wrapper keeps for CPU tensors).  On the
// card that plain version ran ~1,100 generic int64 ops, 60.7 ms a 12 MP frame.
//
// Contract (the plain version's, bit for bit).  MCUs run in scan order
// (GRAY: Y; 444: Y Cb Cr; 422: Y0 Y1 Cb Cr), cut into restart intervals of
// `ri` MCUs; the last may be short.  Each interval restarts the DC
// predictors, is byte-aligned with 1-bits and rounded up to whole 32-bit
// words; the intervals follow one another in the stream.  A word holds its
// first bit in bit 31.  small = [bytes of each interval, total words,
// overflow], overflow set where an interval's padded bits exceed
// `cap_words` * 32; the stream is then not written, and the host encodes.
// Coefficients outside the baseline ranges (a DC difference over 11 bits,
// an AC value over 10) also set it: the DCT stage never makes them.
//
// What bounds it on this card.  At 12 MP (4:2:2, 385,024 blocks) the scan
// reads 49.3 MB of int16 and writes 2-6 MB: 0.016 ms at 3.35 TB/s; ~40
// integer operations a coefficient make 0.03 ms at 33.5 T/s.  Neither binds:
// the dependency chain does.  Every item's bit offset is the sum of the
// lengths of all items before it in its interval, and an interval's word
// offset the sum of the intervals before it, so a serial coder walks 24.6 M
// coefficients in order (the host scan: 16 ms on one core).
//
// Design: the chain becomes a three-level prefix sum, and nothing runs in
// order.
//  - A chunk is CHUNK consecutive blocks of one interval, a CTA of WARPS
//    warps; a warp takes one block at a time, a lane its coefficients at
//    positions lane and lane + 32.  Two ballots give the 63-bit nonzero
//    mask, from which each nonzero coefficient finds the previous one
//    (__clzll) and so its run and folded ZRLs; the DC difference needs only
//    the previous block of its component, read from memory.  The Annex K
//    tables sit in shared memory.  A warp scan of the item lengths places
//    every item in its block.
//  - Launch 1 (lengths): each block's bits and each chunk's sum; it also
//    zeroes the stream.
//  - Launch 2 (place, one CTA): a scan of the chunk sums gives each chunk's
//    offset in its interval and each interval's length, bytes, words and
//    overflow; a scan of the word counts places the intervals.
//  - Launch 3 (emit): a CTA scans its chunk's block bits in shared memory,
//    ORs every item into a staging copy of the chunk's words there, and
//    writes the words out coalesced.  Only a chunk's first and last words
//    may hold bits of a neighbouring chunk; those two go out as atomicOr
//    into the zeroed stream, the rest as plain stores.
// The stage for a chunk is bounded by CHUNK blocks of at most 1,665 bits
// whatever the interval's length, so any restart interval, 0 (one interval
// a frame) included, takes the same route.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNK = 64;                  // blocks a chunk (a CTA of the lengths and emit launches)
constexpr int PER_WARP = CHUNK / WARPS;
constexpr int MAX_BLOCK_BITS = 1665;       // DC 27 + 63 AC items of 26 bits
constexpr int STAGE_WORDS = (CHUNK * MAX_BLOCK_BITS + 31 + 7) / 32 + 1;
constexpr int TABLE = 16 + 256;            // a table id's DC (by size) then AC (by symbol) entries
constexpr int PLACE_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
// the bits a chunk reports when a coefficient is outside the baseline
// ranges: more than any interval's capacity, so the scan overflows
constexpr long long BAD_BITS = 1LL << 40;

struct Scan {
  const short* comp[3];  // Y, Cb, Cr blocks (N, 64); Cb and Cr unused for GRAY
  const unsigned* tables;  // (2, TABLE) entries (length << 16) | code
  long long n_mcu, ri, bpm, cpi, n_iv, cap_words;
};

__device__ __forceinline__ int bit_size(int v) {
  return 32 - __clz(v < 0 ? -v : v);
}

__device__ __forceinline__ unsigned extra_bits(int v, int size) {
  return (unsigned)(v >= 0 ? v : v - 1) & ((1u << size) - 1u);
}

__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// The blocks of chunk c: [b0, b0 + nb) in scan order; `last` if the chunk
// ends its interval.
struct Chunk {
  long long iv, b0, nb;
  bool last;
};

__device__ __forceinline__ Chunk chunk_of(const Scan& s, long long c) {
  Chunk k;
  k.iv = c / s.cpi;
  const long long iv_b0 = k.iv * s.ri * s.bpm;
  const long long iv_b1 = min((k.iv + 1) * s.ri, s.n_mcu) * s.bpm;
  k.b0 = iv_b0 + (c - k.iv * s.cpi) * CHUNK;
  const long long b1 = min(k.b0 + CHUNK, iv_b1);
  k.nb = b1 > k.b0 ? b1 - k.b0 : 0;
  k.last = k.nb > 0 && b1 == iv_b1;
  return k;
}

// Block b's items: the lane's two, at zigzag positions lane (the DC item
// at lane 0) and lane + 32, right-aligned in v with lengths n and bit
// offsets off in the block.  Returns the block's bits, its EOB included
// (eob: the EOB's table entry, 0 if the block has none; the EOB ends the
// block).  Every lane of the warp calls it; an invalid block has no items.
// bad: a coefficient outside the baseline ranges.
__device__ __forceinline__ int block_items(const Scan& s, const unsigned* tabs, long long b,
                                           bool valid, int lane, unsigned long long v[2],
                                           int n[2], int off[2], unsigned& eob, bool& bad) {
  const short* blk = s.comp[0];
  const unsigned* tab = tabs;
  int pred = 0;
  if (valid) {
    const long long m = b / s.bpm;
    const int slot = (int)(b - m * s.bpm);
    int comp = slot;
    long long j = m;
    bool first = m % s.ri == 0;
    if (s.bpm == 4) {  // 4:2:2: Y0 Y1 Cb Cr
      comp = slot < 2 ? 0 : slot - 1;
      j = slot < 2 ? 2 * m + slot : m;
      first = first && slot != 1;
    }
    // a select, not s.comp[comp]: an index into the parameter would put it on the stack
    blk = (comp == 0 ? s.comp[0] : comp == 1 ? s.comp[1] : s.comp[2]) + j * 64;
    tab = tabs + (comp ? TABLE : 0);
    if (lane == 0 && !first) pred = blk[-64];
  }
  const int c0 = valid ? blk[lane] : 0;
  const int c1 = valid ? blk[lane + 32] : 0;
  const unsigned lo = __ballot_sync(FULL, c0 != 0);
  const unsigned hi = __ballot_sync(FULL, c1 != 0);
  const unsigned long long ac = ((unsigned long long)hi << 32 | lo) & ~1ull;
  const unsigned zrl = tab[16 + 0xF0];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = lane + 32 * h;
    const int c = h ? c1 : c0;
    unsigned long long val = 0;
    int len = 0;
    if (p == 0) {
      if (valid) {
        const int diff = c - pred;
        const int size = bit_size(diff);
        bad = bad || size > 11;
        const unsigned e = tab[size & 15];
        val = (unsigned long long)(e & 0xFFFFu) << size | extra_bits(diff, size);
        len = (int)(e >> 16) + size;
      }
    } else if (c != 0) {
      const unsigned long long below = ac & ((1ull << p) - 1ull);
      const int run = p - 1 - (below ? 63 - __clzll(below) : 0);
      const int size = bit_size(c);
      bad = bad || size > 10;
      for (int z = 0; z < run >> 4; ++z) {  // folded ZRLs
        val = val << (zrl >> 16) | (zrl & 0xFFFFu);
        len += (int)(zrl >> 16);
      }
      const unsigned e = tab[16 + ((((run & 15) << 4) | size) & 255)];
      val = (val << (e >> 16) | (e & 0xFFFFu)) << size | extra_bits(c, size);
      len += (int)(e >> 16) + size;
    }
    v[h] = val;
    n[h] = len;
  }
  const int in0 = warp_inclusive_sum(n[0], lane);
  const int t0 = __shfl_sync(FULL, in0, 31);
  const int in1 = warp_inclusive_sum(n[1], lane);
  const int t1 = __shfl_sync(FULL, in1, 31);
  off[0] = in0 - n[0];
  off[1] = t0 + in1 - n[1];
  eob = valid && !(hi >> 31) ? tab[16] : 0u;
  return t0 + t1 + (int)(eob >> 16);
}

// Launch 1: each block's bits (bits[c * CHUNK + i]) and each chunk's sum
// (chunk_bits[c]); the stream zeroed.
__global__ void __launch_bounds__(THREADS) jpeg_entropy_lengths(
    Scan s, int* bits, long long* chunk_bits, int* stream, long long stream_words) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < stream_words;
       i += (long long)gridDim.x * THREADS)
    stream[i] = 0;
  __shared__ unsigned tabs[2 * TABLE];
  __shared__ long long warp_bits[WARPS];
  __shared__ int warp_bad[WARPS];
  for (int i = threadIdx.x; i < 2 * TABLE; i += THREADS) tabs[i] = s.tables[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Chunk k = chunk_of(s, blockIdx.x);
  long long sum = 0;
  bool bad = false;
  for (int it = 0; it < PER_WARP; ++it) {
    const int i = it * WARPS + warp;
    unsigned long long v[2];
    int n[2], off[2];
    unsigned eob;
    const int t = block_items(s, tabs, k.b0 + i, i < k.nb, lane, v, n, off, eob, bad);
    if (lane == 0) bits[(long long)blockIdx.x * CHUNK + i] = t;
    sum += t;
  }
  const bool warp_any_bad = __ballot_sync(FULL, bad) != 0;
  if (lane == 0) {
    warp_bits[warp] = sum;
    warp_bad[warp] = warp_any_bad;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long total = 0;
    int any_bad = 0;
    for (int w = 0; w < WARPS; ++w) {
      total += warp_bits[w];
      any_bad |= warp_bad[w];
    }
    chunk_bits[blockIdx.x] = any_bad ? BAD_BITS : total;
  }
}

// An exclusive sum over the CTA's PLACE_THREADS threads; every warp takes
// the second level itself, so all run the same shuffles.
__device__ long long cta_exclusive_sum(long long x, long long* warp_sums, long long& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  long long w = lane < PLACE_THREADS / 32 ? warp_sums[lane] : 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(FULL, w, d);
    if (lane >= d) w += y;
  }
  const long long before = __shfl_sync(FULL, w, (warp + 31) & 31);
  total = __shfl_sync(FULL, w, 31);
  __syncthreads();
  return inc - x + (warp ? before : 0);
}

// x[0, n) -> its exclusive prefix sums, in place; returns the sum.  Thread
// t takes a run of consecutive entries.
__device__ long long cta_exclusive_scan(long long* x, long long n, long long* warp_sums) {
  const long long per = (n + PLACE_THREADS - 1) / PLACE_THREADS;
  const long long lo = min(n, threadIdx.x * per), hi = min(n, lo + per);
  long long run = 0;
  for (long long i = lo; i < hi; ++i) run += x[i];
  long long total;
  run = cta_exclusive_sum(run, warp_sums, total);
  for (long long i = lo; i < hi; ++i) {
    const long long t = x[i];
    x[i] = run;
    run += t;
  }
  return total;
}

// Launch 2 (one CTA): chunk_bits -> each chunk's exclusive offset in the
// scan (chunk_s, in place); each interval's first chunk offset (iv_base),
// bytes (small[iv]) and word offset in the stream (iv_woff); the total
// words and the overflow flag (small[n_iv], small[n_iv + 1]).
__global__ void __launch_bounds__(PLACE_THREADS) jpeg_entropy_place(
    Scan s, long long* chunk_s, long long* iv_base, long long* iv_woff, long long* small) {
  __shared__ long long warp_sums[PLACE_THREADS / 32];
  __shared__ int overflow;
  if (threadIdx.x == 0) overflow = 0;
  const long long n_chunks = s.n_iv * s.cpi;
  const long long total_bits = cta_exclusive_scan(chunk_s, n_chunks, warp_sums);
  __syncthreads();
  for (long long iv = threadIdx.x; iv < s.n_iv; iv += PLACE_THREADS) {
    const long long b = chunk_s[iv * s.cpi];
    const long long e = iv + 1 < s.n_iv ? chunk_s[(iv + 1) * s.cpi] : total_bits;
    const long long padded = (e - b + 7) & ~7LL;
    iv_base[iv] = b;
    small[iv] = padded >> 3;
    iv_woff[iv] = ((padded >> 3) + 3) >> 2;
    if (padded > s.cap_words * 32) overflow = 1;
  }
  __syncthreads();
  const long long total_words = cta_exclusive_scan(iv_woff, s.n_iv, warp_sums);
  if (threadIdx.x == 0) {
    small[s.n_iv] = total_words;
    small[s.n_iv + 1] = overflow;
  }
}

// OR the n-bit item v (n >= 1) into the staging words at bit pos.
__device__ __forceinline__ void stage_or(unsigned* stage, long long pos, unsigned long long v, int n) {
  const unsigned long long x = v << (64 - n);
  const int sh = (int)(pos & 31);
  const unsigned long long hi = x >> sh;
  const unsigned w2 = sh ? (unsigned)((x << (64 - sh)) >> 32) : 0u;
  unsigned* w = stage + (pos >> 5);
  if ((unsigned)(hi >> 32)) atomicOr(w, (unsigned)(hi >> 32));
  if ((unsigned)hi) atomicOr(w + 1, (unsigned)hi);
  if (w2) atomicOr(w + 2, w2);
}

// Launch 3: the chunk's items into shared memory at their offsets, then
// its words into the stream.
__global__ void __launch_bounds__(THREADS) jpeg_entropy_emit(
    Scan s, const int* bits, const long long* chunk_s, const long long* iv_base,
    const long long* iv_woff, const long long* small, int* stream) {
  const Chunk k = chunk_of(s, blockIdx.x);
  if (k.nb == 0 || small[s.n_iv + 1]) return;  // an empty chunk; or overflow: the host encodes
  __shared__ unsigned tabs[2 * TABLE];
  __shared__ int block_off[CHUNK];
  __shared__ unsigned stage[STAGE_WORDS];
  for (int i = threadIdx.x; i < 2 * TABLE; i += THREADS) tabs[i] = s.tables[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the chunk's blocks' offsets: every warp scans the CHUNK entries, warp 0 keeps them
  const int* cb = bits + (long long)blockIdx.x * CHUNK;
  const int a = cb[lane], b = cb[lane + 32];
  const int ia = warp_inclusive_sum(a, lane);
  const int ta = __shfl_sync(FULL, ia, 31);
  const int ib = warp_inclusive_sum(b, lane);
  const int chunk_bits = ta + __shfl_sync(FULL, ib, 31);
  if (warp == 0) {
    block_off[lane] = ia - a;
    block_off[lane + 32] = ta + ib - b;
  }
  const long long start = iv_woff[k.iv] * 32 + (chunk_s[blockIdx.x] - iv_base[k.iv]);
  const int lead = (int)(start & 31);
  const int end = lead + chunk_bits;                      // bit of the stage after the items
  const int pad = k.last ? (8 - (end & 7)) & 7 : 0;       // the interval's 1-bits to a byte
  const int n_words = (end + pad + 31) >> 5;
  for (int i = threadIdx.x; i < n_words; i += THREADS) stage[i] = 0u;
  __syncthreads();
  bool bad = false;
  for (int it = 0; it < PER_WARP; ++it) {
    const int i = it * WARPS + warp;
    unsigned long long v[2];
    int n[2], off[2];
    unsigned eob;
    const int t = block_items(s, tabs, k.b0 + i, i < k.nb, lane, v, n, off, eob, bad);
    const int base = lead + block_off[i];
    if (n[0]) stage_or(stage, base + off[0], v[0], n[0]);
    if (n[1]) stage_or(stage, base + off[1], v[1], n[1]);
    if (eob && lane == 0) stage_or(stage, base + t - (int)(eob >> 16), eob & 0xFFFFu, (int)(eob >> 16));
  }
  if (pad && threadIdx.x == 0) stage_or(stage, end, (1u << pad) - 1u, pad);
  __syncthreads();
  int* out = stream + (start >> 5);
  for (int i = threadIdx.x; i < n_words; i += THREADS) {
    if (i == 0 || i == n_words - 1) {
      if (stage[i]) atomicOr((unsigned*)out + i, stage[i]);
    } else {
      out[i] = (int)stage[i];
    }
  }
}

}  // namespace

// The three launches on `stream`.  y, cb, cr: (N, 64) int16 blocks (cb, cr
// null for GRAY); tables: (2, 16 + 256) entries; bpm: 1 (GRAY), 3 (444) or 4
// (422); ri: MCUs an interval (> 0).  Scratch from the caller: bits
// (n_chunks * 64 int32), chunk_s (n_chunks int64), iv_base and iv_woff (n_iv
// int64 each), with n_iv = ceil(n_mcu / ri) and n_chunks = n_iv *
// ceil(ri * bpm / 64).  Out: small (n_iv + 2 int64) and words (n_iv *
// cap_words int32).  Returns the first nonzero cudaError_t.
extern "C" int jpeg_entropy_launch(const void* y, const void* cb, const void* cr,
                                   const void* tables, long long n_mcu, long long ri, int bpm,
                                   long long cap_words, void* bits, void* chunk_s,
                                   void* iv_base, void* iv_woff, void* small, void* words,
                                   void* stream) {
  if (n_mcu < 1 || ri < 1 || cap_words < 1 || !(bpm == 1 || bpm == 3 || bpm == 4))
    return (int)cudaErrorInvalidValue;
  Scan s;
  s.comp[0] = static_cast<const short*>(y);
  s.comp[1] = static_cast<const short*>(cb);
  s.comp[2] = static_cast<const short*>(cr);
  s.tables = static_cast<const unsigned*>(tables);
  s.n_mcu = n_mcu;
  s.ri = ri;
  s.bpm = bpm;
  s.cpi = (ri * bpm + CHUNK - 1) / CHUNK;
  s.n_iv = (n_mcu + ri - 1) / ri;
  s.cap_words = cap_words;
  const long long n_chunks = s.n_iv * s.cpi;
  if (n_chunks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)n_chunks;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* const block_bits = static_cast<int*>(bits);
  long long* const cs = static_cast<long long*>(chunk_s);
  long long* const base = static_cast<long long*>(iv_base);
  long long* const woff = static_cast<long long*>(iv_woff);
  long long* const sm = static_cast<long long*>(small);
  int* const out = static_cast<int*>(words);
  const long long n_words = s.n_iv * cap_words;
  jpeg_entropy_lengths<<<grid, THREADS, 0, st>>>(s, block_bits, cs, out, n_words);
  int status = (int)cudaGetLastError();
  if (status != 0) return status;
  jpeg_entropy_place<<<1, PLACE_THREADS, 0, st>>>(s, cs, base, woff, sm);
  status = (int)cudaGetLastError();
  if (status != 0) return status;
  jpeg_entropy_emit<<<grid, THREADS, 0, st>>>(s, block_bits, cs, base, woff, sm, out);
  return (int)cudaGetLastError();
}
