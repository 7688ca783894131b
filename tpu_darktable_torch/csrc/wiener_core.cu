// Wiener tile core for Hopper (sm_90a): window and mean fold, 2-D FFT,
// spectral Wiener gain, inverse FFT and synthesis window of every K x K
// tile, a warp to a pair of tiles, the data in registers.
//
// Replaces the TPU kernel tpu_darktable/kernels/wiener_core.py:wiener_tile_core.
// For a tile t, with wf2 = outer(wf, wf) and wi2 = outer(wi, wi):
//   m     = sum(t) / K^2
//   x     = (t - m) * wf2
//   X     = DFT2(x);  power = |X|^2 + 1e-15;  gain = max(power - sig2, 0) / power
//   y     = Re IDFT2(X gain) * wi2 + m * (wf2 * wi2)
//
// Design.  The TPU kernel multiplies flattened tiles by dense (K^2, 2R+1)
// bases, O(K^4) a tile.  Here the transform is a radix-2 FFT written out in
// the kernel's body:
//   - Two real tiles a and b ride one complex transform, z = (x_a + i x_b) / 2:
//     a complex 2-D FFT of K x K does the work of two real ones, every lane
//     has the same work in every pass, and no row or column is a special
//     case.  A warp owns one pair at K = 32 (lane j holds column j, K complex
//     values in 2K registers) and two pairs at K = 16 (a half-warp each).
//   - Each 1-D transform runs in the lane's registers, fully unrolled:
//     decimation in frequency, log2 K stages, the twiddles float literals of
//     cos(2 pi n / 32) rounded once from float64, so they are immediates;
//     multiplications by 1, -i and (+-1 - i) / sqrt 2 are written as the
//     swaps and two-multiply forms they are.  The bit-reversed order is
//     undone by renaming registers, which costs nothing.
//   - Columns first, then one transpose through a padded per-warp tile in
//     shared memory (32 x 33 floats each for re and im, conflict-free both
//     ways, __syncwarp only), then rows.
//   - The two spectra come apart by symmetry: X_a(u, v) = z(u, v) +
//     conj z(-u, -v), X_b = -i (z(u, v) - conj z(-u, -v)).  Row -u lives in
//     lane (K - u) % K, so one warp shuffle per value fetches the partner; the
//     gain of each tile is applied and the pair is recombined in place.  A
//     real tile's power is even, so half the gains come from the partner lane
//     by shuffle as well, not from a second division.
//   - The inverse is the same transform with re and im exchanged (a renaming
//     again), rows, transpose, columns; Re is tile a, Im tile b.  Synthesis
//     window, 1 / K^2 and the mean's map are applied on the store.
//   - Loads and stores are whole tile rows: 128 contiguous bytes a tile and
//     row at K = 32, and the two tiles of a pair are neighbours in the slab.
//   The only block-wide barrier follows the copy of the two windows into
//   shared memory; a block is four warps that never meet again.  Five
//   blocks an SM (__launch_bounds__) hold the kernel to 96 registers at
//   K = 32, an 8-byte spill, for 20 warps an SM; the 128 registers it takes
//   unbounded leave 16 and run 3% slower, 80 registers spill 256 bytes and
//   run 20% slower.
//
// Bound on the card: the function needs 8 bytes a pixel against ~74 float
// operations a pixel at K = 32 (a real 2-D FFT each way, 5 N log2 N for
// N = K^2, plus ~24 for mean, windows and gain), so bytes bound it.  As run
// the four complex FFT passes cost 31 operations a pixel (496 a 32-point
// transform, trivial twiddles removed), the split and gain ~9 with one IEEE
// division to two pixels, windows and mean ~12; each value also crosses
// shared memory twice and a shuffle once.
//
// The sums run in an FFT's order, so the kernel is not bit-equal to its
// plain version (dense bases, other order, the mean subtracted afterwards);
// it is held to 2e-6 * max(1, max|x|) against it.  The result does not
// depend on the grid: a tile's pair is fixed by its index.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;                  // warps a block
constexpr int BLOCKS_PER_SM = 5;
constexpr int TP = 33;                    // row pitch of the transpose tile
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float EPS = 1e-15f;

__host__ __device__ constexpr int bitrev(int x, int n) {
  int r = 0;
  for (int b = 1; b < n; b <<= 1) {
    r = (r << 1) | (x & 1);
    x >>= 1;
  }
  return r;
}

// cos(2 pi n / 32) for n in [0, 8], float64 values rounded once.
__device__ __forceinline__ float cos32(int n) {
  switch (n) {
    case 0: return 1.0f;
    case 1: return 0.98078528040323043f;
    case 2: return 0.92387953251128674f;
    case 3: return 0.83146961230254524f;
    case 4: return 0.70710678118654757f;
    case 5: return 0.55557023301960218f;
    case 6: return 0.38268343236508978f;
    case 7: return 0.19509032201612825f;
    default: return 0.0f;
  }
}

// (r + i im) *= exp(-2 pi i t / N) for t in [0, N / 2).  t is a constant
// once the caller's loops are unrolled, so one branch survives.
template <int N>
__device__ __forceinline__ void twiddle(float& r, float& im, int t) {
  const int n = t * (32 / N);   // in 32nds of a turn
  if (n == 0) return;
  const float x = r, y = im;
  if (n == 8) {
    r = y;
    im = -x;
  } else if (n == 4) {
    r = (x + y) * cos32(4);
    im = (y - x) * cos32(4);
  } else if (n == 12) {
    r = (y - x) * cos32(4);
    im = -((x + y) * cos32(4));
  } else {
    const float c = n < 8 ? cos32(n) : -cos32(16 - n);
    const float s = n < 8 ? cos32(8 - n) : cos32(n - 8);
    r = x * c + y * s;
    im = y * c - x * s;
  }
}

// One decimation-in-frequency stage of butterflies HALF apart, then the
// next; the recursion ends at HALF = 0.
template <int N, int HALF>
struct Dif {
  static __device__ __forceinline__ void run(float (&re)[N], float (&im)[N]) {
#pragma unroll
    for (int base = 0; base < N; base += 2 * HALF) {
#pragma unroll
      for (int n = 0; n < HALF; ++n) {
        const int i0 = base + n, i1 = i0 + HALF;
        const float ar = re[i0], ai = im[i0], br = re[i1], bi = im[i1];
        re[i0] = ar + br;
        im[i0] = ai + bi;
        float dr = ar - br, di = ai - bi;
        twiddle<N>(dr, di, n * (N / (2 * HALF)));
        re[i1] = dr;
        im[i1] = di;
      }
    }
    Dif<N, HALF / 2>::run(re, im);
  }
};
template <int N>
struct Dif<N, 0> {
  static __device__ __forceinline__ void run(float (&)[N], float (&)[N]) {}
};

// Forward N-point complex FFT of (re, im) in place, natural order in and
// out.  Called as fft(im, re) it is the inverse, not normalized.
template <int N>
__device__ __forceinline__ void fft(float (&re)[N], float (&im)[N]) {
  Dif<N, N / 2>::run(re, im);
  float tr[N], ti[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    tr[k] = re[bitrev(k, N)];
    ti[k] = im[bitrev(k, N)];
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    re[k] = tr[k];
    im[k] = ti[k];
  }
}

// Lane `col` of every row gives its K values, lane `row` takes its own row.
template <int K>
__device__ __forceinline__ void transpose(float (&re)[K], float (&im)[K], float* tre, float* tim,
                                          int rows0, int j) {
#pragma unroll
  for (int u = 0; u < K; ++u) {
    tre[(rows0 + u) * TP + j] = re[u];
    tim[(rows0 + u) * TP + j] = im[u];
  }
  __syncwarp();
#pragma unroll
  for (int v = 0; v < K; ++v) {
    re[v] = tre[(rows0 + j) * TP + v];
    im[v] = tim[(rows0 + j) * TP + v];
  }
  __syncwarp();
}

// z(u, v) = a + i b and its partner z(-u, -v) = c + i d as the two tiles'
// spectra: X_a = p + i q, X_b = r - i s.
struct Split {
  float p, q, r, s;
  __device__ __forceinline__ Split(float a, float b, float c, float d)
      : p(a + c), q(b - d), r(b + d), s(a - c) {}
  // max(power - sig2, 0) / power of each tile at this frequency
  __device__ __forceinline__ void gains(float s2a, float s2b, float& ga, float& gb) const {
    const float pa = (p * p + q * q) + EPS, pb = (r * r + s * s) + EPS;
    ga = fmaxf(pa - s2a, 0.0f) / pa;
    gb = fmaxf(pb - s2b, 0.0f) / pb;
  }
  // the new z(u, v): ga X_a + i gb X_b
  __device__ __forceinline__ void apply(float ga, float gb, float& a, float& b) const {
    a = ga * p + gb * s;
    b = ga * q + gb * r;
  }
};

struct Tile {
  size_t base;   // offset of the tile's first pixel in the slabs
  float s2;
  bool valid;
};

__device__ __forceinline__ Tile tile_at(int t, int k, int n_ty, int n_tx, int n_tiles,
                                        const float* __restrict__ sig2, int slabs_per_sig) {
  Tile tile;
  tile.valid = t < n_tiles;
  if (!tile.valid) t = 0;
  const int per_slab = n_ty * n_tx;
  const int g = t / per_slab, rem = t % per_slab;
  const int ty = rem / n_tx, tx = rem % n_tx;
  tile.base = ((size_t)g * n_ty * k + (size_t)ty * k) * ((size_t)n_tx * k) + (size_t)tx * k;
  tile.s2 = sig2[g / slabs_per_sig];
  return tile;
}

template <int K>
__global__ void __launch_bounds__(WARPS * 32, BLOCKS_PER_SM)
wiener_core_kernel(const float* __restrict__ slabs, float* __restrict__ out,
                   const float* __restrict__ sig2, const float* __restrict__ windows, int n_ty,
                   int n_tx, int n_tiles, int slabs_per_sig) {
  extern __shared__ float smem[];
  constexpr int PAIRS = 32 / K;   // tile pairs a warp
  float* wf = smem;               // analysis window
  float* wi = smem + K;           // synthesis window
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* tre = smem + 2 * K + warp * (2 * 32 * TP);
  float* tim = tre + 32 * TP;
  for (int n = threadIdx.x; n < 2 * K; n += blockDim.x) smem[n] = windows[n];
  __syncthreads();

  const int sub = lane / K, j = lane % K;   // the lane's pair in the warp; its column, then its row
  const int warp_pair0 = ((int)blockIdx.x * WARPS + warp) * PAIRS;
  if (2 * warp_pair0 >= n_tiles) return;    // the whole warp has no tile
  const int pair = warp_pair0 + sub;
  const Tile ta = tile_at(2 * pair, K, n_ty, n_tx, n_tiles, sig2, slabs_per_sig);
  const Tile tb = tile_at(2 * pair + 1, K, n_ty, n_tx, n_tiles, sig2, slabs_per_sig);
  const size_t row_len = (size_t)n_tx * K;
  const float inv_kk = 1.0f / (float)(K * K);
  const float wfj = wf[j], wij = wi[j];

  // a missing tile is all zeros: its gain is 0 / 1e-15, nothing is stored
  float re[K], im[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    re[i] = ta.valid ? slabs[ta.base + i * row_len + j] : 0.0f;
    im[i] = tb.valid ? slabs[tb.base + i * row_len + j] : 0.0f;
  }

  // tile means: the lane's column, then a butterfly over the K lanes of the
  // pair, which leaves every lane with the same sum
  float ma = re[0], mb = im[0];
#pragma unroll
  for (int i = 1; i < K; ++i) {
    ma = ma + re[i];
    mb = mb + im[i];
  }
#pragma unroll
  for (int m = K / 2; m >= 1; m /= 2) {
    ma = ma + __shfl_xor_sync(FULL_MASK, ma, m);
    mb = mb + __shfl_xor_sync(FULL_MASK, mb, m);
  }
  ma = ma * inv_kk;
  mb = mb * inv_kk;

  // analysis window at half weight, so that the split below needs no 1/2
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float w = (0.5f * wf[i]) * wfj;
    re[i] = (re[i] - ma) * w;
    im[i] = (im[i] - mb) * w;
  }

  fft<K>(re, im);                                   // columns: index i -> u
  transpose<K>(re, im, tre, tim, sub * K, j);       // the lane now holds row u = j
  fft<K>(re, im);                                   // rows: index -> v

  // z(-u, -v) is value (K - v) % K of lane (K - u) % K of the same pair.
  // v and K - v are updated together: each needs the other's old value in
  // the partner lane.  A real tile's power is even, |X(u, K - v)| =
  // |X(-u, v)|, and the partner lane computes exactly that (the same sums,
  // operands exchanged) in the same step, so the gains of K - v come by
  // shuffle: K + 2 divisions a lane in place of 2 K.
  const int partner = sub * K + (K - j) % K;
  float ga, gb;
#pragma unroll
  for (int v = 0; v <= K / 2; v += K / 2) {   // v = 0 and K / 2 are their own partners
    const Split z(re[v], im[v], __shfl_sync(FULL_MASK, re[v], partner),
                  __shfl_sync(FULL_MASK, im[v], partner));
    z.gains(ta.s2, tb.s2, ga, gb);
    z.apply(ga, gb, re[v], im[v]);
  }
#pragma unroll
  for (int v = 1; v < K / 2; ++v) {
    const float c1 = __shfl_sync(FULL_MASK, re[K - v], partner);
    const float d1 = __shfl_sync(FULL_MASK, im[K - v], partner);
    const float c2 = __shfl_sync(FULL_MASK, re[v], partner);
    const float d2 = __shfl_sync(FULL_MASK, im[v], partner);
    const Split z1(re[v], im[v], c1, d1), z2(re[K - v], im[K - v], c2, d2);
    z1.gains(ta.s2, tb.s2, ga, gb);
    z1.apply(ga, gb, re[v], im[v]);
    ga = __shfl_sync(FULL_MASK, ga, partner);
    gb = __shfl_sync(FULL_MASK, gb, partner);
    z2.apply(ga, gb, re[K - v], im[K - v]);
  }

  fft<K>(im, re);                                   // inverse rows
  transpose<K>(re, im, tre, tim, sub * K, j);       // the lane holds column j again
  fft<K>(im, re);                                   // inverse columns: K^2 (y_a + i y_b)

#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float w2f = wf[i] * wfj, w2i = wi[i] * wij;
    if (ta.valid) out[ta.base + i * row_len + j] = (re[i] * inv_kk) * w2i + ma * (w2f * w2i);
    if (tb.valid) out[tb.base + i * row_len + j] = (im[i] * inv_kk) * w2i + mb * (w2f * w2i);
  }
}

template <int K>
int launch(const float* slabs, float* out, const float* sig2, const float* windows, int g,
           int n_ty, int n_tx, int n_sig, cudaStream_t stream) {
  // tile indices are ints in the kernel, with room for the last block's overhang
  const long n_tiles = (long)g * n_ty * n_tx;
  if (n_tiles > 0x7fffffffL - 8 * WARPS) return (int)cudaErrorInvalidValue;
  const long pairs = (n_tiles + 1) / 2, warps = (pairs * K + 31) / 32;
  const long blocks = (warps + WARPS - 1) / WARPS;
  const int smem = (2 * K + WARPS * 2 * 32 * TP) * (int)sizeof(float);
  const int status = (int)cudaFuncSetAttribute(
      wiener_core_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (status != 0) return status;
  wiener_core_kernel<K><<<(unsigned)blocks, WARPS * 32, smem, stream>>>(
      slabs, out, sig2, windows, n_ty, n_tx, (int)n_tiles, g / n_sig);
  return (int)cudaGetLastError();
}

}  // namespace

// slabs, out: (G, n_ty K, n_tx K) float32; sig2: (n_sig,) with n_sig
// dividing G (slab g uses sig2[g / (G / n_sig)]); windows: (2, K) float32,
// rows wf and wi.  K is 16 or 32.
extern "C" int wiener_core_launch(const float* slabs, float* out, const float* sig2,
                                  const float* windows, int k, int g, int n_ty, int n_tx,
                                  int n_sig, void* stream) {
  if ((k != 16 && k != 32) || g < 1 || n_ty < 1 || n_tx < 1 || n_sig < 1 || g % n_sig)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return k == 32 ? launch<32>(slabs, out, sig2, windows, g, n_ty, n_tx, n_sig, st)
                 : launch<16>(slabs, out, sig2, windows, g, n_ty, n_tx, n_sig, st);
}
