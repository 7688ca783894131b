// Wiener tile core for Hopper (sm_90a): window and mean fold, real 2-D DFT,
// spectral Wiener gain, inverse DFT and synthesis window of every K x K
// tile, one tile a block, all of it in shared memory.
//
// Replaces the TPU kernel tpu_darktable/kernels/wiener_core.py:wiener_tile_core.
// For a tile t, with wf2 = outer(wf, wf) and wi2 = outer(wi, wi):
//   m     = sum(t) / K^2
//   x     = (t - m) * wf2
//   a, b  = sum x cos(ang), sum x sin(ang),  ang = 2 pi (u i + v j) / K
//   power = a^2 + b^2 + 1e-15;  gain = max(power - sig2, 0) / power
//   y     = irDFT2(a gain, b gain) * wi2 + m * (wf2 * wi2)
//
// Design.  The TPU kernel multiplies flattened tiles by dense (K^2, 2R+1)
// bases, O(K^4) a tile.  The 2-D transform is separable, so this kernel
// does K row transforms and K/2 + 1 column transforms each way, 24 K^2
// (K/2 + 1) float operations a tile as plain sums (0.42 M at K = 32, a tenth
// of the dense product), with the tile, both half spectra and the cos/sin
// table resident in shared memory.  One radix-2 step (outputs n and n + K/2
// share their even and odd sums) halves that.  It reads tiles in place from
// the coset slabs (G, n_ty K, n_tx K) and writes the reconstructed slabs in
// the same layout: one HBM read and one write, no transposed copy.
//
// Bound on the card: the function needs 8 bytes a pixel against ~74 float
// operations a pixel at K = 32 (a real 2-D FFT each way, 5 N log2 N for
// N = K^2, plus ~24 for mean, windows and gain), so bytes bound it.  This
// kernel runs ~228 a pixel (12 (K/2 + 1) + 24), three times what an FFT
// needs, and each comes with a shared-memory read or an index computation:
// a radix-2 transform all the way down is the next design.
//
// The cos/sin table and both windows come from the host (float64 there,
// rounded once to float32); every sum runs over its even or odd indices in
// ascending order, so the result does not depend on the block size, and the
// host emulation computes the same bits.

#include <cuda_runtime.h>

namespace {

// K is a template parameter so that the compiler unrolls the transforms'
// inner loops and folds the index arithmetic.
template <int K>
__global__ void wiener_core_kernel(const float* __restrict__ slabs, float* __restrict__ out,
                                   const float* __restrict__ sig2,
                                   const float* __restrict__ tables, int n_ty, int n_tx,
                                   int slabs_per_sig) {
  extern __shared__ float smem[];
  constexpr int k = K, u_n = k / 2 + 1, kp = k + 1, mask = k - 1;
  float* cs = smem;             // cos(2 pi n / K)
  float* sn = cs + k;           // sin(2 pi n / K)
  float* wf = sn + k;           // analysis window
  float* wi = wf + k;           // synthesis window
  float* rowsum = wi + k;
  float* x = rowsum + k;        // K x (K + 1): the tile, then the windowed tile
  float* p = x + k * kp;        // K x U: row transforms (cos), later the inverse column's
  float* q = p + k * u_n;       // K x U: row transforms (sin)
  float* a = q + k * u_n;       // K x U: spectrum, cos part
  float* b = a + k * u_n;       // K x U: spectrum, sin part

  const size_t row_len = (size_t)n_tx * k;
  const size_t base = ((size_t)blockIdx.z * n_ty * k + (size_t)blockIdx.y * k) * row_len
                      + (size_t)blockIdx.x * k;
  const float s2 = sig2[blockIdx.z / slabs_per_sig];
  const float inv_kk = 1.0f / (float)(k * k);

  for (int n = threadIdx.x; n < 4 * k; n += blockDim.x) smem[n] = tables[n];
  for (int n = threadIdx.x; n < k * k; n += blockDim.x) {
    const int i = n / k, j = n % k;
    x[i * kp + j] = slabs[base + (size_t)i * row_len + j];
  }
  __syncthreads();

  // tile mean: each row in order, then the rows in order (every thread
  // repeats the short second sum, so all hold the same m)
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    float acc = 0.0f;
    for (int j = 0; j < k; ++j) acc = acc + x[i * kp + j];
    rowsum[i] = acc;
  }
  __syncthreads();
  float m = 0.0f;
  for (int i = 0; i < k; ++i) m = m + rowsum[i];
  m = m * inv_kk;

  for (int n = threadIdx.x; n < k * k; n += blockDim.x) {
    const int i = n / k, j = n % k;
    x[i * kp + j] = (x[i * kp + j] - m) * (wf[i] * wf[j]);
  }
  __syncthreads();

  // Every transform below computes its outputs in pairs that share their
  // sums over the even and the odd indices (n and n + K/2 differ by the
  // sign of the odd terms), which halves the multiplications.

  // rows: p, q[i][v] = sum_j x[i][j] (cos, sin)(2 pi j v / K); v pairs with K/2 - v
  constexpr int v_n = k / 4 + 1;
  for (int n = threadIdx.x; n < k * v_n; n += blockDim.x) {
    const int i = n / v_n, v = n % v_n;
    float ec = 0.0f, es = 0.0f, oc = 0.0f, os = 0.0f;
    for (int j = 0; j < k; j += 2) {
      const float x0 = x[i * kp + j], x1 = x[i * kp + j + 1];
      const int t0 = (j * v) & mask, t1 = ((j + 1) * v) & mask;
      ec = ec + x0 * cs[t0];
      es = es + x0 * sn[t0];
      oc = oc + x1 * cs[t1];
      os = os + x1 * sn[t1];
    }
    p[i * u_n + v] = ec + oc;
    q[i * u_n + v] = es + os;
    if (v != k / 4) {
      p[i * u_n + k / 2 - v] = ec - oc;
      q[i * u_n + k / 2 - v] = os - es;
    }
  }
  __syncthreads();

  // columns: a = sum_i cos p - sin q, b = sum_i sin p + cos q, then the
  // gain; u pairs with u + K/2
  for (int n = threadIdx.x; n < (k / 2) * u_n; n += blockDim.x) {
    const int u = n / u_n, v = n % u_n;
    float ea = 0.0f, eb = 0.0f, oa = 0.0f, ob = 0.0f;
    for (int i = 0; i < k; i += 2) {
      const int t0 = (u * i) & mask, t1 = (u * (i + 1)) & mask;
      const float c0 = cs[t0], s0 = sn[t0], p0 = p[i * u_n + v], q0 = q[i * u_n + v];
      const float c1 = cs[t1], s1 = sn[t1], p1 = p[(i + 1) * u_n + v], q1 = q[(i + 1) * u_n + v];
      ea = ea + (c0 * p0 - s0 * q0);
      eb = eb + (s0 * p0 + c0 * q0);
      oa = oa + (c1 * p1 - s1 * q1);
      ob = ob + (s1 * p1 + c1 * q1);
    }
    for (int half = 0; half < 2; ++half) {
      const float av = half ? ea - oa : ea + oa, bv = half ? eb - ob : eb + ob;
      const float power = (av * av + bv * bv) + 1e-15f;
      const float gain = fmaxf(power - s2, 0.0f) / power;
      a[(u + half * (k / 2)) * u_n + v] = av * gain;
      b[(u + half * (k / 2)) * u_n + v] = bv * gain;
    }
  }
  __syncthreads();

  // inverse columns into p, q, scaled by the half spectrum's weights
  // (1 / K^2 for v = 0 and K / 2, else 2 / K^2: powers of two, exact);
  // i pairs with i + K/2
  for (int n = threadIdx.x; n < (k / 2) * u_n; n += blockDim.x) {
    const int i = n / u_n, v = n % u_n;
    float ec = 0.0f, ed = 0.0f, oc = 0.0f, od = 0.0f;
    for (int u = 0; u < k; u += 2) {
      const int t0 = (u * i) & mask, t1 = ((u + 1) * i) & mask;
      const float c0 = cs[t0], s0 = sn[t0], a0 = a[u * u_n + v], b0 = b[u * u_n + v];
      const float c1 = cs[t1], s1 = sn[t1], a1 = a[(u + 1) * u_n + v], b1 = b[(u + 1) * u_n + v];
      ec = ec + (c0 * a0 + s0 * b0);
      ed = ed + (c0 * b0 - s0 * a0);
      oc = oc + (c1 * a1 + s1 * b1);
      od = od + (c1 * b1 - s1 * a1);
    }
    const float rho = (v == 0 || v == k / 2) ? inv_kk : 2.0f * inv_kk;
    p[i * u_n + v] = (ec + oc) * rho;
    q[i * u_n + v] = (ed + od) * rho;
    p[(i + k / 2) * u_n + v] = (ec - oc) * rho;
    q[(i + k / 2) * u_n + v] = (ed - od) * rho;
  }
  __syncthreads();

  // inverse rows, synthesis window and the mean's map, straight to HBM;
  // j pairs with j + K/2
  for (int n = threadIdx.x; n < k * (k / 2); n += blockDim.x) {
    const int i = n / (k / 2), j = n % (k / 2);
    float e = 0.0f, o = 0.0f;
    for (int v = 0; v < u_n; v += 2) {
      const int t0 = (v * j) & mask;
      e = e + (cs[t0] * p[i * u_n + v] + sn[t0] * q[i * u_n + v]);
      if (v + 1 < u_n) {
        const int t1 = ((v + 1) * j) & mask;
        o = o + (cs[t1] * p[i * u_n + v + 1] + sn[t1] * q[i * u_n + v + 1]);
      }
    }
    for (int half = 0; half < 2; ++half) {
      const int jj = j + half * (k / 2);
      const float w2i = wi[i] * wi[jj];
      out[base + (size_t)i * row_len + jj] =
          (half ? e - o : e + o) * w2i + m * ((wf[i] * wf[jj]) * w2i);
    }
  }
}

}  // namespace

// slabs, out: (G, n_ty K, n_tx K) float32; sig2: (n_sig,) with n_sig
// dividing G (slab g uses sig2[g / (G / n_sig)]); tables: (4, K) float32
// rows cos, sin, wf, wi.  K is 16 or 32.
extern "C" int wiener_core_launch(const float* slabs, float* out, const float* sig2,
                                  const float* tables, int k, int g, int n_ty, int n_tx,
                                  int n_sig, void* stream) {
  if ((k != 16 && k != 32) || n_sig < 1 || g % n_sig || g > 65535 || n_ty > 65535)
    return (int)cudaErrorInvalidValue;
  const int u_n = k / 2 + 1;
  const int threads = k * (k / 4 + 1);   // 288 at K = 32, 80 at K = 16: the row pass's pairs
  const int smem = (5 * k + k * (k + 1) + 4 * k * u_n) * (int)sizeof(float);
  const dim3 grid(n_tx, n_ty, g);
  auto kernel = k == 32 ? wiener_core_kernel<32> : wiener_core_kernel<16>;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      slabs, out, sig2, tables, n_ty, n_tx, g / n_sig);
  return (int)cudaGetLastError();
}
