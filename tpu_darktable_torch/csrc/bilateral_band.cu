// Bilateral-grid detail term for Hopper (sm_90a), integer sigma_s fast path.
//
// Replaces the TPU kernel tpu_darktable/kernels/bilateral_band.py:bilateral_band
// (+ riffle_phases): l_diff = slice(blur_z'(blur_y(blur_x(splat(lum))))),
// written at (H, W) directly, so no column-phase riffle is needed.
//
// Design: a chain of five short launches over a (gz, gy, gx) grid in HBM,
// gy = H/s + 1, gx = W/s + 1.
//   1. splat in gather form: one thread per grid cell reads the 2s x 2s
//      pixel window that lands on it (tent weights along x and y, z tent
//      from the pixel's luminance).  No atomics, so the sum order, and the
//      result, is fixed.
//   2. 5-tap blur along x, then y (gaussian), then z (derivative), zero
//      truncation at every edge; one launch per axis.
//   3. trilinear slice: one thread per pixel.
// Bound on the card: the function must read lum once and write l_diff
// once (8 bytes a pixel) and do ~94 float ops a pixel at s=2, gz=6, so its
// floor is the arithmetic; this chain adds the grid's HBM round trips on
// top, gz/s^2 * 4 * 8 bytes a pixel, which is what bounds it in practice.
//
// The sums run in the order of the plain version (kernels/bilateral_band.py)
// and the build uses --fmad=false, so the two round alike; the plain version
// on the card differs by ~1e-7 only because PyTorch's CUDA division of a
// tensor by a scalar multiplies by the reciprocal.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

struct Geo {
  int h, w, s, gz, gy, gx;
  float sigma_r, contrib;
};

__device__ __forceinline__ float z_coord(float lum, const Geo& g) {
  return fminf(fmaxf(lum / g.sigma_r, 0.0f), (float)(g.gz - 1));
}

// x splat of pixel row r at grid column j, terms in the plain version's
// order: for each phase m, the (1 - m/s) term into cell p/s, then the m/s
// term into cell p/s + 1.
__device__ float x_splat(const float* __restrict__ lum, int r, int j, int z, const Geo& g) {
  float acc = 0.0f;
  const int wg = g.w / g.s;
  for (int m = 0; m < g.s; ++m) {
    const float wa = (float)(1.0 - (double)m / g.s);
    const float wb = (float)((double)m / g.s);
    if (j < wg) {
      const float wz = fmaxf(0.0f, 1.0f - fabsf(z_coord(lum[(size_t)r * g.w + j * g.s + m], g) - (float)z));
      acc = acc + (wz * g.contrib) * wa;
    }
    if (m > 0 && j >= 1) {
      const float wz = fmaxf(0.0f, 1.0f - fabsf(z_coord(lum[(size_t)r * g.w + (j - 1) * g.s + m], g) - (float)z));
      acc = acc + (wz * g.contrib) * wb;
    }
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS)
splat_kernel(const float* __restrict__ lum, float* __restrict__ grid, Geo g) {
  const size_t n = (size_t)g.gz * g.gy * g.gx;
  const size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int j = k % g.gx;
  const int i = (k / g.gx) % g.gy;
  const int z = k / ((size_t)g.gx * g.gy);
  const int hg = g.h / g.s;
  float acc = 0.0f;
  for (int m = 0; m < g.s; ++m) {
    const float wa = (float)(1.0 - (double)m / g.s);
    const float wb = (float)((double)m / g.s);
    if (i < hg) acc = acc + x_splat(lum, i * g.s + m, j, z, g) * wa;
    if (m > 0 && i >= 1) acc = acc + x_splat(lum, (i - 1) * g.s + m, j, z, g) * wb;
  }
  grid[k] = acc;
}

// 5-tap correlation along one axis (0 = z, 1 = y, 2 = x), zero outside.
__global__ void __launch_bounds__(THREADS)
blur5_kernel(const float* __restrict__ src, float* __restrict__ dst, Geo g, int axis,
             float w0, float w1, float w2, float w3, float w4) {
  const size_t n = (size_t)g.gz * g.gy * g.gx;
  const size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int j = k % g.gx;
  const int i = (k / g.gx) % g.gy;
  const int z = k / ((size_t)g.gx * g.gy);
  const int pos = axis == 0 ? z : (axis == 1 ? i : j);
  const int len = axis == 0 ? g.gz : (axis == 1 ? g.gy : g.gx);
  const long stride = axis == 0 ? (long)g.gx * g.gy : (axis == 1 ? g.gx : 1);
  const float wt[5] = {w0, w1, w2, w3, w4};
  float acc = 0.0f;
  for (int t = 0; t < 5; ++t) {
    const int q = pos + t - 2;
    if (wt[t] == 0.0f || q < 0 || q >= len) continue;
    acc = acc + wt[t] * src[(long)k + (long)(t - 2) * stride];
  }
  dst[k] = acc;
}

__global__ void __launch_bounds__(THREADS)
slice_kernel(const float* __restrict__ lum, const float* __restrict__ grid,
             float* __restrict__ l_diff, Geo g) {
  const size_t n = (size_t)g.h * g.w;
  const size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int y = k / g.w, x = k % g.w;
  const float gzv = z_coord(lum[k], g);
  const int ib = min((int)gzv, g.gz - 2);
  const float fr = gzv - (float)ib;
  const int rr = y / g.s, cc = x / g.s;
  const float fy = (float)(y % g.s) / (float)g.s;
  const float fx = (float)(x % g.s) / (float)g.s;
  float acc = 0.0f;
  for (int z = ib; z <= ib + 1; ++z) {
    const float* slab = grid + (size_t)z * g.gy * g.gx;
    const float* r0 = slab + (size_t)rr * g.gx;
    const float* r1 = r0 + g.gx;
    const float c0 = r0[cc] * (1.0f - fy) + r1[cc] * fy;
    const float c1 = r0[cc + 1] * (1.0f - fy) + r1[cc + 1] * fy;
    const float val = c0 * (1.0f - fx) + c1 * fx;
    const float wz = z == ib ? 1.0f - fr : fr;
    acc = acc + wz * val;
  }
  l_diff[k] = acc;
}

unsigned blocks(size_t n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

// grid_a and grid_b are (gz, H/s + 1, W/s + 1) float32 scratch buffers.
extern "C" int bilateral_band_launch(const float* lum, float* l_diff, float* grid_a,
                                     float* grid_b, int h, int w, int s, int gz,
                                     float sigma_r, void* stream) {
  Geo g;
  g.h = h; g.w = w; g.s = s; g.gz = gz;
  g.gy = h / s + 1; g.gx = w / s + 1;
  g.sigma_r = sigma_r;
  g.contrib = (float)(1.0 / ((double)s * s));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n_grid = (size_t)gz * g.gy * g.gx;
  const float G0 = 1.0f / 16.0f, G1 = 4.0f / 16.0f, G2 = 6.0f / 16.0f;
  splat_kernel<<<blocks(n_grid), THREADS, 0, st>>>(lum, grid_a, g);
  blur5_kernel<<<blocks(n_grid), THREADS, 0, st>>>(grid_a, grid_b, g, 2, G0, G1, G2, G1, G0);
  blur5_kernel<<<blocks(n_grid), THREADS, 0, st>>>(grid_b, grid_a, g, 1, G0, G1, G2, G1, G0);
  blur5_kernel<<<blocks(n_grid), THREADS, 0, st>>>(grid_a, grid_b, g, 0,
      -2.0f / 16.0f, -4.0f / 16.0f, 0.0f, 4.0f / 16.0f, 2.0f / 16.0f);
  slice_kernel<<<blocks((size_t)h * w), THREADS, 0, st>>>(lum, grid_b, l_diff, g);
  return (int)cudaGetLastError();
}
