// Colour smoothing for Hopper (sm_90a): N sequential 3x3 median passes over
// the two (C - G) difference planes in one launch.
//
// Replaces the TPU kernel tpu_darktable/kernels/color_smooth.py:color_smooth_diffs.
// Recurrence, with gc = max(g, 0):
//   d_1 = max(med9(d_0) + g, 0) - gc
//   d_k = max(med9(d_{k-1}) + gc, 0) - gc        (k >= 2)
// with a fresh zero fill outside the image before every pass.
//
// Design.  One block owns a TILE x TILE output tile of one plane
// (blockIdx.z).  It loads the tile plus an N-px halo of d and g into shared
// memory, runs the N passes there (each pass shrinks the valid region by
// one pixel and re-zeroes every position outside the image), and writes
// the tile once.  Bound on the card: the sorting network, 25 min/max pairs
// (+4 adds/max) a pixel, plane and pass, 324 ops a pixel at N = 3; HBM
// sees one read of d and g and one write of d, 20 bytes a pixel.
//
// min/max only, no rounding: the kernel is bit-exact against its plain
// version.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;

__device__ __forceinline__ void ce(float& a, float& b) {
  const float lo = fminf(a, b), hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

// The 25-compare-exchange network of ops/_stencil.py SORT9_NETWORK.
__device__ __forceinline__ float median9(float v[9]) {
  ce(v[0], v[3]); ce(v[1], v[7]); ce(v[2], v[5]); ce(v[4], v[8]);
  ce(v[0], v[7]); ce(v[2], v[4]); ce(v[3], v[8]); ce(v[5], v[6]);
  ce(v[0], v[2]); ce(v[1], v[3]); ce(v[4], v[5]); ce(v[7], v[8]);
  ce(v[1], v[4]); ce(v[3], v[6]); ce(v[5], v[7]);
  ce(v[0], v[1]); ce(v[2], v[4]); ce(v[3], v[5]); ce(v[6], v[8]);
  ce(v[2], v[3]); ce(v[4], v[5]); ce(v[6], v[7]);
  ce(v[1], v[2]); ce(v[3], v[4]); ce(v[5], v[6]);
  return v[4];
}

__global__ void __launch_bounds__(THREADS)
color_smooth_kernel(const float* __restrict__ diffs, const float* __restrict__ g,
                    float* __restrict__ out, int h, int w, int n_passes) {
  extern __shared__ float smem[];
  const int s = TILE + 2 * n_passes;
  float* cur = smem;
  float* nxt = smem + s * s;
  float* gr = smem + 2 * s * s;
  const size_t plane = (size_t)h * w;
  const float* d0 = diffs + blockIdx.z * plane;
  const int oy = blockIdx.y * TILE - n_passes;
  const int ox = blockIdx.x * TILE - n_passes;

  for (int k = threadIdx.x; k < s * s; k += blockDim.x) {
    const int gy = oy + k / s, gx = ox + k % s;
    const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const size_t o = (size_t)gy * w + gx;
    cur[k] = inside ? d0[o] : 0.0f;
    gr[k] = inside ? g[o] : 0.0f;
  }
  __syncthreads();

  for (int p = 1; p <= n_passes; ++p) {
    const int n = s - 2 * p;  // region [p, s - p) of the tile
    for (int k = threadIdx.x; k < n * n; k += blockDim.x) {
      const int i = p + k / n, j = p + k % n;
      float v[9];
      int t = 0;
      for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx) v[t++] = cur[(i + dy) * s + (j + dx)];
      const float med = median9(v);
      const float g_raw = gr[i * s + j];
      const float gc = fmaxf(g_raw, 0.0f);
      const float d_new = fmaxf(med + (p == 1 ? g_raw : gc), 0.0f) - gc;
      const int gy = oy + i, gx = ox + j;
      const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
      nxt[i * s + j] = inside ? d_new : 0.0f;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  float* o = out + blockIdx.z * plane;
  for (int k = threadIdx.x; k < TILE * TILE; k += blockDim.x) {
    const int i = n_passes + k / TILE, j = n_passes + k % TILE;
    const int gy = oy + i, gx = ox + j;
    if (gy < h && gx < w) o[(size_t)gy * w + gx] = cur[i * s + j];
  }
}

}  // namespace

extern "C" int color_smooth_launch(const float* diffs, const float* g, float* out,
                                   int h, int w, int n_passes, void* stream) {
  const int s = TILE + 2 * n_passes;
  const int smem = 3 * s * s * (int)sizeof(float);
  const int status = (int)cudaFuncSetAttribute(
      color_smooth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (status != 0) return status;
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE, 2);
  color_smooth_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      diffs, g, out, h, w, n_passes);
  return (int)cudaGetLastError();
}
