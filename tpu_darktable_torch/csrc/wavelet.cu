// A-trous B3 wavelet shrinkage for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_darktable/kernels/wavelet.py:wavelet_core.
// Per channel plane, for levels lvl = 0 .. levels-1 with step 2^lvl:
//   smooth   = columns(rows(current)), each a 5-tap B3 blur with taps
//              `step` apart and EDGE padding (coordinates clamped)
//   residual += soft(current - smooth, thr[c] * 0.5^lvl)
//   current  = smooth
// and out = current + residual.
//
// Design.  Level lvl reads 2 * 2^lvl px away, so levels [0, 4) together
// reach 2 * (2^4 - 1) = 30 px.  `cascade_kernel` runs those levels of one
// TILE_Y x TILE_X tile in shared memory: the tile plus a halo of the
// cascade's reach, loaded once with clamped coordinates.  Edge padding at
// every level is the same as clamping each read of that level's `current`
// to the image, so every tap reads its clamped global position inside the
// tile, and positions outside the image are never read.  The valid region
// shrinks by each level's reach; `current` is updated in place (a thread
// reads only its own position of it in the column pass).  Levels >= 4 reach
// 32 px and more each, too far for a shared tile: each runs as two plain
// passes through HBM (`rows_kernel`, `cols_kernel`), so every depth runs on
// the card.
//
// Bound on the card: one read and one write of each plane, 8 bytes a pixel
// and channel, against ~26 float ops a level (two 5-tap blurs, the
// subtraction, the shrink and the residual add): operations, ~100 a pixel
// at 4 levels.  The simple tiling recomputes the halo (the 92 x 124 region
// of a 32 x 64 tile at level 0, 5.6x), so in practice shared-memory traffic
// and that recompute bound it.
//
// Sums run in the plain version's order (kernels/wavelet.py) and the build
// uses --fmad=false, so the kernel matches its plain version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_Y = 32;
constexpr int TILE_X = 64;
constexpr int THREADS = 256;
constexpr int FUSED_LEVELS = 4;

__device__ __forceinline__ int clampi(long long v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : (int)v);
}

__device__ __forceinline__ float shrink(float d, float thr) {
  const float mag = fmaxf(fabsf(d) - thr, 0.0f);
  const float sgn = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
  return sgn * mag;
}

// Levels [0, n_lv) of one tile of plane blockIdx.z.  With `last` the tile
// of out gets current + residual; otherwise out gets the residual and
// cur_out the current plane, for the levels that follow.
__global__ void __launch_bounds__(THREADS)
cascade_kernel(const float* __restrict__ x, const float* __restrict__ thr,
               float* __restrict__ out, float* __restrict__ cur_out,
               int h, int w, int n_lv, int last) {
  extern __shared__ float smem[];
  const float B3[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f, 4.0f / 16.0f, 1.0f / 16.0f};
  const int m = 2 * ((1 << n_lv) - 1);
  const int sy = TILE_Y + 2 * m, sx = TILE_X + 2 * m;
  float* cur = smem;                // sy x sx
  float* tmp = cur + sy * sx;       // sy x sx: the row pass
  float* res = tmp + sy * sx;       // TILE_Y x TILE_X: the residual
  const int c = blockIdx.z;
  const size_t plane = (size_t)h * w;
  const float* xc = x + c * plane;
  const int oy = blockIdx.y * TILE_Y - m, ox = blockIdx.x * TILE_X - m;

  for (int k = threadIdx.x; k < sy * sx; k += blockDim.x) {
    const int gy = clampi(oy + k / sx, h - 1), gx = clampi(ox + k % sx, w - 1);
    cur[k] = xc[(size_t)gy * w + gx];
  }
  for (int k = threadIdx.x; k < TILE_Y * TILE_X; k += blockDim.x) res[k] = 0.0f;
  __syncthreads();

  int a = 0;  // `current` is valid on [a, sy - a) x [a, sx - a)
  float scale = 1.0f;
  for (int lvl = 0; lvl < n_lv; ++lvl) {
    const int step = 1 << lvl, r = 2 * step;
    const int ny = sy - 2 * (a + r);
    const int nx = sx - 2 * a;
    for (int k = threadIdx.x; k < ny * nx; k += blockDim.x) {
      const int i = a + r + k / nx, j = a + k % nx;
      const int gy = oy + i, gx = ox + j;
      if (gy < 0 || gy >= h || gx < 0 || gx >= w) continue;
      float acc = 0.0f;
      for (int t = 0; t < 5; ++t)
        acc = acc + B3[t] * cur[(clampi(gy + (long long)(t - 2) * step, h - 1) - oy) * sx + j];
      tmp[i * sx + j] = acc;
    }
    __syncthreads();
    const float th = thr[c] * scale;
    const int nx2 = sx - 2 * (a + r);
    for (int k = threadIdx.x; k < ny * nx2; k += blockDim.x) {
      const int i = a + r + k / nx2, j = a + r + k % nx2;
      const int gy = oy + i, gx = ox + j;
      if (gy < 0 || gy >= h || gx < 0 || gx >= w) continue;
      float acc = 0.0f;
      for (int t = 0; t < 5; ++t)
        acc = acc + B3[t] * tmp[i * sx + clampi(gx + (long long)(t - 2) * step, w - 1) - ox];
      const int oi = i - m, oj = j - m;
      if (oi >= 0 && oi < TILE_Y && oj >= 0 && oj < TILE_X)
        res[oi * TILE_X + oj] = res[oi * TILE_X + oj] + shrink(cur[i * sx + j] - acc, th);
      cur[i * sx + j] = acc;
    }
    __syncthreads();
    a += r;
    scale = scale * 0.5f;
  }

  for (int k = threadIdx.x; k < TILE_Y * TILE_X; k += blockDim.x) {
    const int oi = k / TILE_X, oj = k % TILE_X;
    const int gy = oy + m + oi, gx = ox + m + oj;
    if (gy >= h || gx >= w) continue;
    const size_t o = c * plane + (size_t)gy * w + gx;
    const float v = cur[(m + oi) * sx + m + oj];
    if (last) {
      out[o] = v + res[k];
    } else {
      out[o] = res[k];
      cur_out[o] = v;
    }
  }
}

// One deeper level, row pass: tmp = rows(cur).
__global__ void __launch_bounds__(THREADS)
rows_kernel(const float* __restrict__ cur, float* __restrict__ tmp, int n_c, int h, int w,
            int step) {
  const float B3[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f, 4.0f / 16.0f, 1.0f / 16.0f};
  const size_t plane = (size_t)h * w;
  const size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (size_t)n_c * plane) return;
  const size_t base = k - k % plane;
  const int y = (int)((k % plane) / w), xx = (int)(k % w);
  float acc = 0.0f;
  for (int t = 0; t < 5; ++t)
    acc = acc + B3[t] * cur[base + (size_t)clampi(y + (long long)(t - 2) * step, h - 1) * w + xx];
  tmp[k] = acc;
}

// One deeper level, column pass, shrink and residual; cur is updated in
// place (each thread reads only its own position of it).
__global__ void __launch_bounds__(THREADS)
cols_kernel(float* __restrict__ cur, const float* __restrict__ tmp, float* __restrict__ out,
            const float* __restrict__ thr, int n_c, int h, int w, int step, float scale,
            int last) {
  const float B3[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f, 4.0f / 16.0f, 1.0f / 16.0f};
  const size_t plane = (size_t)h * w;
  const size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (size_t)n_c * plane) return;
  const size_t row = k - k % w;
  const int xx = (int)(k % w);
  float acc = 0.0f;
  for (int t = 0; t < 5; ++t)
    acc = acc + B3[t] * tmp[row + clampi(xx + (long long)(t - 2) * step, w - 1)];
  const float res = out[k] + shrink(cur[k] - acc, thr[k / plane] * scale);
  if (last) {
    out[k] = acc + res;
  } else {
    out[k] = res;
    cur[k] = acc;
  }
}

}  // namespace

// x, out: (C, H, W) float32; thr: (C,) base thresholds.  cur and tmp are
// (C, H, W) scratch planes, used only when levels > 4 (else may be null).
extern "C" int wavelet_launch(const float* x, const float* thr, float* out, float* cur,
                              float* tmp, int n_c, int h, int w, int levels, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_f = levels < FUSED_LEVELS ? levels : FUSED_LEVELS;
  const int m = 2 * ((1 << n_f) - 1);
  const int smem = (2 * (TILE_Y + 2 * m) * (TILE_X + 2 * m) + TILE_Y * TILE_X) * (int)sizeof(float);
  cudaFuncSetAttribute(cascade_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((w + TILE_X - 1) / TILE_X, (h + TILE_Y - 1) / TILE_Y, n_c);
  cascade_kernel<<<grid, THREADS, smem, st>>>(x, thr, out, cur, h, w, n_f, levels <= FUSED_LEVELS);
  const size_t n = (size_t)n_c * h * w;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  float scale = 1.0f;
  for (int lvl = 0; lvl < n_f; ++lvl) scale = scale * 0.5f;
  for (int lvl = n_f; lvl < levels; ++lvl) {
    rows_kernel<<<blocks, THREADS, 0, st>>>(cur, tmp, n_c, h, w, 1 << lvl);
    cols_kernel<<<blocks, THREADS, 0, st>>>(cur, tmp, out, thr, n_c, h, w, 1 << lvl, scale,
                                            lvl == levels - 1);
    scale = scale * 0.5f;
  }
  return (int)cudaGetLastError();
}
