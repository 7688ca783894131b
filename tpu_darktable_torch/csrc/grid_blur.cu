// Bilateral-grid blur for Hopper (sm_90a): gaussian x, gaussian y, then a
// z blur (derivative or gaussian) of a (gz, gy, gx) float32 grid in one
// launch, with zero fill outside the grid on every axis.
//
// Replaces the TPU kernel tpu_darktable/kernels/grid_blur.py:grid_blur_xyz.
//
// Design.  One block owns a TILE_Y x TILE_X column of the grid through all
// of z.  It walks z upward: for slab z it loads the tile plus a 2-cell halo
// into shared memory (zeros outside the grid), blurs x over the tile's rows
// and halo rows, blurs y into a ring that holds the last five slabs, and
// then emits output slab z - 2 from the five z taps in the ring.  Nothing is
// sized by gz, gy or gx, so every grid the bilateral paths make fits (the
// TPU kernel's VMEM rule does not apply here).
//
// Bound on the card: one read and one write of the grid, 8 bytes a cell,
// against 5 + 5 multiply-adds for x and y and 4-5 for z (~30 float ops a
// cell with --fmad=false): bytes, ~3.6 ops a byte below the card's ~10.  The
// halo rereads 1.27x of the grid through L1/L2 at TILE 32, not HBM.
//
// Each tap sums in the plain version's order (kernels/grid_blur.py: taps
// ascending from 0, zero weights skipped), and the build uses --fmad=false,
// so the kernel and the plain version agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_Y = 32;
constexpr int TILE_X = 32;
constexpr int SY = TILE_Y + 4;
constexpr int SX = TILE_X + 4;
constexpr int THREADS = 256;
constexpr int SMEM_FLOATS = SY * SX + SY * TILE_X + 5 * TILE_Y * TILE_X;

struct Taps {
  float w[5];
};

__global__ void __launch_bounds__(THREADS)
grid_blur_kernel(const float* __restrict__ src, float* __restrict__ dst,
                 int gz, int gy, int gx, Taps wz) {
  extern __shared__ float smem[];
  float* tile = smem;                     // SY x SX: slab zi and its halo
  float* bx = tile + SY * SX;             // SY x TILE_X: its x blur
  float* ring = bx + SY * TILE_X;         // 5 x TILE_Y x TILE_X: y blurs
  const float G[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f, 4.0f / 16.0f, 1.0f / 16.0f};
  const int y0 = blockIdx.y * TILE_Y, x0 = blockIdx.x * TILE_X;
  const size_t slab = (size_t)gy * gx;
  constexpr int T2 = TILE_Y * TILE_X;

  for (int zi = 0; zi < gz + 2; ++zi) {
    if (zi < gz) {
      const float* s = src + (size_t)zi * slab;
      for (int k = threadIdx.x; k < SY * SX; k += blockDim.x) {
        const int yy = y0 - 2 + k / SX, xx = x0 - 2 + k % SX;
        const bool inside = yy >= 0 && yy < gy && xx >= 0 && xx < gx;
        tile[k] = inside ? s[(size_t)yy * gx + xx] : 0.0f;
      }
      __syncthreads();
      for (int k = threadIdx.x; k < SY * TILE_X; k += blockDim.x) {
        const int r = k / TILE_X, c = k % TILE_X;
        float acc = 0.0f;
        for (int t = 0; t < 5; ++t) acc = acc + G[t] * tile[r * SX + c + t];
        bx[k] = acc;
      }
      __syncthreads();
      float* yb = ring + (zi % 5) * T2;
      for (int k = threadIdx.x; k < T2; k += blockDim.x) {
        const int r = k / TILE_X, c = k % TILE_X;
        float acc = 0.0f;
        for (int t = 0; t < 5; ++t) acc = acc + G[t] * bx[(r + t) * TILE_X + c];
        yb[k] = acc;
      }
      __syncthreads();
    }
    // Output slab z = zi - 2 reads y blurs z-2..z+2; all of them up to zi
    // are in the ring.  The ring slot written next (slab zi + 1) is read
    // here only as slab zi - 4, and two barriers separate the two.
    const int z = zi - 2;
    if (z < 0) continue;
    float* d = dst + (size_t)z * slab;
    for (int k = threadIdx.x; k < T2; k += blockDim.x) {
      const int yy = y0 + k / TILE_X, xx = x0 + k % TILE_X;
      if (yy >= gy || xx >= gx) continue;
      float acc = 0.0f;
      for (int t = 0; t < 5; ++t) {
        const int q = z + t - 2;
        if (wz.w[t] == 0.0f || q < 0 || q >= gz) continue;
        acc = acc + wz.w[t] * ring[(q % 5) * T2 + k];
      }
      d[(size_t)yy * gx + xx] = acc;
    }
  }
}

}  // namespace

// z_gauss: 0 for the derivative z taps, 1 for the gaussian ones.
extern "C" int grid_blur_launch(const float* src, float* dst, int gz, int gy, int gx,
                                int z_gauss, void* stream) {
  Taps wz;
  if (z_gauss) {
    const float g[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f, 4.0f / 16.0f, 1.0f / 16.0f};
    for (int t = 0; t < 5; ++t) wz.w[t] = g[t];
  } else {
    const float d[5] = {-2.0f / 16.0f, -4.0f / 16.0f, 0.0f, 4.0f / 16.0f, 2.0f / 16.0f};
    for (int t = 0; t < 5; ++t) wz.w[t] = d[t];
  }
  const dim3 grid((gx + TILE_X - 1) / TILE_X, (gy + TILE_Y - 1) / TILE_Y, 1);
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  grid_blur_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      src, dst, gz, gy, gx, wz);
  return (int)cudaGetLastError();
}
