// Bilateral-grid blur for Hopper (sm_90a): gaussian x, gaussian y, then a
// z blur (derivative or gaussian) of a (gz, gy, gx) float32 grid in one
// launch, with zero fill outside the grid on every axis.
//
// Replaces the TPU kernel tpu_darktable/kernels/grid_blur.py:grid_blur_xyz.
//
// What bounds it on this card: one read and one write of the grid, 8 bytes
// a cell, against 9 + 9 operations for x and y and 7-9 for z (~25 a cell
// with --fmad=false): bytes, 0.020 ms for the (6, 1001, 1366) grid of
// sigma_s 3.  The first design moved no more bytes than that, but nothing
// overlapped inside a block (load, barrier, x, barrier, y into a 5-slab
// shared ring, barrier, z) and its 1376 blocks ran in uneven waves.
//
// Design.  One block owns a TY x TX column of the grid through all of z.
//  - A thread owns 4 x-adjacent cells in each of LY rows.  For every slab
//    it reads its LY + 4 staged rows as two float4 each, blurs x in
//    registers (the 2-row y halo's x blur is recomputed, 2x at LY = 4) and
//    accumulates y as the rows stream past.
//  - z lives in registers: five running sums a cell, for outputs q - 2 ..
//    q + 2 of slab q.  Slab q adds its term to each, output q - 2 is
//    complete and stored, and the sums shift.  No shared ring, no z barrier.
//  - Slabs are staged with cp.async into two buffers: slab q + 1 loads
//    while slab q is blurred, one barrier a slab.  Cells outside the grid
//    are staged as 0.  (A third buffer measured no faster on an H100.)
//  - 64 x 32 tiles: 704 blocks of 128 threads at (6, 1001, 1366).
//
// Each sum runs in the plain version's order (kernels/grid_blur.py: x, then
// y, then z; taps ascending from 0, starting from 0; zero weights skipped),
// and the build uses --fmad=false, so the kernel and the plain version
// agree bit for bit.  Slabs outside the grid add nothing where the plain
// version adds w * 0: the same value, up to the sign of a zero.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

constexpr int TXG = 16;          // threads in x (blockDim.x), 4 cells each
constexpr int TYG = 8;           // threads in y (blockDim.y)
constexpr int LY = 4;            // rows a thread
constexpr int TX = 4 * TXG;
constexpr int TY = LY * TYG;
constexpr int SX = TX + 4;       // a staged slab: the tile and a 2-cell halo
constexpr int SY = TY + 4;
constexpr int SLAB = SY * SX;
constexpr int THREADS = TXG * TYG;
constexpr int BLOCKS_PER_SM = 4;

// Slab q of src, tile and halo, into buf (cells outside the grid are 0), as
// one cp.async commit group.
__device__ __forceinline__ void stage(float* buf, const float* src, int q, int gy, int gx,
                                      int y0, int x0) {
  const float* s = src + (size_t)q * gy * gx;
  for (int k = threadIdx.y * TXG + threadIdx.x; k < SLAB; k += THREADS) {
    const int r = k / SX, c = k - r * SX;
    const int yy = y0 - 2 + r, xx = x0 - 2 + c;
    if (yy >= 0 && yy < gy && xx >= 0 && xx < gx)
      __pipeline_memcpy_async(buf + k, s + (size_t)yy * gx + xx, sizeof(float));
    else
      buf[k] = 0.0f;
  }
  __pipeline_commit();
}

template <bool ZGAUSS>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
grid_blur_kernel(const float* __restrict__ src, float* __restrict__ dst, int gz, int gy,
                 int gx) {
  extern __shared__ float smem[];   // two staged slabs
  const float G[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f, 4.0f / 16.0f, 1.0f / 16.0f};
  const float WZ[5] = {ZGAUSS ? 1.0f / 16.0f : -2.0f / 16.0f,
                       ZGAUSS ? 4.0f / 16.0f : -4.0f / 16.0f,
                       ZGAUSS ? 6.0f / 16.0f : 0.0f,
                       4.0f / 16.0f,
                       ZGAUSS ? 1.0f / 16.0f : 2.0f / 16.0f};
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int cx = 4 * threadIdx.x, ry = LY * threadIdx.y;   // in the tile
  const size_t slab = (size_t)gy * gx;

  // zs[j]: the running sum of output slab q - 2 + j while slab q is added.
  float zs[5][LY][4];
#pragma unroll
  for (int j = 0; j < 5; ++j)
#pragma unroll
    for (int i = 0; i < LY; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) zs[j][i][c] = 0.0f;

  stage(smem, src, 0, gy, gx, y0, x0);
  for (int q = 0; q < gz + 2; ++q) {
    if (q < gz) {
      __pipeline_wait_prior(0);
      __syncthreads();   // slab q staged; every thread is done with slab q - 1
      if (q + 1 < gz) stage(smem + ((q + 1) & 1) * SLAB, src, q + 1, gy, gx, y0, x0);
      const float* buf = smem + (q & 1) * SLAB;
      float ys[LY][4];
#pragma unroll
      for (int rr = 0; rr < LY + 4; ++rr) {
        const float* row = buf + (ry + rr) * SX + cx;
        const float4 a = *reinterpret_cast<const float4*>(row);
        const float4 b = *reinterpret_cast<const float4*>(row + 4);
        const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        float xb[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float acc = 0.0f;
#pragma unroll
          for (int t = 0; t < 5; ++t) acc = acc + G[t] * v[c + t];
          xb[c] = acc;
        }
        // staged row ry + rr is y tap rr - i of output row ry + i
#pragma unroll
        for (int i = 0; i < LY; ++i) {
          const int t = rr - i;
          if (t < 0 || t > 4) continue;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            ys[i][c] = (t == 0 ? 0.0f : ys[i][c]) + G[t] * xb[c];
        }
      }
      // slab q is z tap 4 - j of output q - 2 + j
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        if (WZ[4 - j] == 0.0f) continue;
#pragma unroll
        for (int i = 0; i < LY; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) zs[j][i][c] = zs[j][i][c] + WZ[4 - j] * ys[i][c];
      }
    }
    const int z = q - 2;
    if (z >= 0) {
      float* d = dst + (size_t)z * slab;
#pragma unroll
      for (int i = 0; i < LY; ++i) {
        const int yy = y0 + ry + i;
        if (yy >= gy) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int xx = x0 + cx + c;
          if (xx < gx) d[(size_t)yy * gx + xx] = zs[0][i][c];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < LY; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) zs[j][i][c] = zs[j + 1][i][c];
#pragma unroll
    for (int i = 0; i < LY; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) zs[4][i][c] = 0.0f;
  }
}

}  // namespace

// z_gauss: 0 for the derivative z taps, 1 for the gaussian ones.
extern "C" int grid_blur_launch(const float* src, float* dst, int gz, int gy, int gx,
                                int z_gauss, void* stream) {
  const dim3 grid((gx + TX - 1) / TX, (gy + TY - 1) / TY, 1);
  const dim3 block(TXG, TYG);
  const int smem = 2 * SLAB * (int)sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (z_gauss)
    grid_blur_kernel<true><<<grid, block, smem, s>>>(src, dst, gz, gy, gx);
  else
    grid_blur_kernel<false><<<grid, block, smem, s>>>(src, dst, gz, gy, gx);
  return (int)cudaGetLastError();
}
