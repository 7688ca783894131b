// Fused bilateral-grid detail term for Hopper (sm_90a): splat, blur x, y, z
// and slice in ONE launch, the grid never leaving shared memory.
//
// Replaces the TPU kernels tpu_darktable/kernels/bilateral_fused.py:bilateral_fused
// and, with the derivative z taps, tpu_darktable/kernels/bilateral_band.py:bilateral_band:
// there two generations of one band-resident fusion that differ in their
// lane layout, here one source behind both wrappers.
// For an integer sigma_s = s dividing the frame:
//   l_diff = slice(blur_z(blur_y(blur_x(splat(lum)))))
// with the z-tent splat of weight 1/s^2, 5-tap gaussian x and y, derivative
// or gaussian z, zero truncation at the grid's edge after every pass, and a
// trilinear slice at each pixel's own z.
//
// Design.  A block owns a T x T tile of output pixels.  Its slice reads the
// grid cells [y0/s, (y0+T-1)/s + 1] a side; the block builds those plus a
// 2-cell blur halo, for every z slab, in shared memory: a gather splat (each
// cell reads the 2s x 2s pixels that land on it, in a fixed order, no
// atomics; a pixel touches only the two slabs its tent reaches), then the three blurs ping-ponging between two shared buffers,
// re-zeroing by GLOBAL cell coordinate after each pass so the truncation is
// the whole grid's and not the tile's, then the slice.  Halo cells are
// recomputed by the neighbouring blocks; nothing is shared between blocks.
// Where it fits, the z coordinate of the tile's pixel window is staged in
// shared memory first (one IEEE division a pixel, -2 for pixels outside the
// image so that their tent is exactly 0: zero luminance would splat into
// z = 0); where s is too large for that the splat reads lum through L1.
//
// Bound on the card: 8 bytes a pixel (lum read once, l_diff written once)
// against ~94 float operations a pixel at s = 2, gz = 6: operations.  The
// tile's halo recompute ((T/s + 5)^2 against (T/s)^2 cells) comes on top,
// and the two grid buffers (66 KB at T = 64, s = 2, gz = 6) hold a
// multiprocessor to two or three blocks, so the block is 512 threads.
//
// The sums run in the order of the plain version
// (kernels/bilateral_band.py:bilateral_band_plain); with --fmad=false they
// round alike.  A chain of five launches over a grid in HBM (splat, three
// blurs, slice) computed the same bits and was slower at every sigma_s but
// 8, where the two tied.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;

struct Geo {
  int h, w, s, gz, gy, gx;
  int tile, ng, reg, staged;   // grid tile side (with halo), pixel window side
  float sigma_r, contrib;
  float wz[5];
};

__device__ __forceinline__ float z_coord(float lum, const Geo& g) {
  return fminf(fmaxf(lum / g.sigma_r, 0.0f), (float)(g.gz - 1));
}

// z coordinate of pixel (y, x); -2 outside the image (tent weight 0).
__device__ __forceinline__ float z_at(const float* __restrict__ lum, const float* zs, int y, int x,
                                      int ry0, int rx0, const Geo& g) {
  if (g.staged) return zs[(y - ry0) * g.reg + (x - rx0)];
  if (y < 0 || y >= g.h || x < 0 || x >= g.w) return -2.0f;
  return z_coord(lum[(size_t)y * g.w + x], g);
}

// One pixel's share of the x splat of its row, into the row sums xrow[z]
// (stride zstride) of one cell: the tent max(0, 1 - |g - z|) is nonzero for
// z = floor(g) and floor(g) + 1 only, and the skipped slabs would add an
// exact 0, so the sums equal the slab-by-slab ones bit for bit.
__device__ __forceinline__ void splat_pixel(float gzv, float wx, float* xrow, int zstride,
                                            int& lo, int& hi, const Geo& g) {
  if (gzv < 0.0f) return;   // outside the image
  const int z0 = (int)gzv;
  for (int z = z0; z <= z0 + 1 && z < g.gz; ++z) {
    const float t = fmaxf(0.0f, 1.0f - fabsf(gzv - (float)z));
    xrow[z * zstride] = xrow[z * zstride] + (t * g.contrib) * wx;
  }
  lo = min(lo, z0);
  hi = max(hi, min(z0 + 1, g.gz - 1));
}

// x splat of pixel row r at grid column gj, folded into the cell's slabs
// with the row's y weight wy: for each phase m, the (1 - m/s) term of cell
// p/s, then the m/s term of cell p/s + 1.  wt holds the phase weights,
// 1 - m/s at [m] and m/s at [s + m].  xrow is zero on entry and on return.
__device__ void splat_row(const float* __restrict__ lum, const float* zs, const float* wt, int r,
                          int gj, float wy, float* cell, float* xrow, int zstride, int ry0,
                          int rx0, const Geo& g) {
  if (r < 0 || r >= g.h) return;
  int lo = g.gz, hi = -1;
  for (int m = 0; m < g.s; ++m) {
    splat_pixel(z_at(lum, zs, r, gj * g.s + m, ry0, rx0, g), wt[m], xrow, zstride, lo, hi, g);
    if (m > 0)
      splat_pixel(z_at(lum, zs, r, (gj - 1) * g.s + m, ry0, rx0, g), wt[g.s + m], xrow, zstride,
                  lo, hi, g);
  }
  for (int z = lo; z <= hi; ++z) {
    cell[z * zstride] = cell[z * zstride] + xrow[z * zstride] * wy;
    xrow[z * zstride] = 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
bilateral_fused_kernel(const float* __restrict__ lum, float* __restrict__ l_diff, Geo g) {
  extern __shared__ float smem[];
  const int ng = g.ng, cells = g.gz * ng * ng;
  float* ga = smem;             // gz x ng x ng
  float* gb = ga + cells;       // gz x ng x ng
  float* wt = gb + cells;       // 2 s: the phase weights 1 - m/s, then m/s
  float* zs = wt + 2 * g.s;     // reg x reg, only where staged
  const int y0 = blockIdx.y * g.tile, x0 = blockIdx.x * g.tile;
  const int oy = y0 / g.s - 2, ox = x0 / g.s - 2;       // global cell of the tile's (0, 0)
  const int ry0 = (oy - 1) * g.s, rx0 = (ox - 1) * g.s; // global pixel of the window's (0, 0)
  const float G[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f, 4.0f / 16.0f, 1.0f / 16.0f};

  // float64 then rounded once, as the plain version's Python scalars are
  for (int m = threadIdx.x; m < g.s; m += blockDim.x) {
    wt[m] = (float)(1.0 - (double)m / g.s);
    wt[g.s + m] = (float)((double)m / g.s);
  }
  if (g.staged) {
    for (int k = threadIdx.x; k < g.reg * g.reg; k += blockDim.x) {
      const int y = ry0 + k / g.reg, x = rx0 + k % g.reg;
      const bool inside = y >= 0 && y < g.h && x >= 0 && x < g.w;
      zs[k] = inside ? z_coord(lum[(size_t)y * g.w + x], g) : -2.0f;
    }
  }
  __syncthreads();

  // splat -> ga, one work item a cell column (i, j) through all z, with
  // gb's column as its row sums; cells outside the true grid stay zero
  for (int k = threadIdx.x; k < ng * ng; k += blockDim.x) {
    const int j = k % ng, i = k / ng;
    const int gi = oy + i, gj = ox + j;
    float* cell = ga + i * ng + j;
    float* xrow = gb + i * ng + j;
    for (int z = 0; z < g.gz; ++z) cell[z * ng * ng] = xrow[z * ng * ng] = 0.0f;
    if (gi < 0 || gi >= g.gy || gj < 0 || gj >= g.gx) continue;
    for (int m = 0; m < g.s; ++m) {
      splat_row(lum, zs, wt, gi * g.s + m, gj, wt[m], cell, xrow, ng * ng, ry0, rx0, g);
      if (m > 0)
        splat_row(lum, zs, wt, (gi - 1) * g.s + m, gj, wt[g.s + m], cell, xrow, ng * ng, ry0, rx0,
                  g);
    }
  }
  __syncthreads();

  // blur x: ga -> gb, columns [2, ng - 2) of every row
  const int ni = ng - 4;
  for (int k = threadIdx.x; k < g.gz * ng * ni; k += blockDim.x) {
    const int j = 2 + k % ni, i = (k / ni) % ng, z = k / (ni * ng);
    const int gi = oy + i, gj = ox + j;
    const float* src = ga + (z * ng + i) * ng + j;
    float acc = 0.0f;
    if (gi >= 0 && gi < g.gy && gj >= 0 && gj < g.gx)
      for (int t = 0; t < 5; ++t) acc = acc + G[t] * src[t - 2];
    gb[(z * ng + i) * ng + j] = acc;
  }
  __syncthreads();

  // blur y: gb -> ga, the inner [2, ng - 2)^2
  for (int k = threadIdx.x; k < g.gz * ni * ni; k += blockDim.x) {
    const int j = 2 + k % ni, i = 2 + (k / ni) % ni, z = k / (ni * ni);
    const int gi = oy + i, gj = ox + j;
    const float* src = gb + (z * ng + i) * ng + j;
    float acc = 0.0f;
    if (gi >= 0 && gi < g.gy && gj >= 0 && gj < g.gx)
      for (int t = 0; t < 5; ++t) acc = acc + G[t] * src[(t - 2) * ng];
    ga[(z * ng + i) * ng + j] = acc;
  }
  __syncthreads();

  // blur z: ga -> gb, the inner cells, taps outside [0, gz) dropped
  for (int k = threadIdx.x; k < g.gz * ni * ni; k += blockDim.x) {
    const int j = 2 + k % ni, i = 2 + (k / ni) % ni, z = k / (ni * ni);
    float acc = 0.0f;
    for (int t = 0; t < 5; ++t) {
      const int zz = z + t - 2;
      if (g.wz[t] == 0.0f || zz < 0 || zz >= g.gz) continue;
      acc = acc + g.wz[t] * ga[(zz * ng + i) * ng + j];
    }
    gb[(z * ng + i) * ng + j] = acc;
  }
  __syncthreads();

  // slice
  for (int k = threadIdx.x; k < g.tile * g.tile; k += blockDim.x) {
    const int y = y0 + k / g.tile, x = x0 + k % g.tile;
    if (y >= g.h || x >= g.w) continue;
    const float gzv = z_at(lum, zs, y, x, ry0, rx0, g);
    const int ib = min((int)gzv, g.gz - 2);
    const float fr = gzv - (float)ib;
    const int rr = y / g.s - oy, cc = x / g.s - ox;
    const float fy = (float)(y % g.s) / (float)g.s;
    const float fx = (float)(x % g.s) / (float)g.s;
    float acc = 0.0f;
    for (int z = ib; z <= ib + 1; ++z) {
      const float* r0 = gb + (z * ng + rr) * ng;
      const float* r1 = r0 + ng;
      const float c0 = r0[cc] * (1.0f - fy) + r1[cc] * fy;
      const float c1 = r0[cc + 1] * (1.0f - fy) + r1[cc + 1] * fy;
      const float val = c0 * (1.0f - fx) + c1 * fx;
      const float wz = z == ib ? 1.0f - fr : fr;
      acc = acc + wz * val;
    }
    l_diff[(size_t)y * g.w + x] = acc;
  }
}

// Grid cells a side that a tile's slice can touch.
int cells_of(int tile, int s) { return tile % s == 0 ? tile / s + 1 : (tile - 1) / s + 3; }

}  // namespace

// lum, l_diff: (H, W) float32; H and W divide by s.  z_gauss: 0 for the
// derivative z taps, 1 for the gaussian ones.  The tile is the largest of
// 64, 32, 16, 8 whose two grid buffers, phase weights and staged pixel
// window fit a block's shared memory; failing that, the largest whose grid buffers fit, unstaged.
extern "C" int bilateral_fused_launch(const float* lum, float* l_diff, int h, int w, int s,
                                      int gz, float sigma_r, int z_gauss, void* stream) {
  if (s < 1 || h % s || w % s || gz < 2) return (int)cudaErrorInvalidValue;
  Geo g;
  g.h = h; g.w = w; g.s = s; g.gz = gz;
  g.gy = h / s + 1; g.gx = w / s + 1;
  g.sigma_r = sigma_r;
  g.contrib = (float)(1.0 / ((double)s * s));
  const float gauss[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f, 4.0f / 16.0f, 1.0f / 16.0f};
  const float deriv[5] = {-2.0f / 16.0f, -4.0f / 16.0f, 0.0f, 4.0f / 16.0f, 2.0f / 16.0f};
  for (int t = 0; t < 5; ++t) g.wz[t] = z_gauss ? gauss[t] : deriv[t];

  const size_t max_floats = 227 * 1024 / sizeof(float);
  size_t floats = 0;
  g.tile = 0;
  for (int staged = 1; staged >= 0 && g.tile == 0; --staged) {
    for (int tile = 64; tile >= 8; tile /= 2) {
      const size_t ng = cells_of(tile, s) + 4, reg = (ng + 1) * s;
      const size_t need = 2 * (size_t)gz * ng * ng + 2 * (size_t)s + (staged ? reg * reg : 0);
      if (need <= max_floats) {
        g.tile = tile; g.ng = (int)ng; g.reg = (int)reg; g.staged = staged;
        floats = need;
        break;
      }
    }
  }
  if (g.tile == 0) return (int)cudaErrorInvalidValue;
  const int smem = (int)(floats * sizeof(float));
  const int status = (int)cudaFuncSetAttribute(
      bilateral_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (status != 0) return status;
  const dim3 grid((w + g.tile - 1) / g.tile, (h + g.tile - 1) / g.tile, 1);
  bilateral_fused_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      lum, l_diff, g);
  return (int)cudaGetLastError();
}
