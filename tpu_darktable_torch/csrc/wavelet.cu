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
// Bound on the card: one read and one write of each plane, 8 bytes a pixel
// and channel, against ~25 float ops a level (two 5-tap blurs, the
// subtraction, the shrink and the residual add): operations, ~100 a pixel
// at 4 levels.  What is scarce is the halo.  Level lvl reads 2 * 2^lvl px
// away, so a tile that runs levels [0, n) in shared memory carries a halo of
// 2 (2^n - 1) px and recomputes it at every level: 6 px for two levels
// (1.4x a 64 x 64 tile at level 0), 30 px for four (3.7x, and 5.6x a 32 x 64
// tile).  A further pass of the planes through HBM costs a few bytes a pixel
// against that.
//
// Design.  The levels run in groups, chosen in `wavelet_launch`:
//  - levels [0, FUSED_LEVELS) in `cascade_kernel<NLV>`: one 64 x 64 tile of
//    one plane a block, the tile and the group's halo in shared memory.  The
//    block is 32 x 8 threads; a warp walks rows 8 apart and a lane columns 32
//    apart, anchored at the tile, so indices are additions and the thread
//    that finishes a tile pixel's column pass is the same at every level: it
//    keeps that pixel's residual in a register.  The halo ring left and right
//    of the tile takes one more step of the lanes, above and below one more
//    of the warps.  A block whose tile and halo lie inside the image (all but
//    the image's rim) reads its taps at fixed shared offsets; a rim block
//    clamps each tap's image coordinate (edge padding at every level is
//    clamping each read of that level's `current`) and never reads a
//    position outside the image.  The choice is uniform in the block.
//  - every later level with a step up to STRIP_MAX_STEP in `level_kernel`,
//    one launch a level: a block owns a 16 x 256 strip, takes the rows pass
//    of the strip and of 2 step columns either side straight from the
//    current plane (its five taps `step` rows apart come through L2: no halo
//    above or below) into shared memory, and runs the columns pass from
//    there.  16 bytes a pixel cross HBM: `current` read, the residual read
//    and written, the new `current` written to the other scratch plane.
//  - the levels past that as two passes through HBM, `rows_kernel` then
//    `cols_kernel`, on a 2-D grid a plane: 28 bytes a pixel, any step.
// `cur` / `tmp` carry `current` and `out` the residual from group to group.
// The grouping (three fused levels, strips up to step 64) is the one that
// was fastest on the card among those measured (PERF.md); any `levels` runs.
//
// Sums run in the plain version's order (kernels/wavelet.py) and the build
// uses --fmad=false, so the kernel matches its plain version bit for bit,
// whatever the grouping: a regrouping changes where intermediates live and
// no sum.  What still separates it from the bound: the planes cross HBM
// once more for each level past the fused group, the tile recomputes its
// 14-px halo (2.1x at level 0), and both tile passes read their five taps
// from shared memory for every output.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;            // output tile side of cascade_kernel
constexpr int WARPS = 16;           // a block is 32 x WARPS threads
constexpr int ROWS = TILE / WARPS;  // tile rows a thread owns, WARPS apart
constexpr int COLS = TILE / 32;     // tile columns a thread owns, 32 apart
constexpr int FUSED_LEVELS = 3;     // levels [0, FUSED_LEVELS) run in the tile
constexpr int PASS_X = 128, PASS_Y = 2;  // block of rows_kernel and cols_kernel
constexpr int STRIP_X = 256, STRIP_Y = 16;  // pixels a block of level_kernel owns
constexpr int STRIP_MAX_STEP = 64;  // level_kernel runs the steps up to this one

__host__ __device__ constexpr int reach(int n_lv) { return 2 * ((1 << n_lv) - 1); }  // of levels [0, n_lv)

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

__device__ __forceinline__ float shrink(float d, float thr) {
  const float mag = fmaxf(fabsf(d) - thr, 0.0f);
  const float sgn = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
  return sgn * mag;
}

// Column of step q of a lane, anchored at the tile (which starts at column M
// of the region): steps [0, COLS) are the lane's tile columns; step COLS is
// the ring of `ring` <= 16 columns each side, the right one on the low lanes
// and the left one on the high lanes.  False where the lane has no column.
template <int M>
__device__ __forceinline__ bool lane_column(int q, int ring, int& j) {
  const int lane = threadIdx.x;
  if (q < COLS) {
    j = M + lane + 32 * q;
    return true;
  }
  j = lane < 16 ? M + TILE + lane : M - 32 + lane;
  return lane < ring || lane >= 32 - ring;
}

// Level LVL of a tile that runs levels [0, NLV).  `current` (cur) is valid
// on [A, S - A) each way before and on [A + R, S - A - R) after; (oy, ox) is
// the image position of the region's corner.
template <int NLV, int LVL, bool INSIDE>
__device__ __forceinline__ void tile_level(float* cur, float* tmp, float (&res)[ROWS][COLS],
                                           float th, int oy, int ox, int h, int w) {
  constexpr int M = reach(NLV), S = TILE + 2 * M;
  constexpr int STEP = 1 << LVL, R = 2 * STEP;
  constexpr int A = reach(LVL), LO = A + R, HI = S - LO;
  constexpr int RING_Y = (M - LO + WARPS - 1) / WARPS;  // steps of the warps above and below
  static_assert(M - A <= 16, "the halo ring must fit half a warp each side");
  const float B3[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f, 4.0f / 16.0f, 1.0f / 16.0f};
  const int wy = threadIdx.y;

  // rows pass: tmp = rows(cur) on rows [LO, HI), columns [A, S - A)
#pragma unroll
  for (int p = -RING_Y; p < ROWS + RING_Y; ++p) {
    const int i = M + wy + WARPS * p;
    if (i < LO || i >= HI) continue;
#pragma unroll
    for (int q = 0; q < COLS + (M > A); ++q) {
      int j;
      if (!lane_column<M>(q, M - A, j)) continue;
      const int gy = oy + i;
      if (!INSIDE && (gy < 0 || gy >= h || ox + j < 0 || ox + j >= w)) continue;
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < 5; ++t) {
        const int it = INSIDE ? i + (t - 2) * STEP : clampi(gy + (t - 2) * STEP, h - 1) - oy;
        acc = acc + B3[t] * cur[it * S + j];
      }
      tmp[i * S + j] = acc;
    }
  }
  __syncthreads();

  // columns pass, shrink and residual on [LO, HI) each way; cur is updated in
  // place (a thread reads only its own position of it)
#pragma unroll
  for (int p = -RING_Y; p < ROWS + RING_Y; ++p) {
    const int i = M + wy + WARPS * p;
    if (i < LO || i >= HI) continue;
#pragma unroll
    for (int q = 0; q < COLS + (M > LO); ++q) {
      int j;
      if (!lane_column<M>(q, M - LO, j)) continue;
      const int gx = ox + j;
      if (!INSIDE && (oy + i < 0 || oy + i >= h || gx < 0 || gx >= w)) continue;
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < 5; ++t) {
        const int jt = INSIDE ? j + (t - 2) * STEP : clampi(gx + (t - 2) * STEP, w - 1) - ox;
        acc = acc + B3[t] * tmp[i * S + jt];
      }
      if (p >= 0 && p < ROWS && q < COLS) res[p][q] = res[p][q] + shrink(cur[i * S + j] - acc, th);
      cur[i * S + j] = acc;
    }
  }
  __syncthreads();
}

template <int NLV, int LVL, bool INSIDE>
__device__ __forceinline__ void tile_levels(float* cur, float* tmp, float (&res)[ROWS][COLS],
                                            float th, int oy, int ox, int h, int w) {
  if constexpr (LVL < NLV) {
    tile_level<NLV, LVL, INSIDE>(cur, tmp, res, th, oy, ox, h, w);
    tile_levels<NLV, LVL + 1, INSIDE>(cur, tmp, res, th * 0.5f, oy, ox, h, w);
  }
}

template <int NLV, bool INSIDE>
__device__ __forceinline__ void cascade_tile(float* cur, float* tmp, const float* __restrict__ xc,
                                             float th, float* __restrict__ out,
                                             float* __restrict__ cur_out, int oy, int ox, int h,
                                             int w, int last) {
  constexpr int M = reach(NLV), S = TILE + 2 * M;
  const int lane = threadIdx.x, wy = threadIdx.y;
  for (int i = wy; i < S; i += WARPS) {
    const float* row = xc + (size_t)(INSIDE ? oy + i : clampi(oy + i, h - 1)) * w;
    for (int j = lane; j < S; j += 32) cur[i * S + j] = row[INSIDE ? ox + j : clampi(ox + j, w - 1)];
  }
  __syncthreads();
  float res[ROWS][COLS];
#pragma unroll
  for (int p = 0; p < ROWS; ++p)
#pragma unroll
    for (int q = 0; q < COLS; ++q) res[p][q] = 0.0f;
  tile_levels<NLV, 0, INSIDE>(cur, tmp, res, th, oy, ox, h, w);
#pragma unroll
  for (int p = 0; p < ROWS; ++p) {
    const int i = M + wy + WARPS * p;
#pragma unroll
    for (int q = 0; q < COLS; ++q) {
      const int j = M + lane + 32 * q;
      if (!INSIDE && (oy + i >= h || ox + j >= w)) continue;
      const size_t o = (size_t)(oy + i) * w + ox + j;
      if (last) {
        out[o] = cur[i * S + j] + res[p][q];
      } else {
        out[o] = res[p][q];
        cur_out[o] = cur[i * S + j];
      }
    }
  }
}

// Levels [0, NLV) of one tile of plane blockIdx.z.  With `last` the tile of
// out gets current + residual; otherwise out gets the residual and cur_out
// the current plane, for the levels that follow.
template <int NLV>
__global__ void __launch_bounds__(32 * WARPS)
cascade_kernel(const float* __restrict__ x, const float* __restrict__ thr,
               float* __restrict__ out, float* __restrict__ cur_out, int h, int w, int last) {
  extern __shared__ float smem[];
  constexpr int M = reach(NLV), S = TILE + 2 * M;
  float* cur = smem;           // S x S
  float* tmp = cur + S * S;    // S x S: the rows pass
  const size_t at = (size_t)blockIdx.z * h * w;
  const int oy = blockIdx.y * TILE - M, ox = blockIdx.x * TILE - M;
  const float th = thr[blockIdx.z];
  float* cur_to = last ? nullptr : cur_out + at;
  // Uniform in the block: the tile and its halo lie inside the image.
  if (oy >= 0 && ox >= 0 && oy + S <= h && ox + S <= w)
    cascade_tile<NLV, true>(cur, tmp, x + at, th, out + at, cur_to, oy, ox, h, w, last);
  else
    cascade_tile<NLV, false>(cur, tmp, x + at, th, out + at, cur_to, oy, ox, h, w, last);
}

// One later level with a short step, whole: the rows pass of the block's
// STRIP_Y x STRIP_X pixels and of 2 step columns either side goes from `cur`
// (through L2) into shared memory, the columns pass reads it there, and
// `next` gets the new current plane: 16 bytes a pixel through HBM.
__global__ void __launch_bounds__(32 * STRIP_Y / 2)
level_kernel(const float* __restrict__ cur, float* __restrict__ next, float* __restrict__ out,
             const float* __restrict__ thr, int h, int w, int step, float scale, int last) {
  extern __shared__ float smem[];  // STRIP_Y x (STRIP_X + 4 step)
  const float B3[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f, 4.0f / 16.0f, 1.0f / 16.0f};
  const int sx = STRIP_X + 4 * step;
  const int oy = blockIdx.y * STRIP_Y, ox = blockIdx.x * STRIP_X;
  const size_t at = (size_t)blockIdx.z * h * w;
  for (int i = threadIdx.y; i < STRIP_Y && oy + i < h; i += STRIP_Y / 2) {
    for (int j = threadIdx.x; j < sx; j += 32) {
      const float* col = cur + at + clampi(ox - 2 * step + j, w - 1);
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < 5; ++t)
        acc = acc + B3[t] * col[(size_t)clampi(oy + i + (t - 2) * step, h - 1) * w];
      smem[i * sx + j] = acc;
    }
  }
  __syncthreads();
  const float th = thr[blockIdx.z] * scale;
  for (int i = threadIdx.y; i < STRIP_Y && oy + i < h; i += STRIP_Y / 2) {
    for (int j = threadIdx.x; j < STRIP_X && ox + j < w; j += 32) {
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < 5; ++t) acc = acc + B3[t] * smem[i * sx + j + t * step];
      const size_t k = at + (size_t)(oy + i) * w + ox + j;
      const float res = out[k] + shrink(cur[k] - acc, th);
      if (last) {
        out[k] = acc + res;
      } else {
        out[k] = res;
        next[k] = acc;
      }
    }
  }
}

// One later level with a long step, rows pass: tmp = rows(cur).  Grid (x, y, plane); `step`
// is at most h (a larger one clamps every tap to the same rows).
__global__ void __launch_bounds__(PASS_X * PASS_Y)
rows_kernel(const float* __restrict__ cur, float* __restrict__ tmp, int h, int w, int step) {
  const float B3[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f, 4.0f / 16.0f, 1.0f / 16.0f};
  const int xx = blockIdx.x * PASS_X + threadIdx.x, y = blockIdx.y * PASS_Y + threadIdx.y;
  if (xx >= w || y >= h) return;
  const size_t at = (size_t)blockIdx.z * h * w + xx;
  float acc = 0.0f;
#pragma unroll
  for (int t = 0; t < 5; ++t)
    acc = acc + B3[t] * cur[at + (size_t)clampi(y + (t - 2) * step, h - 1) * w];
  tmp[at + (size_t)y * w] = acc;
}

// One later level with a long step, columns pass, shrink and residual; cur is updated in
// place (each thread reads only its own position of it).  `step` is at most w.
__global__ void __launch_bounds__(PASS_X * PASS_Y)
cols_kernel(float* __restrict__ cur, const float* __restrict__ tmp, float* __restrict__ out,
            const float* __restrict__ thr, int h, int w, int step, float scale, int last) {
  const float B3[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f, 4.0f / 16.0f, 1.0f / 16.0f};
  const int xx = blockIdx.x * PASS_X + threadIdx.x, y = blockIdx.y * PASS_Y + threadIdx.y;
  if (xx >= w || y >= h) return;
  const size_t row = (size_t)blockIdx.z * h * w + (size_t)y * w;
  float acc = 0.0f;
#pragma unroll
  for (int t = 0; t < 5; ++t) acc = acc + B3[t] * tmp[row + clampi(xx + (t - 2) * step, w - 1)];
  const size_t k = row + xx;
  const float res = out[k] + shrink(cur[k] - acc, thr[blockIdx.z] * scale);
  if (last) {
    out[k] = acc + res;
  } else {
    out[k] = res;
    cur[k] = acc;
  }
}

template <int NLV>
int launch_cascade(const float* x, const float* thr, float* out, float* cur, int n_c, int h,
                   int w, int last, cudaStream_t st) {
  constexpr int S = TILE + 2 * reach(NLV);
  const int smem = 2 * S * S * (int)sizeof(float);
  const int status = (int)cudaFuncSetAttribute(
      cascade_kernel<NLV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (status != 0) return status;
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE, n_c);
  const dim3 block(32, WARPS, 1);
  cascade_kernel<NLV><<<grid, block, smem, st>>>(x, thr, out, cur, h, w, last);
  return (int)cudaGetLastError();
}

}  // namespace

// Levels the launcher runs in the shared-memory tile; deeper calls need the
// cur and tmp scratch planes.
extern "C" int wavelet_fused_levels() { return FUSED_LEVELS; }

// x, out: (C, H, W) float32; thr: (C,) base thresholds.  cur and tmp are
// (C, H, W) scratch planes, used only when levels > wavelet_fused_levels()
// (else may be null); which of the two holds what changes from level to level.
extern "C" int wavelet_launch(const float* x, const float* thr, float* out, float* cur,
                              float* tmp, int n_c, int h, int w, int levels, void* stream) {
  static_assert(FUSED_LEVELS == 3, "wavelet_launch instantiates cascade_kernel<0..3>");
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_f = levels < FUSED_LEVELS ? levels : FUSED_LEVELS;
  const int last = levels <= FUSED_LEVELS;
  int status;
  if (n_f == 0) status = launch_cascade<0>(x, thr, out, cur, n_c, h, w, last, st);
  else if (n_f == 1) status = launch_cascade<1>(x, thr, out, cur, n_c, h, w, last, st);
  else if (n_f == 2) status = launch_cascade<2>(x, thr, out, cur, n_c, h, w, last, st);
  else status = launch_cascade<3>(x, thr, out, cur, n_c, h, w, last, st);
  if (status != 0) return status;
  const dim3 strips((w + STRIP_X - 1) / STRIP_X, (h + STRIP_Y - 1) / STRIP_Y, n_c);
  const dim3 strip_block(32, STRIP_Y / 2, 1);
  const dim3 grid((w + PASS_X - 1) / PASS_X, (h + PASS_Y - 1) / PASS_Y, n_c);
  const dim3 block(PASS_X, PASS_Y, 1);
  float scale = 1.0f;
  for (int lvl = 0; lvl < n_f; ++lvl) scale = scale * 0.5f;
  for (int lvl = n_f; lvl < levels; ++lvl) {
    const int step = 1 << lvl, is_last = lvl == levels - 1;
    if (step <= STRIP_MAX_STEP) {
      const int smem = STRIP_Y * (STRIP_X + 4 * step) * (int)sizeof(float);
      level_kernel<<<strips, strip_block, smem, st>>>(cur, tmp, out, thr, h, w, step, scale, is_last);
      float* was = cur;  // the planes swap roles
      cur = tmp;
      tmp = was;
    } else {
      rows_kernel<<<grid, block, 0, st>>>(cur, tmp, h, w, step < h ? step : h);
      cols_kernel<<<grid, block, 0, st>>>(cur, tmp, out, thr, h, w, step < w ? step : w, scale,
                                          is_last);
    }
    scale = scale * 0.5f;
  }
  return (int)cudaGetLastError();
}
