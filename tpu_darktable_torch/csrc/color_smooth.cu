// Colour smoothing for Hopper (sm_90a): N sequential 3x3 median passes over
// the two (C - G) difference planes in one launch.
//
// Replaces the TPU kernel tpu_darktable/kernels/color_smooth.py:color_smooth_diffs.
// Recurrence, with gc = max(g, 0):
//   d_1 = max(med9(d_0) + g, 0) - gc
//   d_k = max(med9(d_{k-1}) + gc, 0) - gc        (k >= 2)
// with a fresh zero fill outside the image before every pass.
//
// What bounds it on this card.  The function reads the two planes and g
// once and writes the two planes (20 bytes a pixel, 0.073 ms at 12 MP).  A
// median of 3x3 that shares work with its neighbours costs ~21 operations a
// pixel, plane and pass (below), 126 at N = 3: 0.046 ms at 33.5 T/s.  So
// bytes bind the function.  The kernel is held by its min/max, which run
// at half the float rate: on an H100 at 4096x3000 a pass of both planes
// costs 0.049 ms (~41 min/max lanes a clock an SM, where half the float
// rate is 64), and staging, the store and the barriers 0.055 ms (0.201 ms
// at N = 3).
//
// Design.
//  - The median is a selection, not a sort: with each 3-tap column sorted
//    (lo <= mid <= hi), med9 = med3(max of the three lo, med3 of the three
//    mid, min of the three hi).  A thread owns a run of R = 4 horizontally
//    adjacent outputs and takes two rows at a time: the two rows' columns
//    share their middle pair (sorted once: 5 min/max a column and row, not
//    6), and adjacent outputs share the pairs they have in common: ~17.5
//    min/max an output where the 25-compare-exchange network took 50.  A
//    selection returns the value the network returns for every input
//    without NaN, so the kernel equals its plain version bit for bit except
//    that -0.0 and +0.0 may trade places (they compare equal, and so do the
//    checks).
//  - A thread walks down a strip of rows keeping the rows of its R + 2
//    columns in registers: one row (a float4 and two scalars) is read from
//    shared memory an output row.
//  - 2-D thread layout (32 x 8), so no index divides by a run-time value.
//    (On an H100, R = 8, 16-row or 128- and 512-thread blocks were slower.)
//    Every pass computes the same 128 columns (32 runs of R), a superset of
//    its valid region; the tile is 130 - 2N columns wide (124 at N = 3) and
//    TH rows high, staged with its N-px halo.  Columns outside a pass's
//    valid region hold values no valid output reads.
//  - One block owns the tile in both planes: g is staged once (20 bytes a
//    pixel from HBM, not 24), the planes run one after the other through
//    two shared buffers, and plane 1 is staged into the buffer that plane
//    0's last pass does not read, while that pass runs.  Staging is cp.async
//    (every copy of a thread in flight at once; the first design's loads
//    waited one by one).  The last pass writes to global memory.
//  - The zero fill renewed before every pass needs no code: a position
//    outside the image has at least six of its nine taps outside, so its
//    median is 0, and g is staged as 0 there, so its new value is
//    max(0 + 0, 0) - 0 = 0.  Staging zeros outside the image once is enough.
//
// min/max and IEEE adds only (the build uses --fmad=false): the kernel
// rounds exactly like its plain version.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

constexpr int R = 4;               // outputs a run (a multiple of 4)
constexpr int CW = 128;            // columns every pass computes
constexpr int LANES = CW / R;      // blockDim.x: runs a row
constexpr int THREADS = 256;
constexpr int ROWS = THREADS / LANES;   // blockDim.y: row strips a pass
constexpr int SX = CW + 2;         // staged columns
constexpr int PITCH = CW + 8;      // staged column c sits at c + 3: runs are float4-aligned
constexpr int TH = 32;             // output rows a tile

__device__ __forceinline__ float med3(float a, float b, float c) {
  return fmaxf(fminf(a, b), fminf(fmaxf(a, b), c));
}

// The R + 2 values of row r that the run at staged column c0 reads.
__device__ __forceinline__ void load_row(const float* buf, int r, int c0, float v[R + 2]) {
  const float* row = buf + r * PITCH + c0 + 3;
  v[0] = row[-1];
#pragma unroll
  for (int q = 0; q < R; q += 4) {
    const float4 m = *reinterpret_cast<const float4*>(row + q);
    v[q + 1] = m.x;
    v[q + 2] = m.y;
    v[q + 3] = m.z;
    v[q + 4] = m.w;
  }
  v[R + 1] = row[R];
}

// The R medians of a row from its R + 2 sorted columns (lo <= mid <= hi):
// outputs c and c + 1 read columns c..c+2 and c+1..c+3 and share c+1, c+2.
__device__ __forceinline__ void medians(const float lo[R + 2], const float mid[R + 2],
                                        const float hi[R + 2], float med[R]) {
#pragma unroll
  for (int c = 0; c < R; c += 2) {
    const float lo12 = fmaxf(lo[c + 1], lo[c + 2]);
    const float hi12 = fminf(hi[c + 1], hi[c + 2]);
    const float mn12 = fminf(mid[c + 1], mid[c + 2]);
    const float mx12 = fmaxf(mid[c + 1], mid[c + 2]);
    med[c] = med3(fmaxf(lo[c], lo12), fmaxf(mn12, fminf(mx12, mid[c])), fminf(hi[c], hi12));
    med[c + 1] = med3(fmaxf(lo12, lo[c + 3]), fmaxf(mn12, fminf(mx12, mid[c + 3])),
                      fminf(hi12, hi[c + 3]));
  }
}

// Column k of a row from its middle pair sorted (pmn <= pmx) and its third tap x.
__device__ __forceinline__ void sort_col(float pmn, float pmx, float x, float& lo, float& mid,
                                         float& hi) {
  lo = fminf(pmn, x);
  hi = fmaxf(pmx, x);
  mid = fmaxf(pmn, fminf(pmx, x));
}

// Pass p (1..n) over rows [p, sy - p), reading src.  Writes dst, or, on the
// last pass (dst == nullptr), the tile's outputs to out.  Rows go in pairs:
// rows r and r + 1 share taps r and r + 1 of every column, sorted once.
__device__ void smooth_pass(const float* src, float* dst, const float* gs, int p, int n, int sy,
                            int oy, int ox, int h, int w, float* out) {
  const int nrows = sy - 2 * p;
  const int len = (nrows + ROWS - 1) / ROWS;
  const int r0 = p + threadIdx.y * len;
  const int r1 = min(r0 + len, sy - p);
  const int c0 = 1 + R * threadIdx.x;
  if (r0 >= r1) return;

  // The new values of row r from its medians; into dst or, last, into out.
  auto emit = [&](int r, const float med[R]) {
    const float* grow = gs + r * PITCH + c0 + 3;
    float d[R];
#pragma unroll
    for (int q = 0; q < R; q += 4) {
      const float4 g4 = *reinterpret_cast<const float4*>(grow + q);
      const float graw[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float gc = fmaxf(graw[c], 0.0f);
        d[q + c] = fmaxf(med[q + c] + (p == 1 ? graw[c] : gc), 0.0f) - gc;
      }
    }
    if (dst != nullptr) {
#pragma unroll
      for (int q = 0; q < R; q += 4)
        *reinterpret_cast<float4*>(dst + r * PITCH + c0 + 3 + q) =
            make_float4(d[q], d[q + 1], d[q + 2], d[q + 3]);
    } else if (oy + r < h) {
      // the tile's columns [n, n + tw) inside the image
      const int tw = SX - 2 * n;
      float* o = out + (size_t)(oy + r) * w + ox;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int j = c0 + c;
        if (j >= n && j < n + tw && ox + j < w) o[j] = d[c];
      }
    }
  };

  float a[R + 2], b[R + 2];
  load_row(src, r0 - 1, c0, a);
  load_row(src, r0, c0, b);
  int r = r0;
  for (; r + 1 < r1; r += 2) {
    float c[R + 2], d[R + 2];
    load_row(src, r + 1, c0, c);
    load_row(src, r + 2, c0, d);
    float lo[R + 2], mid[R + 2], hi[R + 2], lo2[R + 2], mid2[R + 2], hi2[R + 2];
#pragma unroll
    for (int k = 0; k < R + 2; ++k) {
      const float pmn = fminf(b[k], c[k]), pmx = fmaxf(b[k], c[k]);
      sort_col(pmn, pmx, a[k], lo[k], mid[k], hi[k]);
      sort_col(pmn, pmx, d[k], lo2[k], mid2[k], hi2[k]);
    }
    float med[R], med2[R];
    medians(lo, mid, hi, med);
    medians(lo2, mid2, hi2, med2);
    emit(r, med);
    emit(r + 1, med2);
#pragma unroll
    for (int k = 0; k < R + 2; ++k) {
      a[k] = c[k];
      b[k] = d[k];
    }
  }
  if (r < r1) {   // an odd row left
    float c[R + 2];
    load_row(src, r + 1, c0, c);
    float lo[R + 2], mid[R + 2], hi[R + 2];
#pragma unroll
    for (int k = 0; k < R + 2; ++k)
      sort_col(fminf(b[k], c[k]), fmaxf(b[k], c[k]), a[k], lo[k], mid[k], hi[k]);
    float med[R];
    medians(lo, mid, hi, med);
    emit(r, med);
  }
}

// The staged region (sy x SX from (oy, ox)) of src, zero outside the image,
// as cp.async copies: one commit group, complete after __pipeline_wait_prior.
__device__ void stage(float* dst, const float* src, int sy, int oy, int ox, int h, int w) {
  for (int r = threadIdx.y; r < sy; r += ROWS) {
    const int gy = oy + r;
    const bool row_in = gy >= 0 && gy < h;
    for (int c = threadIdx.x; c < SX; c += LANES) {
      const int gx = ox + c;
      float* d = dst + r * PITCH + c + 3;
      if (row_in && gx >= 0 && gx < w)
        __pipeline_memcpy_async(d, src + (size_t)gy * w + gx, sizeof(float));
      else
        *d = 0.0f;
    }
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(THREADS)
color_smooth_kernel(const float* __restrict__ diffs, const float* __restrict__ g,
                    float* __restrict__ out, int h, int w, int n_passes) {
  extern __shared__ float smem[];
  const int sy = TH + 2 * n_passes;
  float* gs = smem;
  float* const buf0 = smem + sy * PITCH;    // buffer s starts at buf0 + s * sy * PITCH
  const int bstride = sy * PITCH;
  const size_t plane = (size_t)h * w;
  const int oy = blockIdx.y * TH - n_passes;
  const int ox = blockIdx.x * (SX - 2 * n_passes) - n_passes;

  stage(gs, g, sy, oy, ox, h, w);
  stage(buf0, diffs, sy, oy, ox, h, w);
  __pipeline_wait_prior(0);
  __syncthreads();
  int s = 0;
  for (int pl = 0; pl < 2; ++pl) {
    for (int p = 1; p < n_passes; ++p) {
      smooth_pass(buf0 + s * bstride, buf0 + (s ^ 1) * bstride, gs, p, n_passes, sy, oy, ox, h,
                  w, nullptr);
      __syncthreads();
      s ^= 1;
    }
    // Buffer s ^ 1 was last read before the barrier above: plane 1 loads
    // there while plane 0's last pass runs.
    if (pl == 0) stage(buf0 + (s ^ 1) * bstride, diffs + plane, sy, oy, ox, h, w);
    smooth_pass(buf0 + s * bstride, nullptr, gs, n_passes, n_passes, sy, oy, ox, h, w,
                out + pl * plane);
    if (pl == 0) {
      __pipeline_wait_prior(0);
      __syncthreads();
      s ^= 1;
    }
  }
}

}  // namespace

extern "C" int color_smooth_launch(const float* diffs, const float* g, float* out,
                                   int h, int w, int n_passes, void* stream) {
  if (n_passes < 1 || 2 * n_passes >= SX) return (int)cudaErrorInvalidValue;
  const int smem = 3 * (TH + 2 * n_passes) * PITCH * (int)sizeof(float);
  const int status = (int)cudaFuncSetAttribute(
      color_smooth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (status != 0) return status;
  const int tw = SX - 2 * n_passes;
  const dim3 grid((w + tw - 1) / tw, (h + TH - 1) / TH, 1);
  color_smooth_kernel<<<grid, dim3(LANES, ROWS), smem, static_cast<cudaStream_t>(stream)>>>(
      diffs, g, out, h, w, n_passes);
  return (int)cudaGetLastError();
}
