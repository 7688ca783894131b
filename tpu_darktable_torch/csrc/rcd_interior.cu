// RCD interior cascade for Hopper (sm_90a): all 12 steps of the RCD main
// sequence (darktable's rcd.cu steps 1.1 -> 5.2) in one launch.
//
// Replaces the TPU kernel tpu_darktable/kernels/rcd_interior.py:rcd_interior.
// Only pixels >= 12 px from every image edge must be right: there the
// reference's region masks are all true and every half-grid slot read lands
// on a written slot, so no masks and no alias emulation are needed.  The
// caller (ops/rcd.py) overlays the ring from the plain path.
//
// What bounds it on this card.  The function reads the mosaic once and
// writes three planes (16 bytes a pixel, 0.015 ms at 12 MP), but runs ~200
// float operations and ~7.5 IEEE divisions a pixel through eight dependent
// stencil stages, so operations bind it (0.073 ms at 33.5 T/s; a division
// is ~10 instructions, which puts the floor nearer 0.15 ms).  Between the
// stages the intermediates live in shared memory, whose 128 bytes a clock
// per SM are a quarter of the float rate: every float a stage reads there
// costs about four operations' worth of time.  The first design (32x32
// tiles, six 56x56 planes, one pixel a thread) lost most of its time to
// that, to lanes idling through the site branches (consecutive lanes held
// both site parities) and to computing its 3.06x halo.
//
// Design.
//  - A thread owns a 2x2 Bayer quad in every stage.  The kernel is a
//    template on the non-green column of the even rows (PE; the odd rows'
//    is 1 - PE), so a quad's sites are known at compile time: each stage is
//    straight-line code for the sites it touches, no lane branches on a
//    site, and 5.1's diagonal taps read cfa unchecked (an odd diagonal from
//    an R site is always a B site and the reverse).
//  - Four stages and three barriers: (A) over the tile + 8 px, the V/H high
//    passes in registers, vh_dir, lpf at the non-green sites and the P/Q
//    high passes at the odd columns (all that 4.2 reads); (B) + 6 px, green
//    at the non-green sites (vh_disc from vh_dir on the fly) and pq_dir;
//    (C) + 4 px, R/B at the non-green sites (pq_disc from pq_dir on the
//    fly); (D) the tile, R/B at the green sites and the outputs.
//  - Planes: cfa and vh_dir full; lpf, pd, qd, rgb1, pq_dir and 5.1's fill
//    (in lpf's place) one value per row and column pair.  4.5 planes of
//    88 x 56 for a 64x32 tile (89 KB), where the first design had six of
//    56 x 56 for 32x32; stages A/B/C compute 1.88x / 1.63x / 1.41x the
//    tile, against 3.06x.
//  - Two blocks of 16 warps an SM (56 registers, no spills): the stages are
//    chains of dependent shared loads, and warps in flight hide them.  On
//    an H100 at 4096x3000 this beat 8 warps a block (0.34 ms), 12 (0.31),
//    a 64x64 or 128x32 tile of one block an SM (0.34) and 32x32 tiles
//    three blocks an SM (0.31): 0.29 ms (chip_pairs.py).
//  - Full planes are read as the float2 of a quad's column pair, half planes
//    as one float a quad: neighbouring lanes hold neighbouring quads, so no
//    read has a bank conflict.
//
// Every expression keeps the plain version's order of operations, every
// constant is a float literal, and the build uses --fmad=false with IEEE
// division, so the kernel rounds exactly like the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr int TQX = 32;              // output quads a tile in x (64 px)
constexpr int TQY = 16;              // and in y (32 px)
constexpr int THREADS = 512;
constexpr int BLOCKS_PER_SM = 2;
constexpr int HALO = 12;             // px, even; the cascade reaches 11
constexpr int SX = 2 * TQX + 2 * HALO;
constexpr int SY = 2 * TQY + 2 * HALO;
constexpr int PX = SX / 2;           // column pairs (quads) a staged row
constexpr int NQY = SY / 2;          // quad rows of the staged tile
constexpr int FULL = SY * SX;
constexpr int HALF = SY * PX;
constexpr int SMEM_BYTES = (2 * FULL + 5 * HALF) * (int)sizeof(float);
constexpr float EPS5 = 1e-5f;
constexpr float EPS10 = 1e-10f;

__device__ __forceinline__ float sq(float x) { return x * x; }

// Column offset dx (from a quad's left column, -8 <= dx < 8) -> its pair.
__host__ __device__ constexpr int pair_of(int dx) { return ((dx + 8) >> 1) - 4; }

// Site (2 qy + dy, 2 qx + dx) of a full plane, read as its pair's float2.
__device__ __forceinline__ float at(const float* p, int qy, int qx, int dy, int dx) {
  const float2 v = reinterpret_cast<const float2*>(p)[(2 * qy + dy) * PX + qx + pair_of(dx)];
  return (dx & 1) ? v.y : v.x;
}

// Row 2 qy + dy, column pair qx + dk of a half plane.
__device__ __forceinline__ float& hat(float* p, int qy, int qx, int dy, int dk) {
  return p[(2 * qy + dy) * PX + qx + dk];
}

// Every quad (qy, qx) of the staged tile at least `lo` quads inside it,
// strided by thread.
#define FOR_QUADS(lo, qy, qx)                                                          \
  for (int _n = PX - 2 * (lo), _k = threadIdx.x; _k < _n * (NQY - 2 * (lo)); _k += THREADS) \
    if (const int qy = (lo) + _k / _n, qx = (lo) + _k % _n; true)

template <int PE>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
rcd_interior_kernel(const float* __restrict__ x, float* __restrict__ out, int h, int w,
                    int r_row) {
  extern __shared__ float smem[];
  float* cfa = smem;                 // max(x, 0), zero outside the image
  float* vhd = smem + FULL;          // vh_dir
  float* lpf = smem + 2 * FULL;      // lpf at non-green sites -> 5.1's fill there
  float* pdh = lpf + HALF;           // pd_full at odd columns
  float* qdh = lpf + 2 * HALF;       // qd_full at odd columns
  float* g1h = lpf + 3 * HALF;       // rgb1 at non-green sites
  float* pqh = lpf + 4 * HALF;       // pq_dir at non-green sites
  float* fill = lpf;
  // Local parity equals global parity: both origins are even.
  const int oy = blockIdx.y * (2 * TQY) - HALO;
  const int ox = blockIdx.x * (2 * TQX) - HALO;

  for (int k = threadIdx.x; k < FULL; k += THREADS) {
    const int gy = oy + k / SX, gx = ox + k % SX;
    float v = 0.0f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) v = fmaxf(x[(size_t)gy * w + gx], 0.0f);
    cfa[k] = v;
  }
  __syncthreads();

  // ---- stage A: steps 1.1 and 1.2 (vh_dir), 2.1 (lpf), 4.1 (pd, qd) ----
  FOR_QUADS(2, qy, qx) {
    auto c = [&](int dy, int dx) { return at(cfa, qy, qx, dy, dx); };
    float vd[4][2], hd[2][4];  // rows -1..2 of both columns; columns -1..2 of both rows
#pragma unroll
    for (int r = -1; r <= 2; ++r)
#pragma unroll
      for (int b = 0; b < 2; ++b)
        vd[r + 1][b] = sq(c(r - 3, b) - 3.0f * c(r - 2, b) - c(r - 1, b) + 6.0f * c(r, b)
                          - c(r + 1, b) - 3.0f * c(r + 2, b) + c(r + 3, b));
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int j = -1; j <= 2; ++j)
        hd[a][j + 1] = sq(c(a, j - 3) - 3.0f * c(a, j - 2) - c(a, j - 1) + 6.0f * c(a, j)
                          - c(a, j + 1) - 3.0f * c(a, j + 2) + c(a, j + 3));
    float vh[2][2], lp[2], pd[2], qd[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const float v_stat = fmaxf(EPS10, vd[a][b] + vd[a + 1][b] + vd[a + 2][b]);
        const float h_stat = fmaxf(EPS10, hd[a][b] + hd[a][b + 1] + hd[a][b + 2]);
        vh[a][b] = v_stat / (v_stat + h_stat);
      }
      const int b = a ? 1 - PE : PE;  // the row's non-green column
      lp[a] = c(a, b) + 0.5f * (c(a - 1, b) + c(a + 1, b) + c(a, b - 1) + c(a, b + 1))
          + 0.25f * (c(a - 1, b - 1) + c(a - 1, b + 1) + c(a + 1, b - 1) + c(a + 1, b + 1));
      // at the odd column (a, 1)
      pd[a] = sq((c(a - 3, -2) - c(a - 1, 0) - c(a + 1, 2) + c(a + 3, 4))
                 - 3.0f * (c(a - 2, -1) + c(a + 2, 3)) + 6.0f * c(a, 1));
      qd[a] = sq((c(a - 3, 4) - c(a - 1, 2) - c(a + 1, 0) + c(a + 3, -2))
                 - 3.0f * (c(a - 2, 3) + c(a + 2, -1)) + 6.0f * c(a, 1));
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      reinterpret_cast<float2*>(vhd)[(2 * qy + a) * PX + qx] = make_float2(vh[a][0], vh[a][1]);
      hat(lpf, qy, qx, a, 0) = lp[a];
      hat(pdh, qy, qx, a, 0) = pd[a];
      hat(qdh, qy, qx, a, 0) = qd[a];
    }
  }
  __syncthreads();

  // ---- stage B: step 3.1 (green at non-green sites), step 4.2 (pq_dir) ----
  FOR_QUADS(3, qy, qx) {
    auto c = [&](int dy, int dx) { return at(cfa, qy, qx, dy, dx); };
    auto vh = [&](int dy, int dx) { return at(vhd, qy, qx, dy, dx); };
    auto L = [&](int dy, int dk) { return hat(lpf, qy, qx, dy, dk); };
    auto P = [&](int dy, int dk) { return hat(pdh, qy, qx, dy, dk); };
    auto Q = [&](int dy, int dk) { return hat(qdh, qy, qx, dy, dk); };
    float g1[2], pq[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int b = a ? 1 - PE : PE;  // the row's non-green column
      const float vh_c = vh(a, b);
      const float vh_n = 0.25f * (vh(a - 1, b - 1) + vh(a - 1, b + 1)
                                  + vh(a + 1, b - 1) + vh(a + 1, b + 1));
      const float disc = fabsf(0.5f - vh_c) < fabsf(0.5f - vh_n) ? vh_n : vh_c;
      const float c00 = c(a, b);
      const float n1 = c(a - 1, b), s1 = c(a + 1, b);
      const float w1 = c(a, b - 1), e1 = c(a, b + 1);
      const float n_grad = EPS5 + fabsf(n1 - s1) + fabsf(c00 - c(a - 2, b))
          + fabsf(n1 - c(a - 3, b)) + fabsf(c(a - 2, b) - c(a - 4, b));
      const float s_grad = EPS5 + fabsf(s1 - n1) + fabsf(c00 - c(a + 2, b))
          + fabsf(s1 - c(a + 3, b)) + fabsf(c(a + 2, b) - c(a + 4, b));
      const float w_grad = EPS5 + fabsf(w1 - e1) + fabsf(c00 - c(a, b - 2))
          + fabsf(w1 - c(a, b - 3)) + fabsf(c(a, b - 2) - c(a, b - 4));
      const float e_grad = EPS5 + fabsf(e1 - w1) + fabsf(c00 - c(a, b + 2))
          + fabsf(e1 - c(a, b + 3)) + fabsf(c(a, b + 2) - c(a, b + 4));
      // lpf two rows or two columns away sits at the same kind of site
      const float lc = L(a, 0);
      const float n_est = n1 * (lc + lc) / (EPS5 + lc + L(a - 2, 0));
      const float s_est = s1 * (lc + lc) / (EPS5 + lc + L(a + 2, 0));
      const float w_est = w1 * (lc + lc) / (EPS5 + lc + L(a, -1));
      const float e_est = e1 * (lc + lc) / (EPS5 + lc + L(a, 1));
      const float v_est = (s_grad * n_est + n_grad * s_est) / (n_grad + s_grad);
      const float h_est = (w_grad * e_est + e_grad * w_est) / (e_grad + w_grad);
      g1[a] = v_est + disc * (h_est - v_est);
      // pd, qd are read at odd columns only: pair k holds column 2k + 1
      float p_stat, q_stat;
      if (b == 1) {
        p_stat = P(a - 1, 0) + P(a, 0) + P(a + 1, 1);
        q_stat = Q(a - 1, 1) + Q(a, 0) + Q(a + 1, 0);
      } else {
        p_stat = P(a - 1, -1) + P(a, 0) + P(a + 1, 0);
        q_stat = Q(a - 1, 0) + Q(a, 0) + Q(a + 1, -1);
      }
      p_stat = fmaxf(EPS10, p_stat);
      q_stat = fmaxf(EPS10, q_stat);
      pq[a] = p_stat / (p_stat + q_stat);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      hat(g1h, qy, qx, a, 0) = g1[a];
      hat(pqh, qy, qx, a, 0) = pq[a];
    }
  }
  __syncthreads();

  // ---- stage C: step 5.1, R/B at non-green sites (the fill, either colour) ----
  FOR_QUADS(4, qy, qx) {
    float f[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int b = a ? 1 - PE : PE;  // the row's non-green column
      // pq (pair-expanded pq_dir) and rgb1 at sites (a + dy, b + dx): every
      // one read here is a non-green site, the one its pair holds.
      auto pq = [&](int dy, int dx) { return hat(pqh, qy, qx, a + dy, pair_of(b + dx)); };
      auto g1 = [&](int dy, int dx) { return hat(g1h, qy, qx, a + dy, pair_of(b + dx)); };
      auto rc = [&](int dy, int dx) { return at(cfa, qy, qx, a + dy, b + dx); };
      const float pq_c = pq(0, 0);
      const float pq_n = 0.25f * (pq(-1, -1) + pq(-1, 1) + pq(1, -1) + pq(1, 1));
      const float pq_disc = fabsf(0.5f - pq_c) < fabsf(0.5f - pq_n) ? pq_n : pq_c;
      const float g1c = g1(0, 0);
      const float nw_grad = EPS5 + fabsf(rc(-1, -1) - rc(1, 1)) + fabsf(rc(-1, -1) - rc(-3, -3))
          + fabsf(g1c - g1(-2, -2));
      const float ne_grad = EPS5 + fabsf(rc(-1, 1) - rc(1, -1)) + fabsf(rc(-1, 1) - rc(-3, 3))
          + fabsf(g1c - g1(-2, 2));
      const float sw_grad = EPS5 + fabsf(rc(-1, 1) - rc(1, -1)) + fabsf(rc(1, -1) - rc(3, -3))
          + fabsf(g1c - g1(2, -2));
      const float se_grad = EPS5 + fabsf(rc(-1, -1) - rc(1, 1)) + fabsf(rc(1, 1) - rc(3, 3))
          + fabsf(g1c - g1(2, 2));
      const float nw_est = rc(-1, -1) - g1(-1, -1);
      const float ne_est = rc(-1, 1) - g1(-1, 1);
      const float sw_est = rc(1, -1) - g1(1, -1);
      const float se_est = rc(1, 1) - g1(1, 1);
      const float p_est = (nw_grad * se_est + se_grad * nw_est) / (nw_grad + se_grad);
      const float q_est = (ne_grad * sw_est + sw_grad * ne_est) / (ne_grad + sw_grad);
      f[a] = g1c + (p_est + pq_disc * (q_est - p_est));
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) hat(fill, qy, qx, a, 0) = f[a];
  }
  __syncthreads();

  // ---- stage D: step 5.2, R/B at green sites, and the output tile ----
  const size_t plane = (size_t)h * w;
  FOR_QUADS(HALO / 2, qy, qx) {
    const int gy0 = oy + 2 * qy, gx0 = ox + 2 * qx;
    if (gy0 >= h || gx0 >= w) continue;
    auto c = [&](int dy, int dx) { return at(cfa, qy, qx, dy, dx); };
    float r0[2][2], g[2][2], r2[2][2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int b = a ? 1 - PE : PE, bg = 1 - b;
      const bool red_row = a == r_row;  // row a's non-green sites are R
      // the non-green site: its own colour, the fill for the other
      const float own = c(a, b), fl = hat(fill, qy, qx, a, 0);
      r0[a][b] = red_row ? own : fl;
      r2[a][b] = red_row ? fl : own;
      g[a][b] = hat(g1h, qy, qx, a, 0);
      // the green site (a, bg); its rgb1 is cfa
      const float g1c = c(a, bg);
      const float n1 = EPS5 + fabsf(g1c - c(a - 2, bg));
      const float s1 = EPS5 + fabsf(g1c - c(a + 2, bg));
      const float w1 = EPS5 + fabsf(g1c - c(a, bg - 2));
      const float e1 = EPS5 + fabsf(g1c - c(a, bg + 2));
      const float vh_c = at(vhd, qy, qx, a, bg);
      const float vh_n = 0.25f * (at(vhd, qy, qx, a - 1, bg - 1) + at(vhd, qy, qx, a - 1, bg + 1)
                                  + at(vhd, qy, qx, a + 1, bg - 1) + at(vhd, qy, qx, a + 1, bg + 1));
      const float disc = fabsf(0.5f - vh_c) < fabsf(0.5f - vh_n) ? vh_n : vh_c;
      // The taps (a + dy, bg + dx) are non-green: along the row row a's
      // colour, along the column the other one.
      auto g1 = [&](int dy, int dx) { return hat(g1h, qy, qx, a + dy, pair_of(bg + dx)); };
      auto fl_at = [&](int dy, int dx) { return hat(fill, qy, qx, a + dy, pair_of(bg + dx)); };
      auto cfa_along_row = [&](int dy, int dx) { return dy == 0 ? c(a, bg + dx) : fl_at(dy, dx); };
      auto cfa_along_col = [&](int dy, int dx) { return dy == 0 ? fl_at(dy, dx) : c(a + dy, bg); };
      auto fill52 = [&](auto p) {
        const float sn_abs = fabsf(p(-1, 0) - p(1, 0));
        const float ew_abs = fabsf(p(0, -1) - p(0, 1));
        const float n_g = n1 + sn_abs + fabsf(p(-1, 0) - p(-3, 0));
        const float s_g = s1 + sn_abs + fabsf(p(1, 0) - p(3, 0));
        const float w_g = w1 + ew_abs + fabsf(p(0, -1) - p(0, -3));
        const float e_g = e1 + ew_abs + fabsf(p(0, 1) - p(0, 3));
        const float n_e = p(-1, 0) - g1(-1, 0);
        const float s_e = p(1, 0) - g1(1, 0);
        const float w_e = p(0, -1) - g1(0, -1);
        const float e_e = p(0, 1) - g1(0, 1);
        const float v_est = (n_g * s_e + s_g * n_e) / (n_g + s_g);
        const float h_est = (e_g * w_e + w_g * e_e) / (e_g + w_g);
        return g1c + (v_est + disc * (h_est - v_est));
      };
      const float f_row = fill52(cfa_along_row), f_col = fill52(cfa_along_col);
      r0[a][bg] = red_row ? f_row : f_col;
      r2[a][bg] = red_row ? f_col : f_row;
      g[a][bg] = g1c;
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (gy0 + a >= h) break;
      const size_t o = (size_t)(gy0 + a) * w + gx0;
      if ((w & 1) == 0) {  // the pair is whole and 8-byte aligned
        reinterpret_cast<float2*>(out + o)[0] =
            make_float2(fmaxf(r0[a][0], 0.0f), fmaxf(r0[a][1], 0.0f));
        reinterpret_cast<float2*>(out + plane + o)[0] =
            make_float2(fmaxf(g[a][0], 0.0f), fmaxf(g[a][1], 0.0f));
        reinterpret_cast<float2*>(out + 2 * plane + o)[0] =
            make_float2(fmaxf(r2[a][0], 0.0f), fmaxf(r2[a][1], 0.0f));
      } else {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          if (gx0 + b >= w) break;
          out[o + b] = fmaxf(r0[a][b], 0.0f);
          out[plane + o + b] = fmaxf(g[a][b], 0.0f);
          out[2 * plane + o + b] = fmaxf(r2[a][b], 0.0f);
        }
      }
    }
  }
}

template <int PE>
int launch(const float* x, float* out, int h, int w, int r_row, cudaStream_t st) {
  const int status = (int)cudaFuncSetAttribute(
      rcd_interior_kernel<PE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (status != 0) return status;
  const dim3 grid((w + 2 * TQX - 1) / (2 * TQX), (h + 2 * TQY - 1) / (2 * TQY));
  rcd_interior_kernel<PE><<<grid, THREADS, SMEM_BYTES, st>>>(x, out, h, w, r_row);
  return (int)cudaGetLastError();
}

}  // namespace

// (r_row, r_col) and (b_row, b_col): parities of the R and B sites, which
// must sit on different rows and columns (a Bayer pattern).
extern "C" int rcd_interior_launch(const float* x, float* out, int h, int w,
                                   int r_row, int r_col, int b_row, int b_col,
                                   void* stream) {
  if (r_row == b_row || r_col == b_col) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pe = r_row == 0 ? r_col : b_col;  // non-green column of the even rows
  return pe ? launch<1>(x, out, h, w, r_row, st) : launch<0>(x, out, h, w, r_row, st);
}
