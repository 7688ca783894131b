// RCD interior cascade for Hopper (sm_90a): all 12 steps of the RCD main
// sequence (darktable's rcd.cu steps 1.1 -> 5.2) in one launch.
//
// Replaces the TPU kernel tpu_darktable/kernels/rcd_interior.py:rcd_interior.
// Only pixels >= 12 px from every image edge must be right: there the
// reference's region masks are all true and every half-grid slot read lands
// on a written slot, so no masks and no alias emulation are needed.  The
// caller (ops/rcd.py) overlays the ring from the plain path.
//
// Design.  One block computes a TILE x TILE output tile.  It loads the tile
// plus a HALO of 12 px (the cascade reaches 11 px) into shared memory and
// runs the steps stage by stage, each over a region that shrinks by that
// step's reach, with __syncthreads() between stages.  Six S x S planes of
// shared memory are reused across the stages (S = TILE + 2*HALO).
// Bound on the card: the whole frame is read once and three planes are
// written once, so HBM traffic is 16 bytes a pixel; the halo re-reads hit
// L2.  The arithmetic is ~200 unfused float ops a pixel (tallied from
// the steps below), more than the 16 bytes take at the HBM rate; the 3x
// redundancy of computing the halo multiplies it in this simple version.
//
// Every constant is a float literal and the build uses --fmad=false, so the
// kernel rounds exactly like the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int HALO = 12;
constexpr int S = TILE + 2 * HALO;
constexpr int PLANE = S * S;
constexpr int N_PLANES = 6;
constexpr int THREADS = 256;
constexpr float EPS5 = 1e-5f;
constexpr float EPS10 = 1e-10f;

struct Sites {
  int r_row, r_col, b_row, b_col;
  int png_even, png_odd;  // non-green column parity on even / odd rows
  __device__ bool is_r(int gy, int gx) const {
    return (gy & 1) == r_row && (gx & 1) == r_col;
  }
  __device__ bool is_b(int gy, int gx) const {
    return (gy & 1) == b_row && (gx & 1) == b_col;
  }
  __device__ bool is_g(int gy, int gx) const { return !is_r(gy, gx) && !is_b(gy, gx); }
};

__device__ __forceinline__ float sq(float x) { return x * x; }

// Loop over the square region [lo, S - lo)^2 of the tile, strided by thread.
#define FOR_REGION(lo, i, j)                                             \
  for (int _n = S - 2 * (lo), _k = threadIdx.x; _k < _n * _n; _k += blockDim.x) \
    if (int i = (lo) + _k / _n, j = (lo) + _k % _n; true)

__global__ void __launch_bounds__(THREADS)
rcd_interior_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int h, int w, Sites st) {
  extern __shared__ float smem[];
  float* cfa = smem;              // max(x, 0), zero outside the image
  float* b1 = smem + 1 * PLANE;   // vd -> vh_disc
  float* b2 = smem + 2 * PLANE;   // hd -> rgb1
  float* b3 = smem + 3 * PLANE;   // lpf -> pd_full -> pq_disc
  float* b4 = smem + 4 * PLANE;   // vh_dir -> qd_full -> rgb0
  float* b5 = smem + 5 * PLANE;   // pq_dir -> rgb2
  const int oy = blockIdx.y * TILE - HALO;  // global row of local row 0
  const int ox = blockIdx.x * TILE - HALO;  // even: local parity == global
#define A(p, i, j) (p)[(i) * S + (j)]

  // ---- populate ----
  FOR_REGION(0, i, j) {
    const int gy = oy + i, gx = ox + j;
    float v = 0.0f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) v = fmaxf(x[(size_t)gy * w + gx], 0.0f);
    A(cfa, i, j) = v;
  }
  __syncthreads();

  // ---- step 1.1: V/H squared high pass; step 2.1: low pass ----
  FOR_REGION(3, i, j) {
    const float c00 = A(cfa, i, j);
    A(b1, i, j) = sq(A(cfa, i - 3, j) - 3.0f * A(cfa, i - 2, j) - A(cfa, i - 1, j) + 6.0f * c00
                     - A(cfa, i + 1, j) - 3.0f * A(cfa, i + 2, j) + A(cfa, i + 3, j));
    A(b2, i, j) = sq(A(cfa, i, j - 3) - 3.0f * A(cfa, i, j - 2) - A(cfa, i, j - 1) + 6.0f * c00
                     - A(cfa, i, j + 1) - 3.0f * A(cfa, i, j + 2) + A(cfa, i, j + 3));
    A(b3, i, j) = c00
        + 0.5f * (A(cfa, i - 1, j) + A(cfa, i + 1, j) + A(cfa, i, j - 1) + A(cfa, i, j + 1))
        + 0.25f * (A(cfa, i - 1, j - 1) + A(cfa, i - 1, j + 1) + A(cfa, i + 1, j - 1)
                   + A(cfa, i + 1, j + 1));
  }
  __syncthreads();

  // ---- step 1.2: V/H local discrimination ----
  FOR_REGION(4, i, j) {
    const float v_stat = fmaxf(EPS10, A(b1, i - 1, j) + A(b1, i, j) + A(b1, i + 1, j));
    const float h_stat = fmaxf(EPS10, A(b2, i, j - 1) + A(b2, i, j) + A(b2, i, j + 1));
    A(b4, i, j) = v_stat / (v_stat + h_stat);
  }
  __syncthreads();

  // ---- step 3.1 (a): vh_disc (vd is dead) ----
  FOR_REGION(5, i, j) {
    const float vh_c = A(b4, i, j);
    const float vh_n = 0.25f * (A(b4, i - 1, j - 1) + A(b4, i - 1, j + 1)
                                + A(b4, i + 1, j - 1) + A(b4, i + 1, j + 1));
    A(b1, i, j) = fabsf(0.5f - vh_c) < fabsf(0.5f - vh_n) ? vh_n : vh_c;
  }
  __syncthreads();

  // ---- step 3.1 (b): green at R/B sites -> rgb1 (hd is dead) ----
  FOR_REGION(5, i, j) {
    const float c00 = A(cfa, i, j);
    if (st.is_g(oy + i, ox + j)) {
      A(b2, i, j) = c00;
    } else {
      const float n1 = A(cfa, i - 1, j), s1 = A(cfa, i + 1, j);
      const float w1 = A(cfa, i, j - 1), e1 = A(cfa, i, j + 1);
      const float n_grad = EPS5 + fabsf(n1 - s1) + fabsf(c00 - A(cfa, i - 2, j))
          + fabsf(n1 - A(cfa, i - 3, j)) + fabsf(A(cfa, i - 2, j) - A(cfa, i - 4, j));
      const float s_grad = EPS5 + fabsf(s1 - n1) + fabsf(c00 - A(cfa, i + 2, j))
          + fabsf(s1 - A(cfa, i + 3, j)) + fabsf(A(cfa, i + 2, j) - A(cfa, i + 4, j));
      const float w_grad = EPS5 + fabsf(w1 - e1) + fabsf(c00 - A(cfa, i, j - 2))
          + fabsf(w1 - A(cfa, i, j - 3)) + fabsf(A(cfa, i, j - 2) - A(cfa, i, j - 4));
      const float e_grad = EPS5 + fabsf(e1 - w1) + fabsf(c00 - A(cfa, i, j + 2))
          + fabsf(e1 - A(cfa, i, j + 3)) + fabsf(A(cfa, i, j + 2) - A(cfa, i, j + 4));
      const float lc = A(b3, i, j);
      const float n_est = n1 * (lc + lc) / (EPS5 + lc + A(b3, i - 2, j));
      const float s_est = s1 * (lc + lc) / (EPS5 + lc + A(b3, i + 2, j));
      const float w_est = w1 * (lc + lc) / (EPS5 + lc + A(b3, i, j - 2));
      const float e_est = e1 * (lc + lc) / (EPS5 + lc + A(b3, i, j + 2));
      const float v_est = (s_grad * n_est + n_grad * s_est) / (n_grad + s_grad);
      const float h_est = (w_grad * e_est + e_grad * w_est) / (e_grad + w_grad);
      A(b2, i, j) = v_est + A(b1, i, j) * (h_est - v_est);
    }
  }
  __syncthreads();

  // ---- step 4.1: P/Q diagonal high pass (lpf and vh_dir are dead) ----
  FOR_REGION(3, i, j) {
    const float c00 = A(cfa, i, j);
    A(b3, i, j) = sq((A(cfa, i - 3, j - 3) - A(cfa, i - 1, j - 1) - A(cfa, i + 1, j + 1)
                      + A(cfa, i + 3, j + 3))
                     - 3.0f * (A(cfa, i - 2, j - 2) + A(cfa, i + 2, j + 2)) + 6.0f * c00);
    A(b4, i, j) = sq((A(cfa, i - 3, j + 3) - A(cfa, i - 1, j + 1) - A(cfa, i + 1, j - 1)
                      + A(cfa, i + 3, j - 3))
                     - 3.0f * (A(cfa, i - 2, j + 2) + A(cfa, i + 2, j - 2)) + 6.0f * c00);
  }
  __syncthreads();

  // ---- step 4.2: P/Q local discrimination -> pq_dir ----
  // The half-grid plane at (r, c) is the full-grid value at (r, c | 1).
  FOR_REGION(6, i, j) {
    const int gy = oy + i, gx = ox + j;
    float p_stat, q_stat;
    if (gx & 1) {
      p_stat = A(b3, i - 1, j) + A(b3, i, j) + A(b3, i + 1, j + 2);
      q_stat = A(b4, i - 1, j + 2) + A(b4, i, j) + A(b4, i + 1, j);
    } else {
      p_stat = A(b3, i - 1, j - 1) + A(b3, i, j + 1) + A(b3, i + 1, j + 1);
      q_stat = A(b4, i - 1, j + 1) + A(b4, i, j + 1) + A(b4, i + 1, j - 1);
    }
    p_stat = fmaxf(EPS10, p_stat);
    q_stat = fmaxf(EPS10, q_stat);
    A(b5, i, j) = st.is_g(gy, gx) ? 0.0f : p_stat / (p_stat + q_stat);
  }
  __syncthreads();

  // ---- step 5.1 (a): pq_disc from the pair-expanded pq (pd_full is dead) ----
  // pq(r, c) is pq_dir at the non-green column of c's column pair.
  auto pq = [&](int i, int j) {
    const int gy = oy + i, gx = ox + j;
    const int png = (gy & 1) ? st.png_odd : st.png_even;
    return A(b5, i, j - (gx & 1) + png);
  };
  FOR_REGION(8, i, j) {
    const float pq_c = pq(i, j);
    const float pq_n = 0.25f * (pq(i - 1, j - 1) + pq(i - 1, j + 1)
                                + pq(i + 1, j - 1) + pq(i + 1, j + 1));
    A(b3, i, j) = fabsf(0.5f - pq_c) < fabsf(0.5f - pq_n) ? pq_n : pq_c;
  }
  __syncthreads();

  // ---- step 5.1 (b): R/B at opposite CFA sites (qd_full, pq_dir are dead) ----
  // rgb0 starts as cfa at R sites, rgb2 as cfa at B sites, zero elsewhere.
  FOR_REGION(8, i, j) {
    const int gy = oy + i, gx = ox + j;
    const bool r_site = st.is_r(gy, gx), b_site = st.is_b(gy, gx);
    float r0 = r_site ? A(cfa, i, j) : 0.0f;
    float r2 = b_site ? A(cfa, i, j) : 0.0f;
    if (r_site || b_site) {
      // fill the opposite channel from its initial plane (cfa at its sites)
      auto rc = [&](int dy, int dx) {
        const int yy = gy + dy, xx = gx + dx;
        const bool own = r_site ? st.is_b(yy, xx) : st.is_r(yy, xx);
        return own ? A(cfa, i + dy, j + dx) : 0.0f;
      };
      const float g1c = A(b2, i, j);
      const float nw_grad = EPS5 + fabsf(rc(-1, -1) - rc(1, 1)) + fabsf(rc(-1, -1) - rc(-3, -3))
          + fabsf(g1c - A(b2, i - 2, j - 2));
      const float ne_grad = EPS5 + fabsf(rc(-1, 1) - rc(1, -1)) + fabsf(rc(-1, 1) - rc(-3, 3))
          + fabsf(g1c - A(b2, i - 2, j + 2));
      const float sw_grad = EPS5 + fabsf(rc(-1, 1) - rc(1, -1)) + fabsf(rc(1, -1) - rc(3, -3))
          + fabsf(g1c - A(b2, i + 2, j - 2));
      const float se_grad = EPS5 + fabsf(rc(-1, -1) - rc(1, 1)) + fabsf(rc(1, 1) - rc(3, 3))
          + fabsf(g1c - A(b2, i + 2, j + 2));
      const float nw_est = rc(-1, -1) - A(b2, i - 1, j - 1);
      const float ne_est = rc(-1, 1) - A(b2, i - 1, j + 1);
      const float sw_est = rc(1, -1) - A(b2, i + 1, j - 1);
      const float se_est = rc(1, 1) - A(b2, i + 1, j + 1);
      const float p_est = (nw_grad * se_est + se_grad * nw_est) / (nw_grad + se_grad);
      const float q_est = (ne_grad * sw_est + sw_grad * ne_est) / (ne_grad + sw_grad);
      const float fill = g1c + (p_est + A(b3, i, j) * (q_est - p_est));
      if (r_site) r2 = fill; else r0 = fill;
    }
    A(b4, i, j) = r0;
    A(b5, i, j) = r2;
  }
  __syncthreads();

  // ---- step 5.2: R/B at green sites, and the output tile ----
  for (int k = threadIdx.x; k < TILE * TILE; k += blockDim.x) {
    const int i = HALO + k / TILE, j = HALO + k % TILE;
    const int gy = oy + i, gx = ox + j;
    if (gy >= h || gx >= w) continue;
    const float g1c = A(b2, i, j);
    float r0 = A(b4, i, j), r2 = A(b5, i, j);
    if (st.is_g(gy, gx)) {
      const float n1 = EPS5 + fabsf(g1c - A(b2, i - 2, j));
      const float s1 = EPS5 + fabsf(g1c - A(b2, i + 2, j));
      const float w1 = EPS5 + fabsf(g1c - A(b2, i, j - 2));
      const float e1 = EPS5 + fabsf(g1c - A(b2, i, j + 2));
      const float disc = A(b1, i, j);
      auto fill52 = [&](const float* p) {
        const float sn_abs = fabsf(A(p, i - 1, j) - A(p, i + 1, j));
        const float ew_abs = fabsf(A(p, i, j - 1) - A(p, i, j + 1));
        const float n_g = n1 + sn_abs + fabsf(A(p, i - 1, j) - A(p, i - 3, j));
        const float s_g = s1 + sn_abs + fabsf(A(p, i + 1, j) - A(p, i + 3, j));
        const float w_g = w1 + ew_abs + fabsf(A(p, i, j - 1) - A(p, i, j - 3));
        const float e_g = e1 + ew_abs + fabsf(A(p, i, j + 1) - A(p, i, j + 3));
        const float n_e = A(p, i - 1, j) - A(b2, i - 1, j);
        const float s_e = A(p, i + 1, j) - A(b2, i + 1, j);
        const float w_e = A(p, i, j - 1) - A(b2, i, j - 1);
        const float e_e = A(p, i, j + 1) - A(b2, i, j + 1);
        const float v_est = (n_g * s_e + s_g * n_e) / (n_g + s_g);
        const float h_est = (e_g * w_e + w_g * e_e) / (e_g + w_g);
        return g1c + (v_est + disc * (h_est - v_est));
      };
      r0 = fill52(b4);
      r2 = fill52(b5);
    }
    const size_t o = (size_t)gy * w + gx;
    const size_t plane = (size_t)h * w;
    out[o] = fmaxf(r0, 0.0f);
    out[plane + o] = fmaxf(g1c, 0.0f);
    out[2 * plane + o] = fmaxf(r2, 0.0f);
  }
#undef A
}

}  // namespace

extern "C" int rcd_interior_launch(const float* x, float* out, int h, int w,
                                   int r_row, int r_col, int b_row, int b_col,
                                   void* stream) {
  const int smem = N_PLANES * PLANE * (int)sizeof(float);
  cudaFuncSetAttribute(rcd_interior_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  Sites st;
  st.r_row = r_row; st.r_col = r_col; st.b_row = b_row; st.b_col = b_col;
  st.png_even = r_row == 0 ? r_col : b_col;
  st.png_odd = r_row == 1 ? r_col : b_col;
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE);
  rcd_interior_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(x, out, h, w, st);
  return (int)cudaGetLastError();
}
