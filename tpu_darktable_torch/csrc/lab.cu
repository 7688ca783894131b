// The LAB round trip of the luminance stages for Hopper (sm_90a): sRGB ->
// LAB and a luminance plane (lab_split), and a new luminance with LAB's a
// and b -> clipped sRGB (lab_merge), each in one launch.
//
// Replaces no TPU kernel: the JAX package leaves the round trip to XLA,
// which fuses it into its neighbours.  Eager PyTorch runs it as ~60
// elementwise kernels and channel stacks a round trip, each reading and
// writing the whole frame (ops/color.py; ~9 ms a 12 MP round trip on an
// H100 against the ~0.2 ms its bytes need).
//
// What bounds it on this card: bytes.  lab_split reads 12 bytes a pixel
// and writes 16 (LAB and the plane), lab_merge reads 16 and writes 12:
// 28 a pixel each way, 0.103 ms at 4096x3000 and 3.35 TB/s, against
// ~60-90 float operations a pixel (three or four accurate powf and the
// 3x3 products).
//
// Design.  A thread owns 4 pixels at a time: three 16-byte loads of the
// interleaved RGB (or LAB), the pixels in registers, three 16-byte stores
// (and one of the plane).  Where a pointer is not 16-byte aligned, or at
// the last pixels, the same thread takes them one float at a time.  A
// grid-stride loop covers the frame; no shared memory, no barriers.
//
// Rounding.  Each pixel is computed as PyTorch's CUDA kernels compute the
// plain chain of ops/color.py, op for op, so the kernels equal the chain on
// the card bit for bit:
//  - every torch.where branch is the chain's expression; the selected one
//    is computed;
//  - a Python number becomes float32 before it meets a tensor; a division
//    by one is a product by its reciprocal, taken in double and rounded to
//    float32 (PyTorch's CUDA true division by a CPU scalar: 1/1.055 is
//    1 ulp from 1.0f / 1.055f); the white point is a tensor, so its
//    division is a true division;
//  - torch.pow's exponent is the float32 value of 2.4, 1/2.4 or 1/3;
//  - the 3x3 products are summed left to right; t * t * t is two products;
//  - clamp is torch.clamp's own form: NaN passes, else min(max(v, lo), hi).
// The build uses --fmad=false and no fast math, so nothing is contracted
// and powf is the accurate one.  Against the CPU's chain (true divisions,
// its own pow) the kernels differ by a few float32 ulps.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 4096;

// ops/color.py's constants as its chain's tensors meet them.
constexpr float SRGB_KNEE = 0.04045f;                                  // srgb <= 0.04045
constexpr float INV_12_92 = (float)(1.0 / 12.92);                      // srgb / 12.92
constexpr float SRGB_OFFSET = 0.055f;                                  // srgb + 0.055, ... - 0.055
constexpr float INV_1_055 = (float)(1.0 / 1.055);                      // (...) / 1.055
constexpr float POW_FLOOR = 1e-38f;                                    // clamp(..., min=1e-38)
constexpr float GAMMA = 2.4f;                                          // pow(..., 2.4)
constexpr float LINEAR_KNEE = 0.0031308f;                              // linear <= 0.0031308
constexpr float SLOPE = 12.92f;                                        // 12.92 * linear
constexpr float SCALE = 1.055f;                                        // 1.055 * pow(...)
constexpr float INV_GAMMA = (float)(1.0 / 2.4);                        // pow(..., 1.0 / 2.4)
constexpr double DELTA_D = 6.0 / 29.0;
constexpr float DELTA = (float)DELTA_D;                                // t > delta
constexpr float DELTA3 = (float)(DELTA_D * DELTA_D * DELTA_D);         // t > delta ** 3
constexpr float THIRD = (float)(1.0 / 3.0);                            // pow(t, 1.0 / 3.0)
constexpr float F_SLOPE = (float)(1.0 / (3.0 * DELTA_D * DELTA_D));    // factor * t
constexpr float F_INV_SLOPE = (float)(3.0 * DELTA_D * DELTA_D);        // (3 delta^2) * (...)
constexpr float FOUR_29 = (float)(4.0 / 29.0);                         // + 4/29, t - 4/29
constexpr float INV_100 = (float)(1.0 / 100.0);                        // L / 100.0
constexpr float INV_116 = (float)(1.0 / 116.0);                        // (L + 16.0) / 116.0
constexpr float INV_128 = (float)(1.0 / 128.0);                        // a / 128.0, b / 128.0
constexpr float INV_200 = (float)(1.0 / 200.0);                        // b / 200.0
constexpr float INV_500 = (float)(1.0 / 500.0);                        // a / 500.0

// _D65_WHITE (float32); the matrices' entries are written out in to_x,
// to_y, to_z (_RGB_TO_XYZ) and merge_pixel (_XYZ_TO_RGB).
constexpr float WHITE_X = 0.95047f;
constexpr float WHITE_Y = 1.0f;
constexpr float WHITE_Z = 1.08883f;

__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : max(v, lo); }

__device__ __forceinline__ float clip01(float v) { return v != v ? v : min(max(v, 0.0f), 1.0f); }

// srgb_to_linear
__device__ __forceinline__ float decode(float s) {
  return s <= SRGB_KNEE ? s * INV_12_92
                        : powf(clamp_min((s + SRGB_OFFSET) * INV_1_055, POW_FLOOR), GAMMA);
}

// linear_to_srgb
__device__ __forceinline__ float encode(float v) {
  return v <= LINEAR_KNEE ? SLOPE * v : SCALE * powf(clamp_min(v, POW_FLOOR), INV_GAMMA) - SRGB_OFFSET;
}

__device__ __forceinline__ float lab_f(float t) {
  return t > DELTA3 ? powf(clamp_min(t, 0.0f), THIRD) : F_SLOPE * t + FOUR_29;
}

__device__ __forceinline__ float lab_f_inv(float t) {
  return t > DELTA ? t * t * t : F_INV_SLOPE * (t - FOUR_29);
}

// One row of a 3x3 matrix times (c0, c1, c2), as color_transform_3x3 sums it.
__device__ __forceinline__ float dot3(float m0, float m1, float m2, float c0, float c1, float c2) {
  return m0 * c0 + m1 * c1 + m2 * c2;
}

// _RGB_TO_XYZ's rows.
__device__ __forceinline__ float to_x(float r, float g, float b) {
  return dot3(0.4124564f, 0.3575761f, 0.1804375f, r, g, b);
}
__device__ __forceinline__ float to_y(float r, float g, float b) {
  return dot3(0.2126729f, 0.7151522f, 0.0721750f, r, g, b);
}
__device__ __forceinline__ float to_z(float r, float g, float b) {
  return dot3(0.0193339f, 0.1191920f, 0.9503041f, r, g, b);
}

// One pixel of rgb_to_lab (out), and lum: LAB L of the clipped linear
// values (rgb_to_lab_with_clipped_l) or L itself.
__device__ __forceinline__ void split_pixel(const float* rgb, float* out, float& lum,
                                            int clipped_l) {
  const float r = decode(rgb[0]), g = decode(rgb[1]), b = decode(rgb[2]);
  const float fx = lab_f(to_x(r, g, b) / WHITE_X);
  const float fy = lab_f(to_y(r, g, b) / WHITE_Y);
  const float fz = lab_f(to_z(r, g, b) / WHITE_Z);
  out[0] = (116.0f * fy - 16.0f) * INV_100;
  out[1] = (500.0f * (fx - fy)) * INV_128;
  out[2] = (200.0f * (fy - fz)) * INV_128;
  if (clipped_l) {
    const float yc = to_y(clip01(r), clip01(g), clip01(b));
    lum = (116.0f * lab_f(yc / WHITE_Y) - 16.0f) * INV_100;
  } else {
    lum = out[0];
  }
}

// One pixel of clip01(lab_to_rgb(cat(lum, a, b))).
__device__ __forceinline__ void merge_pixel(const float* lab, float lum, float* out) {
  const float fy = (lum * 100.0f + 16.0f) * INV_116;
  const float fx = (lab[1] * 128.0f) * INV_500 + fy;
  const float fz = fy - (lab[2] * 128.0f) * INV_200;
  const float x = lab_f_inv(fx) * WHITE_X;
  const float y = lab_f_inv(fy) * WHITE_Y;
  const float z = lab_f_inv(fz) * WHITE_Z;
  // _XYZ_TO_RGB's rows
  out[0] = clip01(encode(dot3(3.2404542f, -1.5371385f, -0.4985314f, x, y, z)));
  out[1] = clip01(encode(dot3(-0.9692660f, 1.8760108f, 0.0415560f, x, y, z)));
  out[2] = clip01(encode(dot3(0.0556434f, -0.2040259f, 1.0572252f, x, y, z)));
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<unsigned long long>(a) | reinterpret_cast<unsigned long long>(b) |
           reinterpret_cast<unsigned long long>(c)) & 15ull) == 0;
}

__device__ __forceinline__ void load12(const float* src, float* v) {
  const float4* s = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float4 q = s[k];
    v[4 * k] = q.x; v[4 * k + 1] = q.y; v[4 * k + 2] = q.z; v[4 * k + 3] = q.w;
  }
}

__device__ __forceinline__ void store12(float* dst, const float* v) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    d[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

// rgb (n, 3) -> lab (n, 3), lum (n,).
__global__ void __launch_bounds__(THREADS)
lab_split_kernel(const float* __restrict__ rgb, float* __restrict__ lab, float* __restrict__ lum,
                 long long n, int clipped_l) {
  const bool vec = aligned16(rgb, lab, lum);
  const long long quads = (n + 3) / 4;
  for (long long q = blockIdx.x * (long long)THREADS + threadIdx.x; q < quads;
       q += (long long)gridDim.x * THREADS) {
    const long long p = 4 * q;
    float in[12], out[12], l[4];
    if (vec && p + 4 <= n) {
      load12(rgb + 3 * p, in);
#pragma unroll
      for (int k = 0; k < 4; ++k) split_pixel(in + 3 * k, out + 3 * k, l[k], clipped_l);
      store12(lab + 3 * p, out);
      *reinterpret_cast<float4*>(lum + p) = make_float4(l[0], l[1], l[2], l[3]);
    } else {
      const int m = n - p < 4 ? (int)(n - p) : 4;
      for (int k = 0; k < m; ++k) {
        for (int c = 0; c < 3; ++c) in[c] = rgb[3 * (p + k) + c];
        split_pixel(in, out, l[0], clipped_l);
        for (int c = 0; c < 3; ++c) lab[3 * (p + k) + c] = out[c];
        lum[p + k] = l[0];
      }
    }
  }
}

// lab (n, 3) (its L unread), lum (n,) -> rgb (n, 3).
__global__ void __launch_bounds__(THREADS)
lab_merge_kernel(const float* __restrict__ lab, const float* __restrict__ lum,
                 float* __restrict__ rgb, long long n) {
  const bool vec = aligned16(lab, lum, rgb);
  const long long quads = (n + 3) / 4;
  for (long long q = blockIdx.x * (long long)THREADS + threadIdx.x; q < quads;
       q += (long long)gridDim.x * THREADS) {
    const long long p = 4 * q;
    float in[12], out[12];
    if (vec && p + 4 <= n) {
      load12(lab + 3 * p, in);
      const float4 l = *reinterpret_cast<const float4*>(lum + p);
      merge_pixel(in, l.x, out);
      merge_pixel(in + 3, l.y, out + 3);
      merge_pixel(in + 6, l.z, out + 6);
      merge_pixel(in + 9, l.w, out + 9);
      store12(rgb + 3 * p, out);
    } else {
      const int m = n - p < 4 ? (int)(n - p) : 4;
      for (int k = 0; k < m; ++k) {
        for (int c = 0; c < 3; ++c) in[c] = lab[3 * (p + k) + c];
        merge_pixel(in, lum[p + k], out);
        for (int c = 0; c < 3; ++c) rgb[3 * (p + k) + c] = out[c];
      }
    }
  }
}

int blocks_for(long long n) {
  const long long b = ((n + 3) / 4 + THREADS - 1) / THREADS;
  return b < MAX_BLOCKS ? (int)b : MAX_BLOCKS;
}

}  // namespace

// clipped_l: 1 for the L of the clipped linear values, 0 for L itself.
extern "C" int lab_split_launch(const float* rgb, float* lab, float* lum, long long n,
                                int clipped_l, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  lab_split_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rgb, lab, lum, n, clipped_l);
  return (int)cudaGetLastError();
}

extern "C" int lab_merge_launch(const float* lab, const float* lum, float* rgb, long long n,
                                void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  lab_merge_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      lab, lum, rgb, n);
  return (int)cudaGetLastError();
}
