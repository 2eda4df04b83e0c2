// The EOT's factored affine warp (forward) and its adjoint into the patch
// (backward), evaluating only the hat functions' non-zero taps.
//
// Replaces no Pallas kernel: the JAX package's ops/affine_mxu.py
// affine_warp_mxu leaves this warp to XLA as two batched products with
// dense "hat" matrices. The port's plain version (ops/affine_mxu.py:
// affine_warp_mxu_plain) builds those matrices in float32 and multiplies by
// them with torch.einsum: at b24, 224 -> 608^2, 2.7e9 hat elements a step,
// each written, read and rewritten by five elementwise passes (≈ 28 ms) and
// kept for autograd (≈ 5.4 GB). Per sample, with coefficients (p, q, u1) of
// pass X and (r, s, v) of pass Y and the source src_t (the patch,
// transposed where the sample's swap flag is set), the warp is
//
//   mid[y, X, c] = sum_x hat(p X + q y + u1 - x) src_t[y, x, c]
//   out[Y, X, c] = sum_y hat(r X + s Y + v - y) mid[y, X, c]
//
// with hat(t) = max(0, 1 - |t|), over the channels of src and a ones
// channel (the mask). A hat is non-zero on at most two integer taps,
// floor(a) and floor(a) + 1 of its argument a: any other tap lies at least
// 1 away, and float32's rounding of a - tap is monotone, so its hat is 0
// in the plain version too. Each pass is a two-tap interpolation.
//
// The coefficients are the plain version's own (ops/affine_mxu.py:
// _factored_coeffs), computed once in torch and passed as one [B, 7] float32
// row a sample: p, q, u1, r, s, v and the swap flag (1 or 0).
//
// Numerics, the plain version's: each argument in float32 in its order,
// ((p * X) + (q * y)) + u1, then - x, then 1 - |.|, then clamped at 0, with
// __fmul_rn / __fadd_rn / __fsub_rn so that nothing is contracted into an
// FMA; each weight rounded to the warp dtype T; each product and sum in
// float32; mid rounded to T between the passes, out rounded to T at the end.
// In bfloat16 a weight times a value is exact in float32 and a two-term sum
// rounds once whatever the order, so the forward agrees with the einsums to
// the bit (unless their GEMM reduces split sums in bfloat16).
//
// Backward (the input only; theta gets no gradient): the adjoint of each
// pass as a gather, with no atomics, so that the gradient is the same bits
// from run to run. For source position (y, x) of src_t,
//
//   gmid[y, X, c] = sum_Y hat(r X + s Y + v - y) g[Y, X, c]      (rounded to T)
//   gsrc_t[y, x, c] = sum_X hat(p X + q y + u1 - x) gmid[y, X, c] (rounded to T)
//
// over the X and Y whose hat reaches the position: a window that follows
// from the sample's slope (|X - (x - q y - u1) / p| < 1 / |p|, and the same
// in Y with s), widened by a margin far above float32's rounding of the
// arguments; each candidate's weight is the forward's float32 hat, so the
// window only bounds the loop. The mask's cotangent does not reach the
// patch (the ones channel is a constant): the wrapper marks the mask
// non-differentiable, and the backward reads the [B, oh, ow, C] cotangent
// of the warped channels alone.
//
// What bounds it on the H100: bytes. At b24, 224 -> 608^2 in bfloat16 the
// forward reads the 7.2 MB patch and writes the 71 MB [24, 608, 608, 4]
// result (≈ 0.023 ms at 3.35 TB/s); the backward reads the cotangent only
// inside each sample's warped patch (224 z by 224 z pixels at zoom z, at most
// 1.1 MB a sample at the EOT's largest zoom, out of the canvas's 2.2 MB) and
// writes the 7.2 MB patch gradient.
//
// Design. Forward: one thread for PX neighbouring output pixels of a row
// (PX * (C + 1) values of T = 16 bytes, one vector store; PX = 2 for
// bfloat16 RGB + mask). The two mid values an output reads are recomputed
// in registers from their two source taps each (mid is never stored), the
// source read through L2 (7.2 MB at b24); outputs whose pass-Y argument
// reaches no row store zeros without a load. Backward: one thread for one
// source position, walking its X window and, for each X whose weight is
// not 0, its Y window. Tensor cores have no part in a two-tap sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BX = 32, BY = 8;  // a block: 32 x 8 threads
constexpr int C = 3, CP = 4;    // RGB, and with the mask

// A sample's coefficients: pass X's p, q, u1, pass Y's r (A21), s (A22),
// v (B2), and the conditioning swap, from its row k of the [B, 7] table
struct Coef {
  float p, q, u1, r, s, v;
  bool swap;
};

__device__ __forceinline__ Coef load_coef(const float* __restrict__ k) {
  return Coef{k[0], k[1], k[2], k[3], k[4], k[5], k[6] != 0.f};
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T (the plain version's cast to the warp dtype), as a float
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// v rounded to T, its bits (in the low half for bfloat16)
template <typename T>
__device__ __forceinline__ uint32_t tbits(float v) {
  if constexpr (sizeof(T) == 4) {
    return __float_as_uint(v);
  } else {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
}

// ((a * X) + (b * Y)) + c in float32, in the plain version's order
__device__ __forceinline__ float arg3(float a, float X, float b, float Y,
                                      float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, X), __fmul_rn(b, Y)), c);
}

// hat(arg - tap) = clamp(1 - |arg - tap|, 0), rounded to T
template <typename T>
__device__ __forceinline__ float hat_w(float arg, int tap) {
  const float t = __fsub_rn(arg, (float)tap);
  return rnd<T>(fmaxf(__fsub_rn(1.f, fabsf(t)), 0.f));
}

// The integers k in [0, n) that can satisfy |slope * k + off - t| < 1, as
// [lo, hi] (empty when lo > hi): the real-valued window widened by
// 1e-3 * (|off| + |t| + |slope| n + 1) (float32 rounds these arguments by
// ~1e-7 of their size) and by one index each side. A slope of 0, or bounds
// that are not numbers, give [0, n) or nothing as the real window does.
__device__ __forceinline__ void window(float slope, float off, float t, int n,
                                       int& lo, int& hi) {
  const float slack =
      1.f + 1e-3f * (fabsf(off) + fabsf(t) + fabsf(slope) * n + 1.f);
  const float e1 = (t - slack - off) / slope;
  const float e2 = (t + slack - off) / slope;
  float a = fminf(e1, e2), b = fmaxf(e1, e2);
  if (!(a <= b)) {  // NaN: 0 / 0
    lo = 0;
    hi = n - 1;
    return;
  }
  a = fminf(fmaxf(floorf(a) - 1.f, 0.f), (float)n);
  b = fmaxf(fminf(ceilf(b) + 1.f, (float)(n - 1)), -1.f);
  lo = (int)a;
  hi = (int)b;
}

// output pixels a forward thread owns: 16 bytes of 4-channel pixels (one in
// float32, two in bfloat16)
template <typename T>
constexpr int PX = 16 / (CP * (int)sizeof(T));

template <typename T>
__global__ void __launch_bounds__(BX* BY)
    warp_fwd_kernel(const T* __restrict__ src, const float* __restrict__ coef,
                    T* __restrict__ out, int n, int oh, int ow, int vec) {
  constexpr int px = PX<T>;
  const int b = blockIdx.z;
  const int Y = blockIdx.y * BY + threadIdx.y;
  const int X0 = (blockIdx.x * BX + threadIdx.x) * px;
  if (Y >= oh || X0 >= ow) return;
  const Coef cf = load_coef(coef + b * 7);
  const float p = cf.p, q = cf.q, u1 = cf.u1, r = cf.r, s = cf.s, v = cf.v;
  const bool swap = cf.swap;
  const T* sb = src + (long long)b * n * n * C;
  // element strides of src_t's row y and column x
  const long long sy = swap ? C : (long long)n * C;
  const long long sx = swap ? (long long)n * C : C;
  const float fn = (float)n, fY = (float)Y;
  float acc[px][CP];
#pragma unroll
  for (int i = 0; i < px; ++i) {
#pragma unroll
    for (int c = 0; c < CP; ++c) acc[i][c] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < px; ++i) {
    const int X = X0 + i;
    if (X >= ow) break;
    const float fX = (float)X;
    const float aY = arg3(r, fX, s, fY, v);
    if (!(aY > -1.f && aY < fn)) continue;  // no row within reach
    const int y0 = (int)floorf(aY);
#pragma unroll
    for (int ky = 0; ky < 2; ++ky) {
      const int y = y0 + ky;
      if (y < 0 || y >= n) continue;
      const float wy = hat_w<T>(aY, y);
      if (wy == 0.f) continue;
      // mid[y, X]: pass X at this row, from its two source taps
      float m[CP];
#pragma unroll
      for (int c = 0; c < CP; ++c) m[c] = 0.f;
      const float aX = arg3(p, fX, q, (float)y, u1);
      if (aX > -1.f && aX < fn) {
        const int x0 = (int)floorf(aX);
#pragma unroll
        for (int kx = 0; kx < 2; ++kx) {
          const int x = x0 + kx;
          if (x < 0 || x >= n) continue;
          const float wx = hat_w<T>(aX, x);
          const T* sp = sb + y * sy + x * sx;
#pragma unroll
          for (int c = 0; c < C; ++c)
            m[c] = __fadd_rn(m[c], __fmul_rn(wx, to_f(__ldg(sp + c))));
          m[C] = __fadd_rn(m[C], wx);  // the ones channel
        }
      }
#pragma unroll
      for (int c = 0; c < CP; ++c)
        acc[i][c] = __fadd_rn(acc[i][c], __fmul_rn(wy, rnd<T>(m[c])));
    }
  }
  T* o = out + (((long long)b * oh + Y) * ow + X0) * CP;
  if (vec) {  // ow % px == 0: X0 .. X0 + px - 1 lie in the row
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (sizeof(T) == 4) {
        w[k] = tbits<T>(acc[0][k]);
      } else {
        const int e = 2 * k, f = 2 * k + 1;
        w[k] = tbits<T>(acc[e / CP][e % CP]) |
               (tbits<T>(acc[f / CP][f % CP]) << 16);
      }
    }
    *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < px; ++i) {
    if (X0 + i >= ow) break;
#pragma unroll
    for (int c = 0; c < CP; ++c) o[i * CP + c] = from_f<T>(acc[i][c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(BX* BY)
    warp_bwd_kernel(const T* __restrict__ g, const float* __restrict__ coef,
                    T* __restrict__ gsrc, int n, int oh, int ow) {
  const int b = blockIdx.z;
  const int y = blockIdx.y * BY + threadIdx.y;  // src_t's row
  const int x = blockIdx.x * BX + threadIdx.x;  // src_t's column
  if (y >= n || x >= n) return;
  const Coef cf = load_coef(coef + b * 7);
  const float p = cf.p, q = cf.q, u1 = cf.u1, r = cf.r, s = cf.s, v = cf.v;
  const bool swap = cf.swap;
  const T* gb = g + (long long)b * oh * ow * C;
  const float fy = (float)y;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  int x_lo, x_hi;
  window(p, __fadd_rn(__fmul_rn(q, fy), u1), (float)x, ow, x_lo, x_hi);
  for (int X = x_lo; X <= x_hi; ++X) {
    const float fX = (float)X;
    const float wx = hat_w<T>(arg3(p, fX, q, fy, u1), x);
    if (wx == 0.f) continue;
    float gm[C];
#pragma unroll
    for (int c = 0; c < C; ++c) gm[c] = 0.f;
    int y_lo, y_hi;
    window(s, __fadd_rn(__fmul_rn(r, fX), v), fy, oh, y_lo, y_hi);
    for (int Y = y_lo; Y <= y_hi; ++Y) {
      const float wy = hat_w<T>(arg3(r, fX, s, (float)Y, v), y);
      if (wy == 0.f) continue;
      const T* gp = gb + ((long long)Y * ow + X) * C;
#pragma unroll
      for (int c = 0; c < C; ++c)
        gm[c] = __fadd_rn(gm[c], __fmul_rn(wy, to_f(__ldg(gp + c))));
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      acc[c] = __fadd_rn(acc[c], __fmul_rn(wx, rnd<T>(gm[c])));
  }
  const int row = swap ? x : y, col = swap ? y : x;
  T* o = gsrc + (((long long)b * n + row) * n + col) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) o[c] = from_f<T>(acc[c]);
}

template <typename T>
int launch_fwd(const void* src, const float* coef, void* out, int B, int n,
               int oh, int ow, cudaStream_t st) {
  constexpr int px = PX<T>;
  const dim3 grid((ow + BX * px - 1) / (BX * px), (oh + BY - 1) / BY, B);
  warp_fwd_kernel<T><<<grid, dim3(BX, BY), 0, st>>>(
      static_cast<const T*>(src), coef, static_cast<T*>(out), n, oh, ow,
      ow % px == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* g, const float* coef, void* gsrc, int B, int n,
               int oh, int ow, cudaStream_t st) {
  const dim3 grid((n + BX - 1) / BX, (n + BY - 1) / BY, B);
  warp_bwd_kernel<T><<<grid, dim3(BX, BY), 0, st>>>(
      static_cast<const T*>(g), coef, static_cast<T*>(gsrc), n, oh, ow);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (src, out; the compute is float32).
// src [B, n, n, 3] contiguous (RGB); coef [B, 7] float32 contiguous (a
// sample's Coef); out [B, oh, ow, 4] contiguous: the warped channels and the
// mask. Returns cudaGetLastError().
extern "C" int apfp_affine_warp_fwd(const void* src, const void* coef,
                                    void* out, int dtype, int B, int n,
                                    int oh, int ow, void* stream) {
  const float* k = static_cast<const float*>(coef);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(src, k, out, B, n, oh, ow, st);
  return launch_fwd<float>(src, k, out, B, n, oh, ow, st);
}

// g [B, oh, ow, 3] contiguous: the cotangent of the forward's warped
// channels; gsrc [B, n, n, 3] contiguous: the cotangent of src, every
// element written. The other arguments as the forward's.
extern "C" int apfp_affine_warp_bwd(const void* g, const void* coef,
                                    void* gsrc, int dtype, int B, int n,
                                    int oh, int ow, void* stream) {
  const float* k = static_cast<const float*>(coef);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(g, k, gsrc, B, n, oh, ow, st);
  return launch_bwd<float>(g, k, gsrc, B, n, oh, ow, st);
}
