// Fused YOLOv3 stem forward (K1): layers 0-5 in one kernel.
//
// Replaces the JAX package's Pallas kernel ops/stem_fused.py
// fused_stem_fwd (body _fwd_kernel, save_acts=False). It computes
//   y0 = leaky(conv0 3x3 s1  3->32  (x)  + b0)
//   y1 = leaky(conv1 3x3 s2 32->64  (y0) + b1)
//   y2 = leaky(conv2 1x1    64->32  (y1) + b2)
//   y3 = leaky(conv3 3x3 s1 32->64  (y2) + b3)
//   s4 = y3 + y1
//   y5 = leaky(conv5 3x3 s2 64->128 (s4) + b5)
// with leaky slope 0.1, float32 accumulation, and every intermediate
// rounded to the compute dtype where the Pallas kernel stores it: after
// each leaky, and on the shortcut sum. Input: the even/odd column phases
// of x, planar [B, H, 8, wlh] (channels 3..7 zero). Output: y5 planar
// [B, H/4, 128, wl5], value j at lane j + 1. The kernel writes every lane:
// the blocks of the first tile column write lane 0, those of the last
// tile column the lanes past the image, so the output needs no memset.
//
// What bounds it on the H100: operations. 11.2 GFLOP per 608^2 image
// against ~17.5 MB of planar input and output, far above the card's
// ~295 FLOP/byte ridge. What this first design does about it: nothing
// clever yet. Each block owns a TILE x TILE tile of y5 for all 128
// channels and computes backwards over its receptive field entirely in
// shared memory (x 41^2 -> y0 39^2x32 -> y1 19^2x64 -> y2 19^2x32 ->
// s4 17^2x64 -> y5 8^2x128 at TILE 8), so no intermediate touches device
// memory; the halo recompute costs ~1.35x the FLOPs. The convs are
// CUDA-core FMAs with float32 accumulation, each thread holding a
// PT-position x 8-channel register tile; weights (HWIO) are read through
// the read-only cache. Tensor cores (wgmma) and TMA are later work.
//
// Conv padding applies to each layer's input, so every halo position of
// y0, y1, y2 and s4 that lies outside the image is stored as zero (not
// leaky(bias)), as the Pallas kernel's in-range scale does.
//
// Shared memory at peak: bfloat16 TILE 8 = 153,648 bytes (x, y0, y1; y2
// and s4 reuse y0's region once conv1 has read it, y5 reuses y1's);
// float32 runs TILE 4 = 106,208 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int CT = 8;    // output channels per thread
constexpr float LEAKY = 0.1f;

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

// 8 consecutive weights (16- or 32-byte aligned) as floats
__device__ __forceinline__ void load8(const float* p, float* w) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* w) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}

// One conv layer between two shared-memory buffers laid out [pos][C].
// Output position (oy, ox) of the OH x OW tile reads the input at
// (S*oy + ky, S*ox + kx). (org_r, org_c) is the tile's first position in
// image coordinates; positions outside [0, img)^2 are stored as zero.
// With res, the stored value is T(T(leaky) + res) (the shortcut sum);
// res is [pos][COUT] with row pitch res_w, read at (oy+1, ox+1).
template <typename T, int CIN, int COUT, int KS, int S, int PT>
__device__ void conv_stage(const T* __restrict__ in, int IW,
                           T* __restrict__ out, int OH, int OW,
                           const T* __restrict__ w,
                           const float* __restrict__ bias, int org_r,
                           int org_c, int img, const T* __restrict__ res,
                           int res_w) {
  constexpr int NCG = COUT / CT;
  constexpr int NPG = NT / NCG;
  static_assert(COUT % CT == 0 && NT % NCG == 0, "thread mapping");
  const int cg = threadIdx.x % NCG;
  const int pg = threadIdx.x / NCG;
  const int npos = OH * OW;
  const int co0 = cg * CT;
  float b[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) b[c] = bias[co0 + c];

  for (int p0 = pg * PT; p0 < npos; p0 += NPG * PT) {
    float acc[PT][CT];
    int base[PT];
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int p = min(p0 + i, npos - 1);
      const int oy = p / OW, ox = p - oy * OW;
      base[i] = ((S * oy) * IW + S * ox) * CIN;
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[i][c] = 0.f;
    }
    for (int ky = 0; ky < KS; ++ky) {
      for (int kx = 0; kx < KS; ++kx) {
        const T* wp = w + (ky * KS + kx) * CIN * COUT + co0;
        const int toff = (ky * IW + kx) * CIN;
#pragma unroll 4
        for (int ci = 0; ci < CIN; ++ci) {
          float wv[CT];
          load8(wp + ci * COUT, wv);
#pragma unroll
          for (int i = 0; i < PT; ++i) {
            const float a = to_f(in[base[i] + toff + ci]);
#pragma unroll
            for (int c = 0; c < CT; ++c) acc[i][c] = fmaf(a, wv[c], acc[i][c]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int p = p0 + i;
      if (p >= npos) break;
      const int oy = p / OW, ox = p - oy * OW;
      const int gr = org_r + oy, gc = org_c + ox;
      const bool inside = gr >= 0 && gr < img && gc >= 0 && gc < img;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float y = acc[i][c] + b[c];
        T yt = from_f<T>(fmaxf(y, y * LEAKY));
        if (res != nullptr) {
          const T r = res[((oy + 1) * res_w + ox + 1) * COUT + co0 + c];
          yt = from_f<T>(to_f(yt) + to_f(r));
        }
        out[p * COUT + co0 + c] = inside ? yt : from_f<T>(0.f);
      }
    }
  }
}

template <int TILE>
struct Geom {
  static constexpr int S4N = 2 * TILE + 1;  // s4 / y3 tile side
  static constexpr int Y1N = S4N + 2;       // y1 / y2 tile side
  static constexpr int Y0N = 2 * Y1N + 1;   // y0 tile side
  static constexpr int XN = Y0N + 2;        // x tile side
  static constexpr int A = (XN * XN * 3 + 7) / 8 * 8;
  static constexpr int Y2 = Y1N * Y1N * 32;
  static constexpr int B0 = Y0N * Y0N * 32;
  static constexpr int B1 = Y2 + S4N * S4N * 64;
  static constexpr int B = B0 > B1 ? B0 : B1;
  static constexpr int C0 = Y1N * Y1N * 64;
  static constexpr int C1 = TILE * TILE * 128;
  static constexpr int C = C0 > C1 ? C0 : C1;
  static constexpr int ELEMS = A + B + C;
};

template <typename T, int TILE>
__global__ void __launch_bounds__(NT, 1)
    fused_stem_fwd_kernel(const T* __restrict__ xe, const T* __restrict__ xo,
                          const T* __restrict__ w0, const T* __restrict__ w1,
                          const T* __restrict__ w2, const T* __restrict__ w3,
                          const T* __restrict__ w5,
                          const float* __restrict__ b0,
                          const float* __restrict__ b1,
                          const float* __restrict__ b2,
                          const float* __restrict__ b3,
                          const float* __restrict__ b5, T* __restrict__ y5,
                          int H, int wlh, int wl5) {
  using G = Geom<TILE>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // [XN][XN][3]
  T* y0 = xs + G::A;                       // [Y0N][Y0N][32]
  T* y2 = y0;                              // [Y1N][Y1N][32], after conv1
  T* s4 = y0 + G::Y2;                      // [S4N][S4N][64]
  T* y1 = y0 + G::B;                       // [Y1N][Y1N][64]
  T* ys = y1;                              // [TILE][TILE][128], after conv3

  const int b = blockIdx.z;
  const int R5 = blockIdx.y * TILE, C5 = blockIdx.x * TILE;
  const int H1 = H / 2, H5 = H / 4;

  // x tile, image rows/cols from 4*R5 - 6; column c of x is lane c/2 + 1
  // of the even (c even) or odd phase
  const int xr0 = 4 * R5 - 6, xc0 = 4 * C5 - 6;
  for (int idx = threadIdx.x; idx < G::XN * G::XN * 3; idx += NT) {
    const int ci = idx % 3;
    const int p = idx / 3;
    const int gr = xr0 + p / G::XN, gc = xc0 + p % G::XN;
    T v = from_f<T>(0.f);
    if (gr >= 0 && gr < H && gc >= 0 && gc < H) {
      const T* src = (gc & 1) ? xo : xe;
      v = src[(((long long)b * H + gr) * 8 + ci) * wlh + (gc >> 1) + 1];
    }
    xs[idx] = v;
  }
  __syncthreads();
  conv_stage<T, 3, 32, 3, 1, 4>(xs, G::XN, y0, G::Y0N, G::Y0N, w0, b0,
                                4 * R5 - 5, 4 * C5 - 5, H, nullptr, 0);
  __syncthreads();
  conv_stage<T, 32, 64, 3, 2, 4>(y0, G::Y0N, y1, G::Y1N, G::Y1N, w1, b1,
                                 2 * R5 - 2, 2 * C5 - 2, H1, nullptr, 0);
  __syncthreads();
  conv_stage<T, 64, 32, 1, 1, 4>(y1, G::Y1N, y2, G::Y1N, G::Y1N, w2, b2,
                                 2 * R5 - 2, 2 * C5 - 2, H1, nullptr, 0);
  __syncthreads();
  conv_stage<T, 32, 64, 3, 1, 4>(y2, G::Y1N, s4, G::S4N, G::S4N, w3, b3,
                                 2 * R5 - 1, 2 * C5 - 1, H1, y1, G::Y1N);
  __syncthreads();
  conv_stage<T, 64, 128, 3, 2, 4>(s4, G::S4N, ys, TILE, TILE, w5, b5, 0, 0,
                                  0x7fffffff, nullptr, 0);
  __syncthreads();
  // y5 tile -> planar rows, lanes fastest
  for (int idx = threadIdx.x; idx < TILE * 128 * TILE; idx += NT) {
    const int cc = idx % TILE;
    const int rest = idx / TILE;
    const int co = rest % 128, rr = rest / 128;
    const int gr = R5 + rr, gc = C5 + cc;
    if (gr < H5 && gc < H5)
      y5[(((long long)b * H5 + gr) * 128 + co) * wl5 + gc + 1] =
          ys[(rr * TILE + cc) * 128 + co];
  }
  // zero border and padding lanes of this tile row: lane 0 (first tile
  // column) and lanes H5+1 .. wl5-1 (last tile column)
  const bool first = blockIdx.x == 0, last = blockIdx.x == gridDim.x - 1;
  if (first || last) {
    const int nr = last ? wl5 - H5 - 1 : 0;  // right padding lanes
    const int n = nr + (first ? 1 : 0);
    for (int idx = threadIdx.x; idx < TILE * 128 * n; idx += NT) {
      const int k = idx % n;
      const int rest = idx / n;
      const int co = rest % 128, gr = R5 + rest / 128;
      const int lane = k < nr ? H5 + 1 + k : 0;
      if (gr < H5)
        y5[(((long long)b * H5 + gr) * 128 + co) * wl5 + lane] =
            from_f<T>(0.f);
    }
  }
}

template <typename T, int TILE>
int launch(const void* xe, const void* xo, const void* const* w,
           const float* const* bias, void* y5, int B, int H, int wlh,
           int wl5, cudaStream_t s) {
  const size_t smem = sizeof(T) * (size_t)Geom<TILE>::ELEMS;
  cudaError_t e = cudaFuncSetAttribute(
      fused_stem_fwd_kernel<T, TILE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nt = (H / 4 + TILE - 1) / TILE;
  dim3 grid(nt, nt, B);
  fused_stem_fwd_kernel<T, TILE><<<grid, NT, smem, s>>>(
      static_cast<const T*>(xe), static_cast<const T*>(xo),
      static_cast<const T*>(w[0]), static_cast<const T*>(w[1]),
      static_cast<const T*>(w[2]), static_cast<const T*>(w[3]),
      static_cast<const T*>(w[4]), bias[0], bias[1], bias[2], bias[3],
      bias[4], static_cast<T*>(y5), H, wlh, wl5);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (TILE 4), 1 = bfloat16 (TILE 8). Weights are HWIO in
// the compute dtype, biases float32. Returns cudaGetLastError().
extern "C" int apfp_fused_stem_fwd(const void* xe, const void* xo,
                                   const void* w0, const void* w1,
                                   const void* w2, const void* w3,
                                   const void* w5, const void* b0,
                                   const void* b1, const void* b2,
                                   const void* b3, const void* b5, void* y5,
                                   int dtype, int B, int H, int wlh, int wl5,
                                   void* stream) {
  const void* w[5] = {w0, w1, w2, w3, w5};
  const float* bias[5] = {
      static_cast<const float*>(b0), static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<const float*>(b3),
      static_cast<const float*>(b5)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, 8>(xe, xo, w, bias, y5, B, H, wlh, wl5, s);
  return launch<float, 4>(xe, xo, w, bias, y5, B, H, wlh, wl5, s);
}
