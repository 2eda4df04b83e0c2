// Generic planar conv (K4): one conv layer on planar activations.
//
// Replaces the JAX package's Pallas kernel ops/planar_conv.py planar_conv
// (bodies _k3_kernel for 3x3 stride 1 or 2 and _k1_kernel for 1x1). It
// computes, for output row r, column c and channel co,
//   y = sum_{ky, kx, ci} x[S r + ky - P][ci][S c + kx - P] w[ky][kx][ci][co]
//   y = y + bias[co]                        (float32)
//   y = max(y, slope y)                     (if has_slope)
//   y = T(y)                                (stride 2 only: the Pallas
//                                            kernel rounds before its
//                                            even-index decimation)
//   y = y + res[r][co][c]                   (if res: the darknet shortcut,
//                                            after the activation)
//   y = gate > 0 ? y : gate_slope y         (if gate: the fused leaky
//                                            backward mask, applied last)
//   out = T(y)
// with float32 accumulation, P = (k - 1) / 2, x zero outside the image.
// Planar tensors are [B, H, C, Wl], column c at lane c + 1; every border
// and padding lane of the output is written as zero (the blocks of the
// first tile column write lane 0, those of the last the lanes past the
// image), so the output needs no memset.
//
// Weights: HWIO [k][k][cin][cout_pad] in the compute dtype, cin equal to
// the planar input's (channel-padded) cin and cout_pad = cout rounded up
// to 8 with zero columns; bias float32 [cout_pad].
//
// What bounds it on the H100: operations at the stem's widths (a 3x3 conv
// does 9 cin multiply-adds per output value against a few bytes of
// input and output), bytes for the 1x1 convs at small cin. What this first
// design does about it: each block owns an 8 x 32 tile of output positions
// for CB = 8, 16 or 32 output channels (grid.z runs over batch and
// channel blocks) and walks the input channels in chunks of 16: the
// chunk's input halo ([16][IH][IW], columns fastest, so a warp reads 32
// neighbouring positions without bank conflicts) and its weights
// ([k*k][16][CB]) are staged in shared memory, and each thread
// accumulates CB/8 positions x 8 channels in registers with CUDA-core
// FMAs. Tensor cores (an implicit GEMM on wgmma) are later work; so is
// the zero-interleaved stride-2 adjoint's 3/4 of wasted multiply-adds,
// which the JAX package's formulation (expand2_planar, then this stride-1
// conv) carries.
//
// res, gate and has_slope are runtime flags, uniform over the launch and
// read only in the epilogue, so one template per geometry, dtype and
// channel block serves every combination.

#include "stem_common.cuh"

namespace {

using namespace stem;

constexpr int TR = 8;   // output rows per tile
constexpr int TC = 32;  // output columns per tile
constexpr int KC = 16;  // input channels per shared-memory chunk

struct EpiArgs {
  const void* res;
  const void* gate;
  int has_slope;
  float slope;
  float gate_slope;
};

template <int KS, int S>
struct ConvGeom {
  static constexpr int IH = (TR - 1) * S + KS;  // input tile rows
  static constexpr int IW = (TC - 1) * S + KS;  // input tile columns
  static constexpr int XS = (KC * IH * IW + 7) / 8 * 8;
};

template <typename T, int KS, int S, int NCG>
__global__ void __launch_bounds__(NT)
    planar_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ bias, EpiArgs ea,
                       T* __restrict__ out, int H, int cin, int wl_in,
                       int w_img, int cout, int cout_pad, int Ho, int Wo,
                       int wl_out) {
  using G = ConvGeom<KS, S>;
  constexpr int CB = NCG * CT;      // output channels of this block
  constexpr int NPG = NT / NCG;     // position groups (>= 64: cg is
                                    // uniform over a warp)
  constexpr int PT = TR * TC / NPG; // positions per thread
  constexpr int PAD = (KS - 1) / 2;
  static_assert(PT * NPG == TR * TC && NPG % 32 == 0, "thread mapping");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // [KC][IH][IW]
  T* ws = xs + G::XS;                      // [KS*KS][KC][CB]

  const int n_cb = cout_pad / CB;
  const int cb = blockIdx.z % n_cb;
  const int b = blockIdx.z / n_cb;
  const int r0 = blockIdx.y * TR, c0 = blockIdx.x * TC;
  const int cg = threadIdx.x / NPG;
  const int pg = threadIdx.x % NPG;
  const int cob = cb * CB;  // first output channel of the block
  const int ir0 = r0 * S - PAD, ic0 = c0 * S - PAD;  // input tile origin
  const T* xb = x + (long long)b * H * cin * wl_in;

  float acc[PT][CT];
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[i][c] = 0.f;

  for (int ch0 = 0; ch0 < cin; ch0 += KC) {
    const int kc = min(KC, cin - ch0);
    __syncthreads();  // the previous chunk has been read
    for (int idx = threadIdx.x; idx < KC * G::IH * G::IW; idx += NT) {
      const int j = idx % G::IW;
      const int rest = idx / G::IW;
      const int i = rest % G::IH, ci = rest / G::IH;
      const int gr = ir0 + i, gc = ic0 + j;
      T v = from_f<T>(0.f);
      if (ci < kc && gr >= 0 && gr < H && gc >= 0 && gc < w_img)
        v = xb[((long long)gr * cin + ch0 + ci) * wl_in + gc + 1];
      xs[idx] = v;
    }
    for (int idx = threadIdx.x; idx < KS * KS * KC * CB; idx += NT) {
      const int co = idx % CB;
      const int rest = idx / CB;
      const int ci = rest % KC, tap = rest / KC;
      T v = from_f<T>(0.f);
      if (ci < kc)
        v = w[((long long)tap * cin + ch0 + ci) * cout_pad + cob + co];
      ws[idx] = v;
    }
    __syncthreads();
    for (int ci = 0; ci < kc; ++ci) {
      const T* xc = xs + ci * G::IH * G::IW;
#pragma unroll
      for (int ky = 0; ky < KS; ++ky) {
#pragma unroll
        for (int kx = 0; kx < KS; ++kx) {
          float wv[CT];
          load8s(ws + ((ky * KS + kx) * KC + ci) * CB + cg * CT, wv);
#pragma unroll
          for (int i = 0; i < PT; ++i) {
            const int p = pg + i * NPG;
            const int oy = p / TC, ox = p % TC;
            const float a = to_f(xc[(oy * S + ky) * G::IW + ox * S + kx]);
#pragma unroll
            for (int c = 0; c < CT; ++c) acc[i][c] = fmaf(a, wv[c], acc[i][c]);
          }
        }
      }
    }
  }

  // epilogue: a warp stores 32 neighbouring lanes of one channel
  const T* res = static_cast<const T*>(ea.res);
  const T* gate = static_cast<const T*>(ea.gate);
  const long long ob = (long long)b * Ho * cout * wl_out;
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int p = pg + i * NPG;
    const int r = r0 + p / TC, c = c0 + p % TC;
    if (r >= Ho || c >= Wo) continue;
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) {
      const int co = cob + cg * CT + cc;
      if (co >= cout) break;
      float y = acc[i][cc] + bias[co];
      if (ea.has_slope) y = fmaxf(y, y * ea.slope);
      if (S == 2) y = round_t<T>(y);
      const long long o = ob + ((long long)r * cout + co) * wl_out + c + 1;
      if (res != nullptr) y += to_f(res[o]);
      if (gate != nullptr) y = to_f(gate[o]) > 0.f ? y : y * ea.gate_slope;
      out[o] = from_f<T>(y);
    }
  }
  // zero border and padding lanes of this tile's rows and channels
  const bool first = blockIdx.x == 0, last = blockIdx.x == gridDim.x - 1;
  if (first || last) {
    const int nr = last ? wl_out - Wo - 1 : 0;
    const int n = nr + (first ? 1 : 0);
    for (int idx = threadIdx.x; idx < TR * CB * n; idx += NT) {
      const int k = idx % n;
      const int rest = idx / n;
      const int co = cob + rest % CB, r = r0 + rest / CB;
      const int lane = k < nr ? Wo + 1 + k : 0;
      if (r < Ho && co < cout)
        out[ob + ((long long)r * cout + co) * wl_out + lane] = from_f<T>(0.f);
    }
  }
}

template <typename T, int KS, int S, int NCG>
int launch(const void* x, const void* w, const float* bias, EpiArgs ea,
           void* out, int B, int H, int cin, int wl_in, int w_img, int cout,
           int cout_pad, cudaStream_t s) {
  using G = ConvGeom<KS, S>;
  constexpr int CB = NCG * CT;
  const size_t smem = sizeof(T) * ((size_t)G::XS + KS * KS * KC * CB);
  cudaError_t e = cudaFuncSetAttribute(
      planar_conv_kernel<T, KS, S, NCG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int Ho = H / S, Wo = w_img / S;
  const int wl_out = (Wo + 2 + 127) / 128 * 128;
  dim3 grid((Wo + TC - 1) / TC, (Ho + TR - 1) / TR, B * (cout_pad / CB));
  planar_conv_kernel<T, KS, S, NCG><<<grid, NT, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, ea,
      static_cast<T*>(out), H, cin, wl_in, w_img, cout, cout_pad, Ho, Wo,
      wl_out);
  return (int)cudaGetLastError();
}

// the channel block: 32 output channels where cout_pad allows it, else 16
// or 8 (cout_pad is a multiple of 8)
template <typename T, int KS, int S>
int launch_cb(const void* x, const void* w, const float* bias, EpiArgs ea,
              void* out, int B, int H, int cin, int wl_in, int w_img,
              int cout, int cout_pad, cudaStream_t s) {
  if (cout_pad % 32 == 0)
    return launch<T, KS, S, 4>(x, w, bias, ea, out, B, H, cin, wl_in, w_img,
                               cout, cout_pad, s);
  if (cout_pad % 16 == 0)
    return launch<T, KS, S, 2>(x, w, bias, ea, out, B, H, cin, wl_in, w_img,
                               cout, cout_pad, s);
  return launch<T, KS, S, 1>(x, w, bias, ea, out, B, H, cin, wl_in, w_img,
                             cout, cout_pad, s);
}

template <typename T>
int launch_geom(const void* x, const void* w, const float* bias, EpiArgs ea,
                void* out, int B, int H, int cin, int wl_in, int w_img,
                int cout, int cout_pad, int k, int stride, cudaStream_t s) {
  if (k == 1)
    return launch_cb<T, 1, 1>(x, w, bias, ea, out, B, H, cin, wl_in, w_img,
                              cout, cout_pad, s);
  if (stride == 2)
    return launch_cb<T, 3, 2>(x, w, bias, ea, out, B, H, cin, wl_in, w_img,
                              cout, cout_pad, s);
  return launch_cb<T, 3, 1>(x, w, bias, ea, out, B, H, cin, wl_in, w_img,
                            cout, cout_pad, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, res, gate, out); bias float32
// [cout_pad]. k = 1 (stride 1) or 3 (stride 1 or 2; stride 2 needs even H
// and w_img). res and gate are null or planar [B, H/stride, cout, wl_out].
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a geometry the
// kernel does not take.
extern "C" int apfp_planar_conv(const void* x, const void* w,
                                const void* bias, const void* res,
                                const void* gate, void* out, int dtype, int B,
                                int H, int cin, int wl_in, int w_img,
                                int cout, int cout_pad, int k, int stride,
                                int has_slope, float slope, float gate_slope,
                                void* stream) {
  if (!((k == 1 && stride == 1) || (k == 3 && (stride == 1 || stride == 2)))
      || cout_pad % 8 != 0 || cout > cout_pad)
    return (int)cudaErrorInvalidValue;
  const EpiArgs ea = {res, gate, has_slope, slope, gate_slope};
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_geom<__nv_bfloat16>(x, w, bf, ea, out, B, H, cin, wl_in,
                                      w_img, cout, cout_pad, k, stride, s);
  return launch_geom<float>(x, w, bf, ea, out, B, H, cin, wl_in, w_img, cout,
                            cout_pad, k, stride, s);
}
