// Helpers shared by the hand-written kernels (stem_fused.cu, stem_bwd.cu,
// stem_remat.cu, stem_batched.cu, planar_conv.cu, res_fused.cu): float
// conversion of the compute dtype, an 8-wide weight load through the
// read-only cache (load8) and the same from shared memory (load8s); the
// stem's forward conv stage on CUDA-core FMAs (conv_stage: float32 K1, K5's
// recompute and the batch-on-lanes forward) and its input-cotangent chain
// on CUDA-core FMAs (grad_chain, chain_tail: float32 K2, K5 and, past its
// first stage, the float32 batch-on-lanes backward); the tensor-core
// implicit GEMMs' shared pieces (ldmatrix, K1's epilogue EpiConv, the row
// maps) and the bfloat16 chain's epilogues (bwd_tc); and the GEMMs built
// for Hopper's own units (wg: wgmma with the weights streamed into shared
// memory by bulk copies, a producer warp, mbarriers), which every bfloat16
// conv kernel runs (K1, K5's recompute, the batch-on-lanes forward K8a, K4,
// K6), with K2's chain on them (wgc) that K2, K5 and the batch-on-lanes
// backward (K8b) share. A wgmma k16 step sums as an mma.sync one, bit for
// bit (checked on the card), so the wgmma kernels equal the mma.sync ones
// they replaced.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace stem {

constexpr int NT = 256;  // threads per block
constexpr int CT = 8;    // output channels per thread
constexpr float LEAKY = 0.1f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(unsigned char v) { return v; }
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
// round to the compute dtype and back (T of the Pallas kernels' stores)
template <typename T>
__device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
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

// 8 consecutive values (16- or 32-byte aligned) of a shared-memory array
__device__ __forceinline__ void load8s(const float* p, float* w) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}
__device__ __forceinline__ void load8s(const __nv_bfloat16* p, float* w) {
  const uint4 u = reinterpret_cast<const uint4*>(p)[0];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}

// Zero elements [l, wl) of n_lines consecutive lines of wl elements from p
// (p 16-byte aligned, a line 16 bytes' multiple): single elements up to
// the first 16-byte boundary, 16-byte stores past it. Threads 0 .. nthr - 1
// share the work (nthr 0: the whole block)
template <typename T>
__device__ void zero_tail(T* __restrict__ p, int n_lines, int l, int wl,
                          int nthr = 0) {
  constexpr int V = 16 / (int)sizeof(T);
  const int step = nthr ? nthr : (int)blockDim.x;
  const int a = min((l + V - 1) / V * V, wl);
  for (int idx = threadIdx.x; idx < n_lines * (V - 1); idx += step) {
    const int k = idx % (V - 1), line = idx / (V - 1);
    if (l + k < a) p[(long long)line * wl + l + k] = T(0.f);
  }
  const int nv = (wl - a) / V;
  for (int idx = threadIdx.x; idx < n_lines * nv; idx += step) {
    const int line = idx / nv, k = idx - line * nv;
    reinterpret_cast<uint4*>(p + (long long)line * wl + a)[k] =
        make_uint4(0, 0, 0, 0);
  }
}

// n elements (n * sizeof(T) a multiple of 16, both pointers 16-byte
// aligned) from device memory into shared memory, 16 bytes a thread
template <typename T>
__device__ __forceinline__ void copy_to_shared(T* __restrict__ dst,
                                               const T* __restrict__ src,
                                               int n) {
  const int nv = n * (int)sizeof(T) / 16;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) d[i] = __ldg(s + i);
}

// A kernel as the card sees it, for the kernels' *_info entry points:
// info[0] registers a thread, info[1] the dynamic shared memory bytes of a
// launch (smem), info[2] the blocks of `threads` threads one
// multiprocessor holds. Returns the CUDA error.
template <class F>
int info_of(F kernel, size_t smem, int* info, int threads = NT) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                     threads, smem);
  info[0] = a.numRegs;
  info[1] = (int)smem;
  info[2] = blocks;
  return (int)e;
}

// ---------------------------------------------------------------------------
// The stem's forward conv stage on CUDA-core FMAs (float32 K1, K5's
// recompute, the batch-on-lanes forward)
// ---------------------------------------------------------------------------

// One conv layer between two shared-memory buffers laid out [pos][C].
// Output position (oy, ox) of the OH x OW tile reads the input at
// (S*oy + ky, SC*ox + kx): row stride S, column stride SC (S unless
// given; the batch-on-lanes stem's conv5 runs at (2, 1)). (org_r, org_c)
// is the tile's first position in image coordinates; positions outside
// [0, img)^2 are stored as zero. With res, the stored value is
// T(T(leaky) + res) (the shortcut sum); res is [pos][COUT] with row pitch
// res_w, read at (oy+1, ox+1). With SG, sg[pos][COUT] receives the sign
// (1 if > 0) of T(leaky), before the shortcut sum: the layer's own
// activation, for the saved-sign backward.
template <typename T, int CIN, int COUT, int KS, int S, int PT,
          bool SG = false, int SC = S>
__device__ void conv_stage(const T* __restrict__ in, int IW,
                           T* __restrict__ out, int OH, int OW,
                           const T* __restrict__ w,
                           const float* __restrict__ bias, int org_r,
                           int org_c, int img, const T* __restrict__ res,
                           int res_w, unsigned char* __restrict__ sg = nullptr) {
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
      base[i] = ((S * oy) * IW + SC * ox) * CIN;
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
        if (SG) sg[p * COUT + co0 + c] = to_f(yt) > 0.f ? 1 : 0;
        if (res != nullptr) {
          const T r = res[((oy + 1) * res_w + ox + 1) * COUT + co0 + c];
          yt = from_f<T>(to_f(yt) + to_f(r));
        }
        out[p * COUT + co0 + c] = inside ? yt : from_f<T>(0.f);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The transposed convs of the input-cotangent chain
// ---------------------------------------------------------------------------

// Stride-2 adjoint over NS x NS super positions: in [pos][CIN] with row
// pitch IW, super position (a, b) reads in at (a, b), (a, b+1), (a+1, b)
// and (a+1, b+1) and yields the outputs (2a+py, 2b+px).
template <typename T, int CIN, int COUT, class Epi>
__device__ void convt_s2(const T* __restrict__ in, int IW, int NS,
                         const T* __restrict__ w, const Epi& epi) {
  constexpr int NCG = COUT / CT;
  constexpr int NPG = NT / NCG;
  static_assert(COUT % CT == 0 && NT % NCG == 0, "thread mapping");
  const int cg = threadIdx.x % NCG;
  const int co0 = cg * CT;
  const T* wp = w + co0;
  constexpr int TS = CIN * COUT;  // one tap's weights
  for (int s = threadIdx.x / NCG; s < NS * NS; s += NPG) {
    const int a = s / NS, b = s - a * NS;
    float acc[4][CT];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[q][c] = 0.f;
    const T* i00 = in + (a * IW + b) * CIN;
    const T* i01 = i00 + CIN;
    const T* i10 = i00 + IW * CIN;
    const T* i11 = i10 + CIN;
#pragma unroll 2
    for (int ci = 0; ci < CIN; ++ci) {
      const float a00 = to_f(i00[ci]), a01 = to_f(i01[ci]);
      const float a10 = to_f(i10[ci]), a11 = to_f(i11[ci]);
      const T* wc = wp + ci * COUT;
      float wv[CT];
      // out (even, even): tap (1, 1) at (a, b)
      load8(wc + 4 * TS, wv);
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[0][c] = fmaf(a00, wv[c], acc[0][c]);
      // out (even, odd): (1, 0) at (a, b+1), (1, 2) at (a, b)
      load8(wc + 3 * TS, wv);
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[1][c] = fmaf(a01, wv[c], acc[1][c]);
      load8(wc + 5 * TS, wv);
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[1][c] = fmaf(a00, wv[c], acc[1][c]);
      // out (odd, even): (0, 1) at (a+1, b), (2, 1) at (a, b)
      load8(wc + 1 * TS, wv);
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[2][c] = fmaf(a10, wv[c], acc[2][c]);
      load8(wc + 7 * TS, wv);
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[2][c] = fmaf(a00, wv[c], acc[2][c]);
      // out (odd, odd): (0, 0) at (a+1, b+1), (0, 2) at (a+1, b),
      // (2, 0) at (a, b+1), (2, 2) at (a, b)
      load8(wc + 0 * TS, wv);
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[3][c] = fmaf(a11, wv[c], acc[3][c]);
      load8(wc + 2 * TS, wv);
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[3][c] = fmaf(a10, wv[c], acc[3][c]);
      load8(wc + 6 * TS, wv);
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[3][c] = fmaf(a01, wv[c], acc[3][c]);
      load8(wc + 8 * TS, wv);
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[3][c] = fmaf(a00, wv[c], acc[3][c]);
    }
    epi(2 * a, 2 * b, co0, acc[0]);
    epi(2 * a, 2 * b + 1, co0, acc[1]);
    epi(2 * a + 1, 2 * b, co0, acc[2]);
    epi(2 * a + 1, 2 * b + 1, co0, acc[3]);
  }
}

// Stride-1 adjoint: output (oy, ox) of the OH x OW tile sums
// in[(oy + OFF - dy, ox + OFF - dx)][ci] w^T[dy][dx][ci][co].
template <typename T, int CIN, int COUT, int KS, int OFF, int PT, class Epi>
__device__ void convt_s1(const T* __restrict__ in, int IW, int OH, int OW,
                         const T* __restrict__ w, const Epi& epi) {
  constexpr int NCG = COUT / CT;
  constexpr int NPG = NT / NCG;
  static_assert(COUT % CT == 0 && NT % NCG == 0, "thread mapping");
  const int cg = threadIdx.x % NCG;
  const int npos = OH * OW;
  const int co0 = cg * CT;
  for (int p0 = (threadIdx.x / NCG) * PT; p0 < npos; p0 += NPG * PT) {
    float acc[PT][CT];
    int base[PT];
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int p = min(p0 + i, npos - 1);
      const int oy = p / OW, ox = p - oy * OW;
      base[i] = ((oy + OFF) * IW + ox + OFF) * CIN;
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[i][c] = 0.f;
    }
    for (int dy = 0; dy < KS; ++dy) {
      for (int dx = 0; dx < KS; ++dx) {
        const T* wp = w + (dy * KS + dx) * CIN * COUT + co0;
        const int toff = -(dy * IW + dx) * CIN;
#pragma unroll 4
        for (int ci = 0; ci < CIN; ++ci) {
          float wv[CT];
          load8(wp + ci * COUT, wv);
#pragma unroll
          for (int i = 0; i < PT; ++i) {
            const float v = to_f(in[base[i] + toff + ci]);
#pragma unroll
            for (int c = 0; c < CT; ++c) acc[i][c] = fmaf(v, wv[c], acc[i][c]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int p = p0 + i;
      if (p >= npos) break;
      const int oy = p / OW;
      epi(oy, p - oy * OW, co0, acc[i]);
    }
  }
}


__device__ __forceinline__ float gate(int8_t m) { return m ? 1.f : LEAKY; }

// ---------------------------------------------------------------------------
// The stem's input-cotangent chain on CUDA-core FMAs (float32 K2, K5; the
// batch-on-lanes backward past gs4): the JAX package's _grad_chain.
// With m(v) = 1 if v > 0 else 0.1 and T the rounding to the compute dtype,
//   gp5 = T(g5 m(y5))
//   gs4 = T(conv5^T gp5)                  (stride 2, 128 -> 64)
//   gp3 = T(gs4 m3)
//   gp2 = T(conv3^T(gp3) m2)
//   gp1 = T((conv2^T(gp2) + gs4) m1)      (the shortcut's two paths)
//   gp0 = T(conv1^T(gp1) m0)              (stride 2, 64 -> 32)
//   gx  = T(conv0^T gp0)                  (32 -> 3, padded to 8)
// with float32 accumulation; every cotangent at a row or column outside
// the image is zero. Each block owns a TX x TX tile of gx and works
// backwards over its receptive field in shared memory (gp5 8^2x128 ->
// gs4/gp3 14^2x64 -> gp2/gp1 11^2 -> gp0 20^2x32 -> gx 16^2). The gates
// m0..m3 come from a mask reader: the saved planar int8 masks (K2) or the
// signs K5 recomputed into shared memory.
// ---------------------------------------------------------------------------

struct Chain {
  static constexpr int TX = 16;  // gx tile side
  static constexpr int N5 = 8;   // gp5 tile side
  static constexpr int N4 = 14;  // gs4 / gp3 tile side (7 x 7 super positions)
  static constexpr int N1 = 11;  // gp2 / gp1 tile side
  static constexpr int N0 = 20;  // gp0 tile side (10 x 10 super positions)
  static constexpr int SZ_X = N4 * N4 * 64;
  static constexpr int SZ_Y = N4 * N4 * 64;
  static constexpr int SZ_Z = N0 * N0 * 32;
  static constexpr int ELEMS = SZ_X + SZ_Y + SZ_Z;  // shared elements of T
};
static_assert(Chain::N5 * Chain::N5 * 128 <= Chain::SZ_Z &&
                  Chain::N1 * Chain::N1 * 32 <= Chain::SZ_Z &&
                  Chain::N1 * Chain::N1 * 64 <= Chain::SZ_Y,
              "shared-memory regions");

// A gate's sign from a planar int8 mask [img, C, wl] of one image, at image
// position (gr, gc); PHASE: y0's even/odd column phases m / mo
template <int C, bool PHASE>
struct PlanarMask {
  const int8_t* m;
  const int8_t* mo;
  int wl;
  __device__ int8_t operator()(int, int, int gr, int gc, int ch) const {
    const int8_t* mp = (PHASE && (gc & 1)) ? mo : m;
    const int lane = PHASE ? (gc >> 1) + 1 : gc + 1;
    return mp[((long long)gr * C + ch) * wl + lane];
  }
};

// A gate's sign from a [pos][C] byte tile in shared memory of side TW, whose
// position (off, off) is the epilogue's tile position (0, 0)
template <int C>
struct TileMask {
  const unsigned char* s;
  int TW, off;
  __device__ int8_t operator()(int oy, int ox, int, int, int ch) const {
    return s[((oy + off) * TW + ox + off) * C + ch];
  }
};

// A gate's sign from a saved activation of one image in the batch-on-lanes
// layout [img, C, pitch] (the image's segment starting at lane lb; column
// c at lane lb + c + 1), at image position (gr, gc); PHASE: y0's even/odd
// column phases a / ao. 1 where the stored value is > 0.
template <typename T, int C, bool PHASE>
struct ActMask {
  const T* a;
  const T* ao;
  long long pitch, lb;
  __device__ int8_t operator()(int, int, int gr, int gc, int ch) const {
    const T* ap = (PHASE && (gc & 1)) ? ao : a;
    const int lane = PHASE ? (gc >> 1) + 1 : gc + 1;
    return to_f(ap[((long long)gr * C + ch) * pitch + lb + lane]) > 0.f;
  }
};

// gs4 = T(v) and gp3 = T(gs4 m3), zero outside the image
template <typename T, class M>
struct EpiGs4 {
  T* gs4;
  T* gp3;
  M m3;
  int org_r, org_c, img;
  __device__ void operator()(int oy, int ox, int co0, const float* v) const {
    const int gr = org_r + oy, gc = org_c + ox;
    const bool in = gr >= 0 && gr < img && gc >= 0 && gc < img;
    const int o = (oy * Chain::N4 + ox) * 64 + co0;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      float g = 0.f, p = 0.f;
      if (in) {
        g = round_t<T>(v[c]);
        p = g * gate(m3(oy, ox, gr, gc, co0 + c));
      }
      gs4[o + c] = from_f<T>(g);
      gp3[o + c] = from_f<T>(p);
    }
  }
};

// out = T((v [+ res]) m), zero outside the image
template <typename T, int C, bool RES, class M>
struct EpiGate {
  T* out;
  int OW;
  M m;
  int org_r, org_c, img;
  const T* res;  // RES: [pos][C] with pitch N4, read at (oy+1, ox+1)
  __device__ void operator()(int oy, int ox, int co0, const float* v) const {
    const int gr = org_r + oy, gc = org_c + ox;
    const bool in = gr >= 0 && gr < img && gc >= 0 && gc < img;
    const int o = (oy * OW + ox) * C + co0;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      float y = 0.f;
      if (in) {
        float s = v[c];
        if (RES) s += to_f(res[((oy + 1) * Chain::N4 + ox + 1) * C + co0 + c]);
        y = s * gate(m(oy, ox, gr, gc, co0 + c));
      }
      out[o + c] = from_f<T>(y);
    }
  }
};

// gx = T(v), 8 channels, into the even/odd column phases
template <typename T>
struct EpiGx {
  T* gxe;  // this image's [H, 8, wl]
  T* gxo;
  int org_r, org_c, wl;
  __device__ void operator()(int oy, int ox, int co0, const float* v) const {
    const int gr = org_r + oy, gc = org_c + ox;
    T* d = (gc & 1) ? gxo : gxe;
    const long long o = (long long)gr * 8 * wl + (gc >> 1) + 1;
#pragma unroll
    for (int c = 0; c < CT; ++c) d[o + (long long)c * wl] = from_f<T>(v[c]);
  }
};

// The chain past gs4 for the block's gx tile (blockIdx.y, blockIdx.x): from
// gs4 (X) and gp3 (Y), N4^2 x 64 at origin (R0/2 - 2, C0/2 - 2), to gp2 (Z),
// gp1 (Y), gp0 (Z) and gx, each gx value handed to epi_gx. Shared by K2, K5
// (through grad_chain) and the batch-on-lanes backward, whose gs4 stage
// differs.
template <typename T, class M0, class M1, class M2, class EpiX>
__device__ __forceinline__ void chain_tail(
    T* X, T* Y, T* Z, const T* __restrict__ v0, const T* __restrict__ v1,
    const T* __restrict__ v2, const T* __restrict__ v3, const M0& m0,
    const M1& m1, const M2& m2, int H, const EpiX& epi_gx) {
  using K = Chain;
  const int R0 = blockIdx.y * K::TX, C0 = blockIdx.x * K::TX;
  const int H1 = H / 2;
  const int o1r = R0 / 2 - 1, o1c = C0 / 2 - 1;  // gp2 / gp1, N1
  const int o0r = R0 - 2, o0c = C0 - 2;          // gp0, N0
  // gp2 (Z) from gp3 (Y)
  convt_s1<T, 64, 32, 3, 2, 2>(
      Y, K::N4, K::N1, K::N1, v3,
      EpiGate<T, 32, false, M2>{Z, K::N1, m2, o1r, o1c, H1, nullptr});
  __syncthreads();
  // gp1 (Y) from gp2 (Z) and gs4 (X)
  convt_s1<T, 32, 64, 1, 0, 4>(
      Z, K::N1, K::N1, K::N1, v2,
      EpiGate<T, 64, true, M1>{Y, K::N1, m1, o1r, o1c, H1, X});
  __syncthreads();
  // gp0 (Z) from gp1 (Y)
  convt_s2<T, 64, 32>(Y, K::N1, K::N0 / 2, v1,
                      EpiGate<T, 32, false, M0>{Z, K::N0, m0, o0r, o0c, H,
                                                nullptr});
  __syncthreads();
  // gx from gp0 (Z)
  convt_s1<T, 32, 8, 3, 3, 1>(Z, K::N0, K::TX, K::TX, v0, epi_gx);
}

// The whole chain for the block's gx tile (blockIdx.y, blockIdx.x) of image
// blockIdx.z: sm holds Chain::ELEMS elements of T (three regions: gs4; gp3
// then gp1; gp5 then gp2 then gp0); y5 and g5 planar [B, H/4, 128, wl5];
// v0..v5 the swapped-channel weights; gxe, gxo planar [B, H, 8, wlh], every
// lane of the tile's rows written (borders and padding zero). The mask
// readers m0 (y0), m1 (y1), m2 (y2), m3 (y3) index this image.
template <typename T, class M0, class M1, class M2, class M3>
__device__ void grad_chain(T* sm, const T* __restrict__ y5,
                           const T* __restrict__ g5, const T* __restrict__ v0,
                           const T* __restrict__ v1, const T* __restrict__ v2,
                           const T* __restrict__ v3, const T* __restrict__ v5,
                           T* __restrict__ gxe, T* __restrict__ gxo,
                           const M0& m0, const M1& m1, const M2& m2,
                           const M3& m3, int H, int wlh, int wl5) {
  using K = Chain;
  T* X = sm;           // gs4
  T* Y = X + K::SZ_X;  // gp3, then gp1
  T* Z = Y + K::SZ_Y;  // gp5, then gp2, then gp0
  const int b = blockIdx.z;
  const int R0 = blockIdx.y * K::TX, C0 = blockIdx.x * K::TX;
  const int H1 = H / 2, H5 = H / 4;
  // tile origins in image coordinates (rows; columns alike)
  const int o5r = R0 / 4 - 1, o5c = C0 / 4 - 1;  // gp5, N5
  const int o4r = R0 / 2 - 2, o4c = C0 / 2 - 2;  // gs4 / gp3, N4

  // gp5 = T(g5 m(y5)), lanes fastest
  for (int idx = threadIdx.x; idx < K::N5 * K::N5 * 128; idx += NT) {
    const int k = idx % K::N5;
    const int rest = idx / K::N5;
    const int co = rest % 128, r = rest / 128;
    const int gr = o5r + r, gc = o5c + k;
    float v = 0.f;
    if (gr >= 0 && gr < H5 && gc >= 0 && gc < H5) {
      const long long o = (((long long)b * H5 + gr) * 128 + co) * wl5 + gc + 1;
      const float y = to_f(y5[o]);
      v = to_f(g5[o]) * (y > 0.f ? 1.f : LEAKY);
    }
    Z[(r * K::N5 + k) * 128 + co] = from_f<T>(v);
  }
  __syncthreads();
  // gs4 (X) and gp3 (Y) from gp5 (Z)
  convt_s2<T, 128, 64>(Z, K::N5, K::N4 / 2, v5,
                       EpiGs4<T, M3>{X, Y, m3, o4r, o4c, H1});
  __syncthreads();
  const long long gb = (long long)b * H * 8 * wlh;
  chain_tail<T>(X, Y, Z, v0, v1, v2, v3, m0, m1, m2, H,
                EpiGx<T>{gxe + gb, gxo + gb, R0, C0, wlh});
  // zero border and padding lanes of this tile's rows in both phases:
  // lane 0 (first tile column), lanes H/2+1 .. wlh-1 (last tile column)
  const bool first = blockIdx.x == 0, last = blockIdx.x == gridDim.x - 1;
  if (first || last) {
    const int nr = last ? wlh - H1 - 1 : 0;
    const int n = nr + (first ? 1 : 0);
    for (int idx = threadIdx.x; idx < 2 * K::TX * 8 * n; idx += NT) {
      const int k = idx % n;
      int rest = idx / n;
      const int c = rest % 8;
      rest /= 8;
      const int r = rest % K::TX, ph = rest / K::TX;
      const int lane = k < nr ? H1 + 1 + k : 0;
      (ph ? gxo : gxe)[gb + ((long long)(R0 + r) * 8 + c) * wlh + lane] =
          from_f<T>(0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core implicit GEMMs: shared pieces
// ---------------------------------------------------------------------------
// A conv (or an adjoint) between shared-memory tiles laid out [pos][pitch]
// is the product D[m][n] = sum_i sum_k A_i[m][k] B_i[k][n]: m an output
// position of the tile, n an output channel, i a tap, k an input channel.
// wg::conv below runs it on wgmma; what it shares with the mma.sync form of
// the same step (kept for the k16 step's bit check, stem_fused.cu:
// wgmma_bitcheck_kernel) is here: the A fragments by ldmatrix, each lane
// giving the address of its own position's row (so a stride-2 gather needs
// no im2col buffer), the forward convs' epilogue (EpiConv) and the row maps
// (Rows*). Each result pair (channels n, n+1 of one position) goes to the
// epilogue as epi(oy, ox, n, v0, v1).

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// the same from a shared address, transposed (each 8 x 8 matrix's rows are
// its columns' values: K4's and K6's box transposes), and its store
// counterpart (stmatrix)
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void stsm4(uint32_t a, const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(a),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// two channels (n even) rounded to bfloat16, one 4-byte store
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The tensor-core forward convs' epilogue (K1's, and the batch-on-lanes
// forward's), conv_stage's per element: y = acc + bias, T(leaky); with SG
// the sign byte of T(leaky) (before the shortcut); with RES
// T(T(leaky) + res) (res [pos][RP] of row width res_w, read at
// (oy+1, ox+1)); zero outside [0, img)^2; out [pos][OP] of row width OW.
template <int OP, bool SG, bool RES, int RP = 1>
struct EpiConv {
  bf16* out;
  int OW;
  const float* bias;
  int org_r, org_c, img;
  const bf16* res;
  int res_w;
  unsigned char* sg;  // [pos][64] (conv3)
  __device__ void operator()(int oy, int ox, int n, float v0,
                             float v1) const {
    const int gr = org_r + oy, gc = org_c + ox;
    const bool inside = gr >= 0 && gr < img && gc >= 0 && gc < img;
    const int p = oy * OW + ox;
    const float v[2] = {v0, v1};
    float r[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float y = v[c] + bias[n + c];
      float yt = round_t<bf16>(fmaxf(y, y * LEAKY));
      if (SG) sg[p * 64 + n + c] = yt > 0.f ? 1 : 0;
      if (RES)
        yt = round_t<bf16>(
            yt + to_f(res[((oy + 1) * res_w + ox + 1) * RP + n + c]));
      r[c] = inside ? yt : 0.f;
    }
    store2(out + p * OP + n, r[0], r[1]);
  }
};

// Row maps of a GEMM: for output row m, the input position its tap i
// reads (and the tap's index in the weights), and the output position.
// A forward conv: output (oy, ox) of an OW-wide tile reads the input of row
// width IW at (S oy + ky, S ox + kx).
template <int KS, int S>
struct RowsConv {
  static constexpr int NTAP = KS * KS;
  int OW, IW;
  __device__ int operator()(int m, int i, int& tap) const {
    const int oy = m / OW, ox = m - oy * OW;
    const int ky = i / KS, kx = i - ky * KS;
    tap = i;
    return (S * oy + ky) * IW + S * ox + kx;
  }
  __device__ void out(int m, int& oy, int& ox) const {
    oy = m / OW;
    ox = m - oy * OW;
  }
};

// The batch-on-lanes stem's conv5: row stride 2, column stride 1, so
// output (oy, ox) reads (2 oy + ky, ox + kx); RowsConv<KS, 2>'s taps in its
// order
template <int KS>
struct RowsConv21 {
  static constexpr int NTAP = KS * KS;
  int OW, IW;
  __device__ int operator()(int m, int i, int& tap) const {
    const int oy = m / OW, ox = m - oy * OW;
    const int ky = i / KS, kx = i - ky * KS;
    tap = i;
    return (2 * oy + ky) * IW + ox + kx;
  }
  __device__ void out(int m, int& oy, int& ox) const {
    oy = m / OW;
    ox = m - oy * OW;
  }
};

// The stem's conv0 (3x3, 3 channels padded to 8) over an input of one
// 16-byte row a position: each 16-deep step pairs the taps kx = 2 pair and
// 2 pair + 1 of row ky (lanes 16-31, the upper 8 of k, read the next
// position; tap kx = 3 has zero weights), 6 steps for the 9 taps.
struct RowsConv0 {
  static constexpr int NTAP = 6;
  int OW, IW;
  __device__ int operator()(int m, int i, int& tap) const {
    const int oy = m / OW, ox = m - oy * OW;
    tap = i;
    return (oy + (i >> 1)) * IW + ox + 2 * (i & 1);
  }
  __device__ void out(int m, int& oy, int& ox) const {
    oy = m / OW;
    ox = m - oy * OW;
  }
};

// A stride-1 adjoint (convt_s1's): (oy, ox) reads (oy + OFF - dy,
// ox + OFF - dx) with the forward tap (dy, dx).
template <int KS, int OFF>
struct RowsT1 {
  static constexpr int NTAP = KS * KS;
  int OW, IW;
  __device__ int operator()(int m, int i, int& tap) const {
    const int oy = m / OW, ox = m - oy * OW;
    const int dy = i / KS, dx = i - dy * KS;
    tap = i;
    return (oy + OFF - dy) * IW + ox + OFF - dx;
  }
  __device__ void out(int m, int& oy, int& ox) const {
    oy = m / OW;
    ox = m - oy * OW;
  }
};

// One output parity (PY, PX) of a stride-2 adjoint (convt_s2's): super
// position (a, b) of an NS-wide grid yields output (2a + PY, 2b + PX); an
// even row takes tap dy = 1 at input row a, an odd one dy = 0 at a + 1 and
// dy = 2 at a (columns alike), so the parities have 1, 2, 2 and 4 taps.
template <int PY, int PX>
struct RowsT2 {
  static constexpr int NX = PX + 1;
  static constexpr int NTAP = (PY + 1) * NX;
  int NS, IW;
  __device__ int operator()(int m, int i, int& tap) const {
    const int a = m / NS, b = m - a * NS;
    const int iy = i / NX, ix = i - iy * NX;
    const int dy = PY ? 2 * iy : 1, ey = PY ? 1 - iy : 0;
    const int dx = PX ? 2 * ix : 1, ex = PX ? 1 - ix : 0;
    tap = dy * 3 + dx;
    return (a + ey) * IW + b + ex;
  }
  __device__ void out(int m, int& oy, int& ox) const {
    const int a = m / NS;
    oy = 2 * a + PY;
    ox = 2 * (m - a * NS) + PX;
  }
};

// ---------------------------------------------------------------------------
// The bfloat16 input-cotangent chain's regions and epilogues (K2, K5, K8b)
// ---------------------------------------------------------------------------
// grad_chain's regions and tile origins for the chain on the tensor cores
// (wgc below), with epilogues that keep the FMA chain's rounding points.
// The gates come from mask readers m(oy, ox, gr, gc, ch): K2's mask
// windows, K5's recomputed sign bits, K8b's windows of the signs of its
// saved activations. Row pitches of the tiles an ldmatrix reads are padded
// by 16 bytes (gp5 136, gp3/gp1 72, gp2 40) but gp0's (32: two-way
// conflicts), which keeps the regions at 69,312 bytes.

namespace bwd_tc {

using K = Chain;
constexpr int P5 = 128 + 8;  // gp5 pitch
constexpr int P4 = 64 + 8;   // gp3 / gp1 pitch
constexpr int P2 = 32 + 8;   // gp2 pitch
constexpr int P0 = 32;       // gp0 pitch
// X: gs4 over the N1^2 window the shortcut reads (tile rows/cols 1..N1)
constexpr int SZ_X = K::N1 * K::N1 * 64;
constexpr int SZ_Y = K::N4 * K::N4 * P4;  // gp3, then gp1
constexpr int SZ_Z = K::N0 * K::N0 * P0;  // gp5, then gp2, then gp0
constexpr int ELEMS = SZ_X + SZ_Y + SZ_Z;  // bfloat16 elements, 69,312 B
static_assert(K::N5 * K::N5 * P5 <= SZ_Z && K::N1 * K::N1 * P2 <= SZ_Z &&
                  K::N1 * K::N1 * P4 <= SZ_Y,
              "shared-memory regions");

// gs4 = T(v) into the shortcut's window, gp3 = T(gs4 m3); zero outside the
// image
template <class M>
struct EpiGs4 {
  bf16* gs4;  // [N1^2][64], tile positions (1..N1)^2
  bf16* gp3;  // [N4^2][P4]
  M m3;
  int org_r, org_c, img;
  __device__ void operator()(int oy, int ox, int n, float v0,
                             float v1) const {
    const int gr = org_r + oy, gc = org_c + ox;
    const bool in = gr >= 0 && gr < img && gc >= 0 && gc < img;
    const float v[2] = {v0, v1};
    float g[2] = {0.f, 0.f}, p[2] = {0.f, 0.f};
    if (in) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        g[c] = round_t<bf16>(v[c]);
        p[c] = g[c] * gate(m3(oy, ox, gr, gc, n + c));
      }
    }
    store2(gp3 + (oy * K::N4 + ox) * P4 + n, p[0], p[1]);
    if (oy >= 1 && oy <= K::N1 && ox >= 1 && ox <= K::N1)
      store2(gs4 + ((oy - 1) * K::N1 + ox - 1) * 64 + n, g[0], g[1]);
  }
};

// out = T((v [+ gs4]) m) into [pos][OP] of row width OW; zero outside the
// image
template <int OP, bool RES, class M>
struct EpiGate {
  bf16* out;
  int OW;
  M m;
  int org_r, org_c, img;
  const bf16* gs4;  // RES: the [N1^2][64] window, at (oy, ox)
  __device__ void operator()(int oy, int ox, int n, float v0,
                             float v1) const {
    const int gr = org_r + oy, gc = org_c + ox;
    const bool in = gr >= 0 && gr < img && gc >= 0 && gc < img;
    const float v[2] = {v0, v1};
    float y[2] = {0.f, 0.f};
    if (in) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float s = v[c];
        if (RES) s += to_f(gs4[(oy * K::N1 + ox) * 64 + n + c]);
        y[c] = s * gate(m(oy, ox, gr, gc, n + c));
      }
    }
    store2(out + (oy * OW + ox) * OP + n, y[0], y[1]);
  }
};

// K2's and K5's gx: T(v), channels n and n + 1, into the even/odd column
// phases of one image, planar [H, 8, wl]; then, for the block's tile
// (org_r, org_c), the zero border and padding lanes of its rows
struct EpiGx {
  bf16* gxe;  // this image's [H, 8, wl]
  bf16* gxo;
  int org_r, org_c, wl, H;
  __device__ void operator()(int oy, int ox, int n, float v0,
                             float v1) const {
    const int gr = org_r + oy, gc = org_c + ox;
    bf16* d = ((gc & 1) ? gxo : gxe) + (long long)gr * 8 * wl + (gc >> 1) +
              1 + (long long)n * wl;
    d[0] = __float2bfloat16_rn(v0);
    d[wl] = __float2bfloat16_rn(v1);
  }
  // both phases: lane 0 (first tile column), lanes H/2+1 .. wl-1 (last
  // tile column)
  __device__ void zero_borders() const {
    const long long r0 = (long long)org_r * 8 * wl;
    if (blockIdx.x == 0)
      for (int idx = threadIdx.x; idx < 2 * K::TX * 8; idx += NT)
        ((idx & 1) ? gxo : gxe)[r0 + (long long)(idx >> 1) * wl] =
            __float2bfloat16_rn(0.f);
    if (blockIdx.x == gridDim.x - 1) {
      zero_tail(gxe + r0, K::TX * 8, H / 2 + 1, wl, NT);
      zero_tail(gxo + r0, K::TX * 8, H / 2 + 1, wl, NT);
    }
  }
};

}  // namespace bwd_tc

// ---------------------------------------------------------------------------
// Hopper's own units (bfloat16 K1, K2, K5, K8a, K8b, K4, K6): wgmma, bulk
// copies, TMA
// ---------------------------------------------------------------------------
// A conv (or adjoint) stage is the implicit GEMM above, run by warpgroups:
// wgmma.mma_async.m64nNk16 (bfloat16 in, float32 accumulate) with A from
// registers, loaded by ldmatrix from the [pos][pitch] activation tile
// (each lane the address of its own position's row: tap shifts and
// stride-2 gathers stay address arithmetic), and B from shared memory.
// Each warpgroup item is MT blocks of 64 rows x N/NG channels; per 16-deep
// step its warps load their 16 rows of each block and the warpgroup issues
// MT wgmmas on one descriptor. The step order is the mma.sync kernels' that
// these replaced (taps outer, 16-channel steps inner, one float32
// accumulator an output starting from zero, bias and leaky in the
// epilogue), so a result differs from theirs only if a wgmma k16 step
// rounds otherwise than an mma.sync one (tested on the card:
// tests/test_torch_gpu.py, chip_smoke.py phase 5).
//
// The weights are packed on the host (ops/stem_fused.py: wg_weights) per
// GEMM as [chunk][N][64] bfloat16: the GEMM's depth (taps x K, in step
// order) cut into 64-deep chunks (the last zero-padded), each row n of a
// chunk 128 bytes of k, its eight 16-byte units swizzled as the
// descriptor's 128-byte swizzle reads them: (k, n) of chunk c at byte
//   n * 128 + (((k % 64) / 8) ^ (n % 8)) * 16 + (k % 8) * 2.
// A GEMM's packed weights reach shared memory by cp.async.bulk (UBLKCP)
// into a ring of slots, issued by a producer warp beside the consumer
// warpgroups and guarded by mbarriers (full: the copy landed; empty: all
// consumer warps' wgmmas that read it completed); a slot holds several
// small chunks, or a large chunk spans several slots (each warpgroup's
// channel group in one). The producer walks the same GEMM list as the
// consumers: a GEMM whose passes over the tile all fit the ring is loaded
// once and read by every pass (resident), another is streamed again each
// pass. A block's registers are allotted by warpgroup, so the producer
// warp's group holds as many as a consumer's (168 a thread for three).

namespace wg {

constexpr int NC = 256;       // consumer threads: two warpgroups
constexpr int NTH = NC + 32;  // and the producer warp
constexpr int CONSUMER_WARPS = NC / 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// Wait for the completion of the barrier's phase of the given parity: a
// polling loop inside one asm block. No exit but completion: a bounded
// wait that traps, or a branch of the program's own, gives ptxas a
// divergent path around which it serializes the in-flight wgmmas.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// the barriers' initialisation made visible to the async proxy
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// bytes (a multiple of 16) device -> shared memory by one bulk copy,
// completing on bar (cp.async.bulk: SASS UBLKCP)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// one box of a 4-d tensor map (innermost coordinate first) into shared
// memory, completing on bar (cp.async.bulk.tensor: SASS UTMALDG); positions
// outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// cuTensorMapEncodeTiled from the driver (looked up at run time: the
// libraries link no driver stub)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiled>(
                   dlsym(h, "cuTensorMapEncodeTiled"))
             : nullptr;
  }();
  return fn;
}

// The tensor map of a planar [B, rows, C, wl] tensor (int8, or bfloat16
// with bf16) with boxes of bw lanes x bc channels (0: all C) x br rows of
// one image; positions outside the tensor arrive as zeros. rstep: the
// tensor's rows lie rstep rows of C x wl apart (K8b's gp5dd: its even
// rows). Returns 0, or an error code past the runtime's (1000 +
// cuTensorMapEncodeTiled's).
inline int planar_map(CUtensorMap* m, const void* p, bool bf16, int B,
                      int rows, int C, int wl, int bw, int br, int bc = 0,
                      int rstep = 1) {
  EncodeTiled f = encoder();
  if (f == nullptr) return 999;
  const cuuint64_t es = bf16 ? 2 : 1;
  const cuuint64_t dims[4] = {(cuuint64_t)wl, (cuuint64_t)C,
                              (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)rstep * C * wl * es;
  const cuuint64_t strides[3] = {wl * es, row, rows * row};
  const cuuint32_t box[4] = {(cuuint32_t)bw, (cuuint32_t)(bc ? bc : C),
                             (cuuint32_t)br, 1};
  const cuuint32_t el[4] = {1, 1, 1, 1};
  const CUresult r = f(
      m,
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      4, const_cast<void*>(p), dims, strides, box, el,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

// the consumers' own barrier (named barrier 1; the producer warp never
// joins it)
__device__ __forceinline__ void sync_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The descriptor of a K-major B of 8-row groups 1024 bytes apart, rows of
// 128 bytes with the 128-byte swizzle, starting at shared address a (a
// chunk's row 0 plus 32 bytes a 16-deep step: the swizzle is applied to
// the address bits, so chunks are 1024-byte aligned)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t a) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D[64 x N] += A[64 x 16] B[16 x N]: A from registers (each warp of the
// warpgroup its 16 rows, mma.m16n8k16's A fragment), B by descriptor, d as
// m16n8's accumulators repeated over N / 8
template <int N>
__device__ __forceinline__ void mma_async(float (&d)[N / 2],
                                          const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void mma_async<8>(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_async<32>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_async<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_async<16>(float (&d)[8],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// One GEMM of a kernel's list: NTAP taps of depth KT (a multiple of 16),
// N output channels in NG groups, M rows in items of MT 64-row blocks (an
// odd item count padded by an item of rows past M, computed and dropped),
// each of the two consumer warpgroups one item a pass. Its
// packed weights stream through a ring of STAGES slots of SLOT bytes
// (powers of two times 1 KB): CPS chunks a slot, or a chunk over SPC slots
// (each channel group's part in one). Where a GEMM of several passes fits
// the ring (RES), the producer loads it once and every pass reads the same
// slots; otherwise each pass streams it again. CALLS: the conv calls that
// run it on other tiles of rows with the same weights (K5's recompute runs
// conv0 and conv1 once a y0 chunk); their passes count as its own, so such
// a GEMM must be resident. GS: the 16-deep steps of one wgmma group (4, a
// chunk's; 2 or 1 for an item of many accumulators, whose A fragments are
// then loaded a group at a time: K6's items of 2 or 3 blocks x 64 channels).
template <int NTAP_, int KT_, int N_, int NG_, int MT_, int M_, int SLOT_,
          int STAGES_, int CALLS_ = 1, int GS_ = 4>
struct Gemm {
  static constexpr int NTAP = NTAP_, KT = KT_, N = N_, NG = NG_, MT = MT_,
                       M = M_, SLOT = SLOT_, CALLS = CALLS_, GS = GS_;
  static constexpr int NN = N / NG;           // channels an item
  static constexpr int NSTEP = NTAP * KT / 16;  // 16-deep steps
  static constexpr int NCH = (NSTEP + 3) / 4;   // 64-deep chunks
  static constexpr int NGRP = (NSTEP + GS - 1) / GS;  // wgmma groups
  static constexpr int CHUNK = N * 128;         // bytes a chunk
  static constexpr int ITEMS0 = ((M + 63) / 64 + MT - 1) / MT * NG;
  static constexpr int ITEMS = ITEMS0 + ITEMS0 % 2;
  static constexpr int NPASS = ITEMS / 2;
  static constexpr int BYTES = NCH * CHUNK;  // the packed weights
  static constexpr int CPS = CHUNK < SLOT ? SLOT / CHUNK : 1;
  static constexpr int SPC = CHUNK > SLOT ? CHUNK / SLOT : 1;
  static constexpr int NSL = (BYTES + SLOT - 1) / SLOT;  // slots a pass
  static constexpr bool RES = NPASS * CALLS > 1 && NSL <= STAGES_;
  static_assert(KT % 16 == 0 && N % 8 == 0 && NN % 8 == 0 && NN <= 64 &&
                    NN * 128 <= SLOT && CHUNK % SLOT * (SLOT % CHUNK) == 0,
                "wgmma tiling");
  static_assert(CALLS == 1 || RES, "a GEMM of several calls is resident");
  static_assert(GS == 1 || GS == 2 || GS == 4, "a group within a chunk");
  // chunk c's first slot (counted from the GEMM's first), and the slot and
  // byte offset of its channel group ng
  static __device__ int first_slot(int c) {
    return SPC > 1 ? c * SPC : c / CPS;
  }
  static __device__ int slot_of(int c, int ng) {
    return first_slot(c) + (SPC > 1 ? ng * NN * 128 / SLOT : 0);
  }
  static __device__ int offset_of(int c, int ng) {
    return SPC > 1 ? ng * NN * 128 % SLOT : (c % CPS) * CHUNK + ng * NN * 128;
  }
  // a chunk that opens new slots, and one whose completion frees slots
  static __device__ bool opens(int c) { return SPC > 1 || c % CPS == 0; }
  static __device__ bool closes(int c) {
    return SPC > 1 || c % CPS == CPS - 1 || c == NCH - 1;
  }
};

// The ring of weight stages: N slots of SB bytes (1024-aligned), a full and
// an empty barrier each; a role's position in it (slot, phase)
template <int N_, int SB_>
struct Ring {
  static constexpr int N = N_, SB = SB_;
  uint32_t slots, full, empty;  // shared addresses
  int slot, phase;
  __device__ void advance() {
    if (++slot == N) {
      slot = 0;
      phase ^= 1;
    }
  }
  // the position k slots ahead
  __device__ Ring ahead(int k) const {
    Ring q = *this;
    const int s = slot + k;
    q.slot = s % N;
    q.phase = phase ^ ((s / N) & 1);
    return q;
  }
  __device__ uint32_t at() const { return slots + slot * SB; }
  __device__ uint32_t full_bar() const { return full + 8 * slot; }
  __device__ uint32_t empty_bar(int s) const { return empty + 8 * s; }
};

// bytes a ring needs past its base: the alignment slack, slots, barriers
constexpr int ring_bytes(int n, int sb) { return 1024 + n * sb + 16 * n; }

// The ring at shared address base (rounded up to 1024 bytes): N slots of
// SB bytes, then the 2 N barriers; initialised by thread 0, visible to the
// whole block after the __syncthreads that must follow
template <int N, int SB>
__device__ __forceinline__ Ring<N, SB> make_ring(uint32_t base) {
  Ring<N, SB> r;
  r.slots = (base + 1023) & ~1023u;
  r.full = r.slots + N * SB;
  r.empty = r.full + 8 * N;
  r.slot = 0;
  r.phase = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < N; ++i) {
      mbar_init(r.full + 8 * i, 1);
      mbar_init(r.empty + 8 * i, CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  return r;
}

// The producer's part of GEMM G (one thread): its packed weights a slot at
// a time, each by one bulk copy once all consumer warps freed the slot;
// once (RES) or once a pass
template <class G, class R>
__device__ __forceinline__ void produce(R& r, const unsigned char* w) {
  for (int p = 0; p < (G::RES ? 1 : G::NPASS); ++p)
    for (int si = 0; si < G::NSL; ++si) {
      const int bytes = min(G::SLOT, G::BYTES - si * G::SLOT);
      mbar_wait(r.empty_bar(r.slot), r.phase ^ 1);
      mbar_expect_tx(r.full_bar(), bytes);
      bulk_load(r.at(), w + si * G::SLOT, bytes, r.full_bar());
      r.advance();
    }
}

// A consumer warp is done with slot s: its lane 0 arrives on the slot's
// empty barrier (the eight consumer warps free it together), by a
// predicated arrive, not a branch
template <class R>
__device__ __forceinline__ void release(const R& r, int s) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          r.empty_bar(s)),
      "r"(threadIdx.x & 31)
      : "memory");
}

// a consumer warp is done with what barrier bar guards: its lane 0 arrives
// (by a predicated arrive, not a branch)
__device__ __forceinline__ void arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(threadIdx.x & 31)
      : "memory");
}

// Cycle accounting of the wgmma kernels, compiled in only with
// -DAPFP_PROFILE (ops/_cuda.py: profiled builds such a copy, chip_smoke.py
// phase 5 reads it): thread 0 of each block adds the clock64 cycles since
// its previous lap to the category a lap names (by a predicated
// reduction, no branch). Otherwise every lap is empty.
enum Prof { P_LOAD, P_INPUT, P_WAIT, P_MMA, P_EPI, P_MASK, P_STORE, P_SYNC,
            PROF_N };
#ifdef APFP_PROFILE
__device__ unsigned long long prof_cycles[PROF_N];
struct Lap {
  long long t;
  __device__ Lap() { t = clock64(); }
  __device__ void operator()(int cat) {
    const long long n = clock64();
    asm volatile(
        "{\n.reg .pred p;\nsetp.eq.u32 p, %2, 0;\n"
        "@p red.global.add.u64 [%0], %1;\n}\n" ::"l"(&prof_cycles[cat]),
        "l"(n - t), "r"(threadIdx.x)
        : "memory");
    t = n;
  }
};
#else
struct Lap {
  __device__ void operator()(int) const {}
};
#endif

// An epilogue that takes a thread's values row by row (ROWS = true: K5's
// sign epilogue) rather than pair by pair
template <class E, class = void>
struct RowEpi {
  static constexpr bool value = false;
};
template <class E>
struct RowEpi<E, decltype(void(E::ROWS))> {
  static constexpr bool value = E::ROWS;
};

// An item of GEMM G for a consumer thread: its 64-row blocks' A rows at tap
// 0 (rows past M repeat the last; their sums are dropped; a tap shifts
// every row by the same offset), its channel group, and the epilogue of
// its accumulators
template <class G, int IP, class Rows>
struct Item {
  static constexpr int MT = G::MT, NN = G::NN, KS = G::KT / 16;
  const bf16* a0[MT];
  int mg, ng, d00;
  __device__ Item(const bf16* in, const Rows& rows, int p) {
    const int t = threadIdx.x;
    const int w = (t >> 5) & 3, lane = t & 31;
    const int it = 2 * p + (t >> 7);
    mg = it / G::NG;
    ng = it - mg * G::NG;
    int tap;
#pragma unroll
    for (int b = 0; b < MT; ++b) {
      const int m = min((mg * MT + b) * 64 + 16 * w + (lane & 15), G::M - 1);
      a0[b] = in + rows(m, 0, tap) * IP + (lane >> 4) * 8;
    }
    d00 = rows(0, 0, tap);
  }
  // the A fragments of wgmma group q's (up to) GS steps
  __device__ void load(uint32_t (&a)[G::GS][MT][4], const Rows& rows,
                       int q) const {
    int tap;
#pragma unroll
    for (int j = 0; j < G::GS; ++j) {
      const int s = G::GS * q + j;
      if (s < G::NSTEP) {
        const int d = (rows(0, s / KS, tap) - d00) * IP + (s % KS) * 16;
#pragma unroll
        for (int b = 0; b < MT; ++b) ldsm_x4(a[j][b], a0[b] + d);
      }
    }
  }
  // accumulator (b, e): row (mg MT + b) 64 + 16 w + lane/4 (+8 for
  // e % 4 >= 2), channels ng NN + 8 (e / 4) + 2 (lane % 4) (+1): the four
  // lanes of a quad hold a row's NN channels. A row epilogue
  // (RowEpi) gets each row whole, epi.row(valid, oy, ox, n0, acc[b], h),
  // from every lane (rows past M with valid false), so that a quad may
  // exchange values by shuffles
  template <class Epi>
  __device__ void epilogue(const float (&acc)[MT][NN / 2], const Rows& rows,
                           const Epi& epi) const {
    const int t = threadIdx.x;
    const int w = (t >> 5) & 3, lane = t & 31;
    const int g = lane >> 2, n0 = ng * NN + 2 * (lane & 3);
#pragma unroll
    for (int b = 0; b < MT; ++b)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (mg * MT + b) * 64 + 16 * w + g + 8 * h;
        int oy, ox;
        if constexpr (RowEpi<Epi>::value) {
          rows.out(min(m, G::M - 1), oy, ox);
          epi.template row<NN>(m < G::M, oy, ox, n0, acc[b], h);
        } else {
          if (m >= G::M) continue;
          rows.out(m, oy, ox);
#pragma unroll
          for (int j = 0; j < NN / 8; ++j)
            epi(oy, ox, n0 + 8 * j, acc[b][4 * j + 2 * h],
                acc[b][4 * j + 2 * h + 1]);
        }
      }
  }
};

// group q's wgmmas for one item: its (up to) GS steps x MT blocks on the
// descriptor of its channel group's part of their chunk, as one group
template <class G, class R>
__device__ __forceinline__ void issue(float (&acc)[G::MT][G::NN / 2],
                                      const uint32_t (&a)[G::GS][G::MT][4],
                                      const R& r, int q, int ng) {
  fence();
  const int c = G::GS * q / 4;
  const uint64_t desc =
      desc_sw128(r.ahead(G::slot_of(c, ng)).at() + G::offset_of(c, ng));
#pragma unroll
  for (int j = 0; j < G::GS; ++j) {
    const int s = G::GS * q + j;
    if (s < G::NSTEP)
#pragma unroll
      for (int b = 0; b < G::MT; ++b)
        mma_async<G::NN>(acc[b], a[j][b], desc + 2 * (s % 4));  // +32 B
  }
  commit();
}

// Wait for the slots chunk c opens (every warp waits for all of them: it
// frees them all)
template <class G, class R>
__device__ __forceinline__ void wait_chunk(const R& r, int c, Lap& lap) {
  if (!G::opens(c)) return;
  lap(P_MMA);
#pragma unroll
  for (int k = 0; k < G::SPC; ++k) {
    const R q = r.ahead(G::first_slot(c) + k);
    mbar_wait(q.full_bar(), q.phase);
  }
  lap(P_WAIT);
}

// The consumers' part of GEMM G over in [pos][IP] (bfloat16, rows of IP * 2
// bytes, a multiple of 16, 16-byte aligned), rows as the Rows maps map
// them; each result pair (channels n, n+1 of one position) to
// epi(oy, ox, n, v0, v1). Called by the consumer threads; passes unrolled
// (a loop around the divergent epilogue makes ptxas serialize the wgmmas).
// A group's steps (GS = 4: a chunk's) are one wgmma group; while it runs,
// the warpgroup loads the next group's A fragments (two register sets). A
// streamed GEMM's slots are freed as the group of their last chunk's last
// step completes; a resident one waits for its slots in the first pass of
// its first call (CALL 0) only and frees them after the last pass of its
// last. Each call advances r past the GEMM's slots: a later call of a GEMM
// of several calls takes a copy of the ring as it stood before the first.
template <class G, int IP, int CALL = 0, class R, class Rows, class Epi>
__device__ __forceinline__ void conv(R& r, const bf16* __restrict__ in,
                                     const Rows& rows, const Epi& epi,
                                     Lap& lap) {
  constexpr int MT = G::MT, NN = G::NN, GS = G::GS;
  static_assert(IP % 8 == 0 && Rows::NTAP == G::NTAP, "GEMM shape");
#pragma unroll
  for (int p = 0; p < G::NPASS; ++p) {
    const Item<G, IP, Rows> item(in, rows, p);
    float acc[MT][NN / 2];
#pragma unroll
    for (int b = 0; b < MT; ++b)
#pragma unroll
      for (int e = 0; e < NN / 2; ++e) acc[b][e] = 0.f;
    uint32_t a[2][GS][MT][4];  // group q's A fragments in set q & 1
    item.load(a[0], rows, 0);
#pragma unroll
    for (int q = 0; q < G::NGRP; ++q) {
      // group q opens chunk c where its first step is the chunk's first
      const int c = GS * q / 4;
      const bool opens = GS * q % 4 == 0;
      if (opens && (!G::RES || (p == 0 && CALL == 0)))
        wait_chunk<G>(r, c, lap);
      issue<G>(acc, a[q & 1], r, q, item.ng);
      if (q > 0) {
        wait<1>();  // group q - 1 has completed
        if (opens && !G::RES && G::closes(c - 1))
#pragma unroll
          for (int k = 0; k < G::SPC; ++k)
            release(r, r.ahead(G::first_slot(c - 1) + k).slot);
      }
      if (q + 1 < G::NGRP) item.load(a[(q + 1) & 1], rows, q + 1);
    }
    wait<0>();
    if (!G::RES) {
#pragma unroll
      for (int k = 0; k < G::SPC; ++k)
        release(r, r.ahead(G::first_slot(G::NCH - 1) + k).slot);
      r = r.ahead(G::NSL);
    }
    lap(P_MMA);
    item.epilogue(acc, rows, epi);
    lap(P_EPI);
  }
  if (G::RES) {
    if (CALL == G::CALLS - 1)
#pragma unroll
      for (int si = 0; si < G::NSL; ++si) release(r, r.ahead(si).slot);
    r = r.ahead(G::NSL);
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// K2's chain on wgmma, shared by K2 (stem_bwd.cu), K5 (stem_remat.cu) and
// K8b (stem_batched.cu)
// ---------------------------------------------------------------------------
// grad_chain's stages, regions (bwd_tc's X, Y, Z) and tile origins, the five
// adjoints as eleven wgmma GEMMs on the ring (conv5^T and conv1^T as four
// GEMMs, one per output parity, with K = 1, 2, 2 or 4 taps x CIN; conv0^T's
// N = 8 one m64n8k16), with bwd_tc's epilogues. The weights are
// wg_weights' packing of the swapped-channel adjoints (conv5^T's and
// conv1^T's per parity in RowsT2's tap order), streamed through a ring of
// six 8 KB slots (a conv5^T or conv2^T chunk, two conv3^T or conv1^T
// chunks, all of conv0^T's): 18 + 5 + 1 + 9 + 1 slot loads, 229 KB a tile.
// The kernels differ in where gp5 and the gates come from: K2 forms gp5
// from y5's and g5's boxes and reads its int8 mask windows; K5 the same
// gp5, its gates from the signs it recomputed; K8b reads gp5 from gp5dd's
// data positions and its gates from windows of its saved activations
// turned into sign bytes. A kernel hands chain() its gp5 formed in Z, its
// four mask readers, its gx epilogue and its gates' barriers (Gates:
// first() before conv5^T, whose epilogue reads y3's gates; second() before
// conv2^T, the first to read y1's, conv1^T y0's).

namespace wgc {

using K = Chain;
constexpr int STAGES = 6, SLOT = 8192;
// one parity (PY, PX) of a stride-2 adjoint as a GEMM over NS^2 super
// positions: taps, depth a tap, N, channel groups
template <int PY, int PX, int KT, int N, int NG, int NS>
using T2 =
    wg::Gemm<(PY + 1) * (PX + 1), KT, N, NG, 1, NS * NS, SLOT, STAGES>;
// the chain's GEMMs in order: conv5^T's parities, conv3^T, conv2^T,
// conv1^T's parities, conv0^T
using U5a = T2<0, 0, 128, 64, 2, K::N4 / 2>;
using U5b = T2<0, 1, 128, 64, 2, K::N4 / 2>;
using U5c = T2<1, 0, 128, 64, 2, K::N4 / 2>;
using U5d = T2<1, 1, 128, 64, 2, K::N4 / 2>;
using U3 = wg::Gemm<9, 64, 32, 1, 1, K::N1 * K::N1, SLOT, STAGES>;
using U2 = wg::Gemm<1, 32, 64, 1, 1, K::N1 * K::N1, SLOT, STAGES>;
using U1a = T2<0, 0, 64, 32, 1, K::N0 / 2>;
using U1b = T2<0, 1, 64, 32, 1, K::N0 / 2>;
using U1c = T2<1, 0, 64, 32, 1, K::N0 / 2>;
using U1d = T2<1, 1, 64, 32, 1, K::N0 / 2>;
using U0 = wg::Gemm<9, 32, 8, 1, 2, K::TX * K::TX, SLOT, STAGES>;
static_assert(!U5a::RES && !U5b::RES && !U5c::RES && !U5d::RES &&
                  !U3::RES && !U2::RES && !U1a::RES && !U1b::RES &&
                  !U1c::RES && !U1d::RES && !U0::RES,
              "every GEMM of the chain streams");

// The packed adjoint weights (wg_weights): conv0^T, conv1^T (its four
// parities' chunks back to back), conv2^T, conv3^T, conv5^T (the same)
struct Weights {
  const unsigned char* u[5];
};

// An int8 gate window's line: WL lanes (bytes) of one (row, channel, phase)
constexpr int WL = 32;

// A gate's sign from a window of sign bytes [ph][r][ch][WL] in shared
// memory (window row r at tile row oy = r, lanes from l0), at tile row oy
// and image column gc; PHASE: y0's column phases
template <int C, int R, bool PHASE>
struct BoxMask {
  const unsigned char* s;
  int l0;
  __device__ int8_t operator()(int oy, int, int, int gc, int ch) const {
    const int ph = PHASE ? (gc & 1) : 0;
    const int lane = PHASE ? (gc >> 1) + 1 : gc + 1;
    return s[((ph * R + oy) * C + ch) * WL + lane - l0];
  }
};

// gates that are in shared memory before the chain starts (K5's)
struct Ready {
  __device__ void first(wg::Lap&) const {}
  __device__ void second(wg::Lap&) const {}
};

// y5's and g5's boxes: WL5 lanes x 128 channels x N5 rows of a planar
// [B, H/4, 128, wl5] tensor, bfloat16 (K2, K5)
constexpr int WL5 = 16;
constexpr int Y5_B = K::N5 * 128 * WL5 * 2;  // bytes a box

// gp5 = T(g5 m(y5)) for the block's gx tile into Z [N5^2][P5] from y5's and
// g5's boxes (box lane 0 at image lane l5), zero outside the image (H5
// rows and columns): a consumer thread takes one (row, channel) line's N5
// columns, 4-byte reads of the boxes, 2-byte stores of neighbouring
// channels
__device__ __forceinline__ void gp5_from_boxes(bf16* __restrict__ Z,
                                               const bf16* __restrict__ yb,
                                               const bf16* __restrict__ gb,
                                               int o5r, int o5c, int l5,
                                               int H5) {
  const int k0 = o5c + 1 - l5;  // the box lane of tile column 0
  for (int idx = threadIdx.x; idx < K::N5 * 128; idx += wg::NC) {
    const int co = idx % 128, r = idx / 128;
    const int gr = o5r + r;
    const uint32_t* y4 =
        reinterpret_cast<const uint32_t*>(yb + idx * WL5 + k0);
    const uint32_t* g4 =
        reinterpret_cast<const uint32_t*>(gb + idx * WL5 + k0);
#pragma unroll
    for (int k2 = 0; k2 < K::N5 / 2; ++k2) {
      const uint32_t yv = y4[k2], gv = g4[k2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 2 * k2 + h, gc = o5c + k;
        const float y = __uint_as_float((h ? yv >> 16 : yv) << 16);
        const float g = __uint_as_float((h ? gv >> 16 : gv) << 16);
        float v = 0.f;
        if (gr >= 0 && gr < H5 && gc >= 0 && gc < H5)
          v = g * (y > 0.f ? 1.f : LEAKY);
        Z[(r * K::N5 + k) * bwd_tc::P5 + co] = __float2bfloat16_rn(v);
      }
    }
  }
}

// The producer's part (one thread): the chain's packed weights in the
// consumers' order, slot by slot; mid() runs between conv5^T's and
// conv3^T's (K2, K8b: once the consumers freed the region gp5 came from,
// the y0 and y1 windows into it)
template <class R, class Mid>
__device__ __forceinline__ void produce(R& ring, const Weights& ww,
                                        const Mid& mid) {
  const unsigned char* u5 = ww.u[4];
  wg::produce<U5a>(ring, u5);
  wg::produce<U5b>(ring, u5 + U5a::BYTES);
  wg::produce<U5c>(ring, u5 + U5a::BYTES + U5b::BYTES);
  wg::produce<U5d>(ring, u5 + U5a::BYTES + U5b::BYTES + U5c::BYTES);
  mid();
  wg::produce<U3>(ring, ww.u[3]);
  wg::produce<U2>(ring, ww.u[2]);
  const unsigned char* u1 = ww.u[1];
  wg::produce<U1a>(ring, u1);
  wg::produce<U1b>(ring, u1 + U1a::BYTES);
  wg::produce<U1c>(ring, u1 + U1a::BYTES + U1b::BYTES);
  wg::produce<U1d>(ring, u1 + U1a::BYTES + U1b::BYTES + U1c::BYTES);
  wg::produce<U0>(ring, ww.u[0]);
}

// The consumers' part, from gp5 (formed in Z of sm's regions, visible to
// all consumers) to gx for the block's gx tile (blockIdx.y, blockIdx.x):
// gs4 (X) and gp3 (Y) from gp5 (Z), gp2 (Z) from gp3, gp1 (Y) from gp2 and
// gs4, gp0 (Z) from gp1, then gx, each pair of gx channels to gx(oy, ox,
// n, v0, v1) and finally gx.zero_borders(). The mask readers m0 (y0), m1
// (y1), m2 (y2), m3 (y3) index this image.
template <class R, class M0, class M1, class M2, class M3, class Gx,
          class Gates>
__device__ __forceinline__ void chain(R& ring, unsigned char* sm,
                                      const M0& m0, const M1& m1,
                                      const M2& m2, const M3& m3,
                                      const Gx& gx, const Gates& gates,
                                      int H, wg::Lap& lap) {
  using bwd_tc::P0;
  using bwd_tc::P2;
  using bwd_tc::P4;
  using bwd_tc::P5;
  bf16* X = reinterpret_cast<bf16*>(sm);  // gs4 window
  bf16* Y = X + bwd_tc::SZ_X;             // gp3, then gp1
  bf16* Z = Y + bwd_tc::SZ_Y;             // gp5, then gp2, then gp0
  const int R0 = blockIdx.y * K::TX, C0 = blockIdx.x * K::TX;
  const int H1 = H / 2;
  // tile origins in image coordinates (rows; columns alike)
  const int o4r = R0 / 2 - 2, o4c = C0 / 2 - 2;  // gs4 / gp3, N4
  const int o1r = R0 / 2 - 1, o1c = C0 / 2 - 1;  // gp2 / gp1, N1
  const int o0r = R0 - 2, o0c = C0 - 2;          // gp0, N0
  gates.first(lap);
  // gs4 (X) and gp3 (Y) from gp5 (Z)
  {
    const bwd_tc::EpiGs4<M3> epi{X, Y, m3, o4r, o4c, H1};
    constexpr int NS = K::N4 / 2;
    wg::conv<U5a, P5>(ring, Z, RowsT2<0, 0>{NS, K::N5}, epi, lap);
    wg::conv<U5b, P5>(ring, Z, RowsT2<0, 1>{NS, K::N5}, epi, lap);
    wg::conv<U5c, P5>(ring, Z, RowsT2<1, 0>{NS, K::N5}, epi, lap);
    wg::conv<U5d, P5>(ring, Z, RowsT2<1, 1>{NS, K::N5}, epi, lap);
  }
  wg::sync_consumers();
  lap(wg::P_SYNC);
  // gp2 (Z) from gp3 (Y)
  wg::conv<U3, P4>(ring, Y, RowsT1<3, 2>{K::N1, K::N4},
                   bwd_tc::EpiGate<P2, false, M2>{Z, K::N1, m2, o1r, o1c,
                                                  H1, nullptr},
                   lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  gates.second(lap);
  // gp1 (Y) from gp2 (Z) and gs4 (X)
  wg::conv<U2, P2>(ring, Z, RowsT1<1, 0>{K::N1, K::N1},
                   bwd_tc::EpiGate<P4, true, M1>{Y, K::N1, m1, o1r, o1c, H1,
                                                 X},
                   lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  // gp0 (Z) from gp1 (Y)
  {
    const bwd_tc::EpiGate<P0, false, M0> epi{Z, K::N0, m0, o0r, o0c, H,
                                             nullptr};
    constexpr int NS = K::N0 / 2;
    wg::conv<U1a, P4>(ring, Y, RowsT2<0, 0>{NS, K::N1}, epi, lap);
    wg::conv<U1b, P4>(ring, Y, RowsT2<0, 1>{NS, K::N1}, epi, lap);
    wg::conv<U1c, P4>(ring, Y, RowsT2<1, 0>{NS, K::N1}, epi, lap);
    wg::conv<U1d, P4>(ring, Y, RowsT2<1, 1>{NS, K::N1}, epi, lap);
  }
  wg::sync_consumers();
  lap(wg::P_SYNC);
  // gx from gp0 (Z)
  wg::conv<U0, P0>(ring, Z, RowsT1<3, 3>{K::TX, K::N0}, gx, lap);
  gx.zero_borders();
  lap(wg::P_STORE);
}

}  // namespace wgc

}  // namespace stem

#ifdef APFP_PROFILE
// The cycle accounts (stem_common.cuh: wg::Lap) into out[PROF_N], then
// zeroed: one entry point a library (each library is one source)
extern "C" int apfp_prof_take(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, stem::wg::prof_cycles,
                                       sizeof(stem::wg::prof_cycles));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[stem::wg::PROF_N] = {};
  return (int)cudaMemcpyToSymbol(stem::wg::prof_cycles, zero, sizeof(zero));
}
#endif
