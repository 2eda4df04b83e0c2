// Fused YOLOv3 stem backward (K2): the input cotangent of layers 0-5 from
// the sign masks the forward saved.
//
// Replaces the JAX package's Pallas kernel ops/stem_fused.py
// fused_stem_bwd_saved (body _bwd_kernel_sv, then _grad_chain). With
// m(v) = 1 if v > 0 else 0.1 and T the rounding to the compute dtype, it
// computes, in _grad_chain's order and at its rounding points,
//   gp5 = T(g5 m(y5))
//   gs4 = T(conv5^T gp5)                  (stride 2, 128 -> 64)
//   gp3 = T(gs4 m3)
//   gp2 = T(conv3^T(gp3) m2)
//   gp1 = T((conv2^T(gp2) + gs4) m1)      (the shortcut's two paths)
//   gp0 = T(conv1^T(gp1) m0)              (stride 2, 64 -> 32)
//   gx  = T(conv0^T gp0)                  (32 -> 3, padded to 8)
// with float32 accumulation; every cotangent at a row or column outside
// the image is zero. Inputs: the int8 masks m0 (y0 as even/odd column
// phases [B, H, 32, wlh]), m1 and m3 [B, H/2, 64, wlh], m2 [B, H/2, 32,
// wlh]; y5 and g5 planar [B, H/4, 128, wl5]. Output: gx as even/odd
// column phases, planar [B, H, 8, wlh] (channels 3..7 of the padded
// conv0 adjoint, so zero). The kernel writes every lane, as K1 does.
//
// Weights: each conv's HWIO kernel with its two channel axes swapped,
// w^T[dy][dx][cout][cin] (conv0's cin padded 3 -> 8), built once by the
// model. A stride-1 adjoint reads its input at (o + pad - dy) with the
// forward tap (dy, dx). A stride-2 adjoint is computed per 2x2 "super
// position": output rows 2a and 2a+1 (and columns alike) take the taps
// whose parity matches, dy = 1 for the even row and dy = 0 / 2 (input
// rows a+1 / a) for the odd one, so all 9 taps are used once per super
// position and no thread idles on the wrong parity.
//
// What bounds it on the H100: operations, as K1 (the stem's 11.2 GFLOP per
// 608^2 image again, against ~84 MB of masks, y5, g5 and gx per image).
// This first design mirrors K1: each block owns a 16 x 16 tile of gx and
// works backwards over its receptive field in shared memory (gp5 8^2x128
// -> gs4/gp3 14^2x64 -> gp2/gp1 11^2 -> gp0 20^2x32 -> gx 16^2), so no
// cotangent touches device memory; masks are read as bytes straight from
// device memory. CUDA-core FMAs with float32 accumulation; the halo
// recompute costs ~1.7x the FLOPs. Tensor cores are later work.
//
// Shared memory: 37,888 elements, 75,776 bytes in bfloat16 and 151,552 in
// float32 (three regions: gs4; gp3 then gp1; gp5 then gp2 then gp0).

#include "stem_common.cuh"

namespace {

using namespace stem;

constexpr int TX = 16;  // gx tile side
constexpr int N5 = 8;   // gp5 tile side
constexpr int N4 = 14;  // gs4 / gp3 tile side (7 x 7 super positions)
constexpr int N1 = 11;  // gp2 / gp1 tile side
constexpr int N0 = 20;  // gp0 tile side (10 x 10 super positions)
constexpr int SZ_X = N4 * N4 * 64;
constexpr int SZ_Y = N4 * N4 * 64;
constexpr int SZ_Z = N0 * N0 * 32;
static_assert(N5 * N5 * 128 <= SZ_Z && N1 * N1 * 32 <= SZ_Z &&
                  N1 * N1 * 64 <= SZ_Y,
              "shared-memory regions");
constexpr int ELEMS = SZ_X + SZ_Y + SZ_Z;

__device__ __forceinline__ float gate(int8_t m) { return m ? 1.f : LEAKY; }

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

// gs4 = T(v) and gp3 = T(gs4 m3), zero outside the image
template <typename T>
struct EpiGs4 {
  T* gs4;
  T* gp3;
  const int8_t* m3;  // this image's y3 mask [H1, 64, wl]
  int org_r, org_c, img, wl;
  __device__ void operator()(int oy, int ox, int co0, const float* v) const {
    const int gr = org_r + oy, gc = org_c + ox;
    const bool in = gr >= 0 && gr < img && gc >= 0 && gc < img;
    const int o = (oy * N4 + ox) * 64 + co0;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      float g = 0.f, p = 0.f;
      if (in) {
        g = round_t<T>(v[c]);
        p = g * gate(m3[((long long)gr * 64 + co0 + c) * wl + gc + 1]);
      }
      gs4[o + c] = from_f<T>(g);
      gp3[o + c] = from_f<T>(p);
    }
  }
};

// out = T((v [+ res]) m), zero outside the image; m from a planar int8
// mask [img, C, wl] (PHASE: even/odd column phases m / mo)
template <typename T, int C, bool PHASE, bool RES>
struct EpiGate {
  T* out;
  int OW;
  const int8_t* m;
  const int8_t* mo;
  int org_r, org_c, img, wl;
  const T* res;  // RES: [pos][C] with pitch N4, read at (oy+1, ox+1)
  __device__ void operator()(int oy, int ox, int co0, const float* v) const {
    const int gr = org_r + oy, gc = org_c + ox;
    const bool in = gr >= 0 && gr < img && gc >= 0 && gc < img;
    const int o = (oy * OW + ox) * C + co0;
    const int8_t* mp = (PHASE && (gc & 1)) ? mo : m;
    const int lane = PHASE ? (gc >> 1) + 1 : gc + 1;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      float y = 0.f;
      if (in) {
        float s = v[c];
        if (RES) s += to_f(res[((oy + 1) * N4 + ox + 1) * C + co0 + c]);
        y = s * gate(mp[((long long)gr * C + co0 + c) * wl + lane]);
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

template <typename T>
__global__ void __launch_bounds__(NT, 1)
    fused_stem_bwd_kernel(const int8_t* __restrict__ m0e,
                          const int8_t* __restrict__ m0o,
                          const int8_t* __restrict__ m1,
                          const int8_t* __restrict__ m2,
                          const int8_t* __restrict__ m3,
                          const T* __restrict__ y5, const T* __restrict__ g5,
                          const T* __restrict__ v0, const T* __restrict__ v1,
                          const T* __restrict__ v2, const T* __restrict__ v3,
                          const T* __restrict__ v5, T* __restrict__ gxe,
                          T* __restrict__ gxo, int H, int wlh, int wl5) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* X = reinterpret_cast<T*>(smem_raw);  // gs4
  T* Y = X + SZ_X;                        // gp3, then gp1
  T* Z = Y + SZ_Y;                        // gp5, then gp2, then gp0

  const int b = blockIdx.z;
  const int R0 = blockIdx.y * TX, C0 = blockIdx.x * TX;
  const int H1 = H / 2, H5 = H / 4;
  const long long mb0 = (long long)b * H * 32 * wlh;   // y0 mask image
  const long long mb64 = (long long)b * H1 * 64 * wlh;
  const long long mb32 = (long long)b * H1 * 32 * wlh;
  // tile origins in image coordinates (rows; columns alike)
  const int o5r = R0 / 4 - 1, o5c = C0 / 4 - 1;  // gp5, N5
  const int o4r = R0 / 2 - 2, o4c = C0 / 2 - 2;  // gs4 / gp3, N4
  const int o1r = R0 / 2 - 1, o1c = C0 / 2 - 1;  // gp2 / gp1, N1
  const int o0r = R0 - 2, o0c = C0 - 2;          // gp0, N0

  // gp5 = T(g5 m(y5)), lanes fastest
  for (int idx = threadIdx.x; idx < N5 * N5 * 128; idx += NT) {
    const int k = idx % N5;
    const int rest = idx / N5;
    const int co = rest % 128, r = rest / 128;
    const int gr = o5r + r, gc = o5c + k;
    float v = 0.f;
    if (gr >= 0 && gr < H5 && gc >= 0 && gc < H5) {
      const long long o = (((long long)b * H5 + gr) * 128 + co) * wl5 + gc + 1;
      const float y = to_f(y5[o]);
      v = to_f(g5[o]) * (y > 0.f ? 1.f : LEAKY);
    }
    Z[(r * N5 + k) * 128 + co] = from_f<T>(v);
  }
  __syncthreads();
  // gs4 (X) and gp3 (Y) from gp5 (Z)
  convt_s2<T, 128, 64>(Z, N5, N4 / 2, v5,
                       EpiGs4<T>{X, Y, m3 + mb64, o4r, o4c, H1, wlh});
  __syncthreads();
  // gp2 (Z) from gp3 (Y)
  convt_s1<T, 64, 32, 3, 2, 2>(
      Y, N4, N1, N1, v3,
      EpiGate<T, 32, false, false>{Z, N1, m2 + mb32, nullptr, o1r, o1c, H1,
                                   wlh, nullptr});
  __syncthreads();
  // gp1 (Y) from gp2 (Z) and gs4 (X)
  convt_s1<T, 32, 64, 1, 0, 4>(
      Z, N1, N1, N1, v2,
      EpiGate<T, 64, false, true>{Y, N1, m1 + mb64, nullptr, o1r, o1c, H1,
                                  wlh, X});
  __syncthreads();
  // gp0 (Z) from gp1 (Y)
  convt_s2<T, 64, 32>(
      Y, N1, N0 / 2, v1,
      EpiGate<T, 32, true, false>{Z, N0, m0e + mb0, m0o + mb0, o0r, o0c, H,
                                  wlh, nullptr});
  __syncthreads();
  // gx from gp0 (Z)
  const long long gb = (long long)b * H * 8 * wlh;
  convt_s1<T, 32, 8, 3, 3, 1>(Z, N0, TX, TX, v0,
                              EpiGx<T>{gxe + gb, gxo + gb, R0, C0, wlh});
  // zero border and padding lanes of this tile's rows in both phases:
  // lane 0 (first tile column), lanes H/2+1 .. wlh-1 (last tile column)
  const bool first = blockIdx.x == 0, last = blockIdx.x == gridDim.x - 1;
  if (first || last) {
    const int nr = last ? wlh - H1 - 1 : 0;
    const int n = nr + (first ? 1 : 0);
    for (int idx = threadIdx.x; idx < 2 * TX * 8 * n; idx += NT) {
      const int k = idx % n;
      int rest = idx / n;
      const int c = rest % 8;
      rest /= 8;
      const int r = rest % TX, ph = rest / TX;
      const int lane = k < nr ? H1 + 1 + k : 0;
      (ph ? gxo : gxe)[gb + ((long long)(R0 + r) * 8 + c) * wlh + lane] =
          from_f<T>(0.f);
    }
  }
}

template <typename T>
int launch(const void* const* m, const void* y5, const void* g5,
           const void* const* v, void* gxe, void* gxo, int B, int H,
           int wlh, int wl5, cudaStream_t s) {
  const size_t smem = sizeof(T) * (size_t)ELEMS;
  cudaError_t e = cudaFuncSetAttribute(
      fused_stem_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H / TX, H / TX, B);
  fused_stem_bwd_kernel<T><<<grid, NT, smem, s>>>(
      static_cast<const int8_t*>(m[0]), static_cast<const int8_t*>(m[1]),
      static_cast<const int8_t*>(m[2]), static_cast<const int8_t*>(m[3]),
      static_cast<const int8_t*>(m[4]), static_cast<const T*>(y5),
      static_cast<const T*>(g5), static_cast<const T*>(v[0]),
      static_cast<const T*>(v[1]), static_cast<const T*>(v[2]),
      static_cast<const T*>(v[3]), static_cast<const T*>(v[4]),
      static_cast<T*>(gxe), static_cast<T*>(gxo), H, wlh, wl5);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (y5, g5, weights and gx). Masks int8;
// v0 .. v5 the swapped-channel weights of convs 0, 1, 2, 3, 5. H must be
// a multiple of 16. Returns cudaGetLastError().
extern "C" int apfp_fused_stem_bwd(const void* m0e, const void* m0o,
                                   const void* m1, const void* m2,
                                   const void* m3, const void* y5,
                                   const void* g5, const void* v0,
                                   const void* v1, const void* v2,
                                   const void* v3, const void* v5, void* gxe,
                                   void* gxo, int dtype, int B, int H,
                                   int wlh, int wl5, void* stream) {
  const void* m[5] = {m0e, m0o, m1, m2, m3};
  const void* v[5] = {v0, v1, v2, v3, v5};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(m, y5, g5, v, gxe, gxo, B, H, wlh, wl5, s);
  return launch<float>(m, y5, g5, v, gxe, gxo, B, H, wlh, wl5, s);
}
