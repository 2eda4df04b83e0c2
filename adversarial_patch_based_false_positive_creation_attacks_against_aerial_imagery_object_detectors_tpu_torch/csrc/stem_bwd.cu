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
// model; bfloat16 takes them in mma.sync's fragment order. A stride-1
// adjoint reads its input at (o + pad - dy) with the forward tap (dy, dx).
// A stride-2 adjoint is computed per 2x2 "super position": output rows 2a
// and 2a+1 (and columns alike) take the taps whose parity matches, dy = 1
// for the even row and dy = 0 / 2 (input rows a+1 / a) for the odd one, so
// all 9 taps are used once per super position and none is multiplied by a
// zero of an expanded input.
//
// What bounds it on the H100: operations, as K1 (the stem's 11.2 GFLOP per
// 608^2 image again, against ~84 MB of masks, y5, g5 and gx per image).
// Each block owns a 16 x 16 tile of gx and works backwards over its
// receptive field in shared memory (gp5 8^2x128 -> gs4/gp3 14^2x64 ->
// gp2/gp1 11^2 -> gp0 20^2x32 -> gx 16^2), so no cotangent touches device
// memory; the halo recompute costs ~1.7x the FLOPs.
//
// bfloat16 runs the five adjoints on the tensor cores (stem_common.cuh:
// bwd_tc::chain on mma_conv, shared with K5; conv5^T and conv1^T as four
// GEMMs, one per output parity, with K = 1, 2, 2 or 4 taps x CIN; conv0^T's
// N = 8 is one m16n8k16 column), the epilogues keeping the FMA chain's
// rounding points. The block first
// stages its mask windows into shared memory with 4-byte cp.async copies,
// lanes fastest (each (row, channel) line's lanes are contiguous in the
// planar layout), overlapped with the gp5 loads; the gates then come from
// shared memory instead of strided byte reads of device memory. Row pitches
// of the tiles an ldmatrix reads are padded by 16 bytes (gp5 136, gp3/gp1
// 72, gp2 40) but gp0's (32: two-way conflicts) to keep two blocks a
// multiprocessor: 115,264 bytes each (the chain's 69,312, the masks'
// 45,952). float32 stays on stem_common.cuh's grad_chain (CUDA-core FMAs,
// shared with K5), 151,552 bytes, one block a multiprocessor.

#include "stem_common.cuh"

namespace {

using namespace stem;

// The float32 K2: grad_chain on CUDA-core FMAs, one block a multiprocessor
// (151,552 bytes of shared memory)
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
  const long long b = blockIdx.z;
  const int H1 = H / 2;
  const long long mb0 = b * H * 32 * wlh;  // this image's masks
  const long long mb64 = b * H1 * 64 * wlh;
  const long long mb32 = b * H1 * 32 * wlh;
  grad_chain<T>(reinterpret_cast<T*>(smem_raw), y5, g5, v0, v1, v2, v3, v5,
                gxe, gxo, PlanarMask<32, true>{m0e + mb0, m0o + mb0, wlh},
                PlanarMask<64, false>{m1 + mb64, nullptr, wlh},
                PlanarMask<32, false>{m2 + mb32, nullptr, wlh},
                PlanarMask<64, false>{m3 + mb64, nullptr, wlh}, H, wlh, wl5);
}

// ---------------------------------------------------------------------------
// The bfloat16 chain on tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using K = Chain;
// the mask windows (stem_common.cuh: bwd_tc's gate windows)
using bwd_tc::M0_BYTES;
using bwd_tc::M1_BYTES;
using bwd_tc::M2_BYTES;
using bwd_tc::M3_BYTES;
using bwd_tc::StagedMask;
using bwd_tc::W12;
using bwd_tc::W3;
constexpr int SMEM = 2 * bwd_tc::ELEMS + bwd_tc::GATE_BYTES;

// A planar int8 mask window into shared memory, 4-byte cp.async copies:
// tile rows r < R at image rows org_r + r, C channels, NPH column phases
// (m, mo), lanes [l0, l0 + W) of each line of wl lanes; laid out [r][ch]
// [ph][W]. Rows outside the image and chunks outside [0, wl) are skipped:
// the epilogues read no gate there.
template <int R, int C, int NPH, int W>
__device__ void stage_mask(unsigned char* __restrict__ s,
                           const int8_t* __restrict__ m,
                           const int8_t* __restrict__ mo, int org_r, int l0,
                           int img, int wl) {
  constexpr int NQ = W / 4;
  for (int idx = threadIdx.x; idx < R * C * NPH * NQ; idx += NT) {
    const int q = idx % NQ;
    int rest = idx / NQ;
    const int ph = rest % NPH;
    rest /= NPH;
    const int ch = rest % C, r = rest / C;
    const int gr = org_r + r, lane = l0 + 4 * q;
    if (gr < 0 || gr >= img || lane < 0 || lane + 4 > wl) continue;
    cp_async4(s + 4 * idx,
              (ph ? mo : m) + ((long long)gr * C + ch) * wl + lane);
  }
}

}  // namespace tc

// The bfloat16 K2: grad_chain's stages, regions and tile origins, with the
// adjoints on tensor cores and the gates staged in shared memory. u0 .. u5
// the swapped-channel weights in fragment order.
__global__ void __launch_bounds__(NT, 2)
    fused_stem_bwd_tc_kernel(const int8_t* __restrict__ m0e,
                             const int8_t* __restrict__ m0o,
                             const int8_t* __restrict__ m1,
                             const int8_t* __restrict__ m2,
                             const int8_t* __restrict__ m3,
                             const bf16* __restrict__ y5,
                             const bf16* __restrict__ g5,
                             const uint2* __restrict__ u0,
                             const uint2* __restrict__ u1,
                             const uint2* __restrict__ u2,
                             const uint2* __restrict__ u3,
                             const uint2* __restrict__ u5,
                             bf16* __restrict__ gxe, bf16* __restrict__ gxo,
                             int H, int wlh, int wl5) {
  using namespace tc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);  // the chain's X, Y, Z
  bf16* Z = sm + bwd_tc::SZ_X + bwd_tc::SZ_Y;
  unsigned char* s3 =
      reinterpret_cast<unsigned char*>(sm + bwd_tc::ELEMS);
  unsigned char* s1 = s3 + M3_BYTES;
  unsigned char* s2 = s1 + M1_BYTES;
  unsigned char* s0 = s2 + M2_BYTES;
  const long long b = blockIdx.z;
  const int R0 = blockIdx.y * K::TX, C0 = blockIdx.x * K::TX;
  const int H1 = H / 2;
  // tile origins in image coordinates (rows; columns alike)
  const int o4r = R0 / 2 - 2, o4c = C0 / 2 - 2;  // gs4 / gp3, N4
  const int o1r = R0 / 2 - 1, o1c = C0 / 2 - 1;  // gp2 / gp1, N1
  const int o0r = R0 - 2, o0c = C0 - 2;          // gp0, N0
  // the first lane of each mask window, rounded down to 4 bytes
  const int l3 = (o4c + 1) & ~3, l12 = (o1c + 1) & ~3;
  const int l0 = ((o0c >> 1) + 1) & ~3;

  const long long mb0 = b * H * 32 * wlh;  // this image's masks
  const long long mb64 = b * H1 * 64 * wlh;
  const long long mb32 = b * H1 * 32 * wlh;
  stage_mask<K::N4, 64, 1, W3>(s3, m3 + mb64, nullptr, o4r, l3, H1, wlh);
  stage_mask<K::N1, 64, 1, W12>(s1, m1 + mb64, nullptr, o1r, l12, H1, wlh);
  stage_mask<K::N1, 32, 1, W12>(s2, m2 + mb32, nullptr, o1r, l12, H1, wlh);
  stage_mask<K::N0, 32, 2, W12>(s0, m0e + mb0, m0o + mb0, o0r, l0, H, wlh);
  // gp5, overlapped with the mask copies
  bwd_tc::load_gp5(Z, y5, g5, b, H, wl5);
  cp_async_wait_all();
  __syncthreads();
  bwd_tc::chain(sm, u0, u1, u2, u3, u5, StagedMask<32, W12, true>{s0, l0},
                StagedMask<64, W12, false>{s1, l12},
                StagedMask<32, W12, false>{s2, l12},
                StagedMask<64, W3, false>{s3, l3}, gxe, gxo, b, H, wlh);
}

int launch_f32(const void* const* m, const void* y5, const void* g5,
               const void* const* v, void* gxe, void* gxo, int B, int H,
               int wlh, int wl5, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)Chain::ELEMS;
  cudaError_t e = cudaFuncSetAttribute(
      fused_stem_bwd_kernel<float>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H / Chain::TX, H / Chain::TX, B);
  fused_stem_bwd_kernel<float><<<grid, NT, smem, s>>>(
      static_cast<const int8_t*>(m[0]), static_cast<const int8_t*>(m[1]),
      static_cast<const int8_t*>(m[2]), static_cast<const int8_t*>(m[3]),
      static_cast<const int8_t*>(m[4]), static_cast<const float*>(y5),
      static_cast<const float*>(g5), static_cast<const float*>(v[0]),
      static_cast<const float*>(v[1]), static_cast<const float*>(v[2]),
      static_cast<const float*>(v[3]), static_cast<const float*>(v[4]),
      static_cast<float*>(gxe), static_cast<float*>(gxo), H, wlh, wl5);
  return (int)cudaGetLastError();
}

int launch_tc(const void* const* m, const void* y5, const void* g5,
              const void* const* u, void* gxe, void* gxo, int B, int H,
              int wlh, int wl5, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_stem_bwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H / Chain::TX, H / Chain::TX, B);
  fused_stem_bwd_tc_kernel<<<grid, NT, tc::SMEM, s>>>(
      static_cast<const int8_t*>(m[0]), static_cast<const int8_t*>(m[1]),
      static_cast<const int8_t*>(m[2]), static_cast<const int8_t*>(m[3]),
      static_cast<const int8_t*>(m[4]), static_cast<const bf16*>(y5),
      static_cast<const bf16*>(g5), static_cast<const uint2*>(u[0]),
      static_cast<const uint2*>(u[1]), static_cast<const uint2*>(u[2]),
      static_cast<const uint2*>(u[3]), static_cast<const uint2*>(u[4]),
      static_cast<bf16*>(gxe), static_cast<bf16*>(gxo), H, wlh, wl5);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (y5, g5, weights and gx). Masks int8;
// v0 .. v5 the swapped-channel weights of convs 0, 1, 2, 3, 5 (read in
// float32), u0 .. u5 the same in mma.sync's fragment order (read in
// bfloat16; null in float32). H must be a multiple of 16. Returns
// cudaGetLastError().
extern "C" int apfp_fused_stem_bwd(const void* m0e, const void* m0o,
                                   const void* m1, const void* m2,
                                   const void* m3, const void* y5,
                                   const void* g5, const void* v0,
                                   const void* v1, const void* v2,
                                   const void* v3, const void* v5,
                                   const void* u0, const void* u1,
                                   const void* u2, const void* u3,
                                   const void* u5, void* gxe, void* gxo,
                                   int dtype, int B, int H, int wlh, int wl5,
                                   void* stream) {
  const void* m[5] = {m0e, m0o, m1, m2, m3};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const void* u[5] = {u0, u1, u2, u3, u5};
    return launch_tc(m, y5, g5, u, gxe, gxo, B, H, wlh, wl5, s);
  }
  const void* v[5] = {v0, v1, v2, v3, v5};
  return launch_f32(m, y5, g5, v, gxe, gxo, B, H, wlh, wl5, s);
}

// The kernel of dtype as the card sees it: info[0] registers a thread,
// info[1] the dynamic shared memory bytes of a launch, info[2] the blocks
// one multiprocessor holds. Returns the CUDA error.
extern "C" int apfp_fused_stem_bwd_info(int dtype, int* info) {
  if (dtype == 1) return info_of(fused_stem_bwd_tc_kernel, tc::SMEM, info);
  return info_of(fused_stem_bwd_kernel<float>,
                 sizeof(float) * (size_t)Chain::ELEMS, info);
}
