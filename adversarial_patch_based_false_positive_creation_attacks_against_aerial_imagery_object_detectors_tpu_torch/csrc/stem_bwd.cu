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
// model; bfloat16 takes them packed for wgmma (below). A stride-1
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
// bfloat16 (fused_stem_bwd_wg_kernel) is built for Hopper's units
// (stem_common.cuh: wg): the five adjoints are implicit GEMMs on
// wgmma.mma_async issued by two consumer warpgroups (conv5^T and conv1^T
// as four GEMMs, one per output parity, with K = 1, 2, 2 or 4 taps x CIN;
// conv0^T's N = 8 is one m64n8k16), with bwd_tc's epilogues, so the FMA
// chain's rounding points and K2's tile origins stay. Its consumer side
// from gp5 on and the weights' producer side are stem_common.cuh's
// wgc::chain and wgc::produce, which K5 and K8b run too. A producer warp
// keeps every load in flight by TMA and bulk copies: first y5's and g5's
// boxes (8 rows x 128 channels x 16 lanes; gp5 = T(g5 m(y5)) is formed
// from them in shared memory), then the y3 and y2 mask windows, boxes
// [row][channel][32 lanes] of the planar int8 masks through 4-d tensor
// maps (the row stride is a multiple of 16 bytes; a box must start on a
// 16-byte boundary, so a window holds the 32 lanes from the boundary at
// or below its first lane; rows and lanes outside the tensor arrive as
// zeros), then conv5^T's weight chunks, then, once gp5 is formed, the y0
// and y1 windows into the region the y5 and g5 boxes held, then the other
// GEMMs' chunks (wg_weights' packing of the swapped-channel adjoints,
// conv5^T's and conv1^T's per parity in RowsT2's tap order) through a
// ring of six 8 KB slots (a conv5^T or conv2^T chunk, two conv3^T or
// conv1^T chunks, all of conv0^T's): 18 + 5 + 1 + 9 + 1 slot loads, 229 KB
// a tile from L2. What bounds this design: one block a multiprocessor
// (226,176 bytes: the chain's 69,312, the boxes' and windows' 105,472 and
// the ring), so each tile's first loads wait with the card's units idle
// and its serial parts (the gp5 pass, the epilogues and their gate reads,
// gx's scattered 2-byte stores) leave the tensor cores idle; the 16 x 16
// gx tile's halo (~1.7x the FLOPs) stays, a larger tile's windows and
// regions would not fit; and a persistent block (tiles in turn, the next
// one's loads under the current one's tail) loops over the divergent
// epilogues, around which ptxas serializes the wgmmas (measured slower).
// float32 stays on stem_common.cuh's grad_chain (CUDA-core FMAs, shared
// with K5), 151,552 bytes, one block a multiprocessor.


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
// The bfloat16 chain on wgmma
// ---------------------------------------------------------------------------

namespace k2 {

using K = Chain;
// A box's first lane must lie on a 16-byte boundary (the tensor unit
// refuses others), so the mask windows are wgc::WL = 32 lanes (int8) and
// y5's and g5's boxes wgc::WL5 = 16 lanes (bfloat16) from the boundary at
// or below the first lane read. Shared memory from a 1024-aligned base
// (bytes): the chain's X, Y, Z; region R1 holds y5's and g5's boxes
// [N5][128][16] until gp5 is formed, then the y0 windows (both phases) and
// y1's; region R2 the y3 and y2 windows (windows [row][channel][32
// lanes]); four barriers (the inputs, the y3 / y2 windows, the y0 / y1
// windows, R1 free); the ring
using wgc::WL;
using wgc::Y5_B;
constexpr int R1_AT = (2 * bwd_tc::ELEMS + 127) / 128 * 128;
constexpr int M0_B = K::N0 * 32 * WL;  // a phase
constexpr int M1_B = K::N1 * 64 * WL;
constexpr int M0_AT = R1_AT, M1_AT = M0_AT + 2 * M0_B;
constexpr int R2_AT = R1_AT + 2 * Y5_B;
constexpr int M3_B = K::N4 * 64 * WL, M2_B = K::N1 * 32 * WL;
constexpr int M3_AT = R2_AT, M2_AT = M3_AT + M3_B;
constexpr int BAR_AT = M2_AT + M2_B;
constexpr int RING_AT = BAR_AT + 32;
constexpr int SMEM =
    1024 + RING_AT + wg::ring_bytes(wgc::STAGES, wgc::SLOT);
static_assert(SMEM <= 232448 && 2 * M0_B + M1_B <= 2 * Y5_B &&
                  M3_B % 128 == 0 && M2_B % 128 == 0 && M0_B % 128 == 0 &&
                  M1_B % 128 == 0 && Y5_B % 128 == 0,
              "shared memory");
static_assert(K::N5 == 8 && K::TX == 16, "the boxes cover the windows");

// The mask windows' barriers: the y3 and y2 windows before conv5^T, the y0
// and y1 windows before conv2^T
struct Gates {
  uint32_t m32, m01;
  __device__ void first(wg::Lap& lap) const {
    wg::mbar_wait(m32, 0);
    lap(wg::P_INPUT);
  }
  __device__ void second(wg::Lap& lap) const {
    wg::mbar_wait(m01, 0);
    lap(wg::P_INPUT);
  }
};

}  // namespace k2

// The bfloat16 K2: grad_chain's stages, regions and tile origins, with the
// adjoints on wgmma (stem_common.cuh: wgc::chain) and every load issued by
// the producer warp. The tensor maps: the masks (boxes of 32 lanes x C
// channels x the window's rows), y5 and g5 (16 lanes x 128 x 8 rows).
__global__ void __launch_bounds__(wg::NTH, 1)
    fused_stem_bwd_wg_kernel(const __grid_constant__ CUtensorMap tm0e,
                             const __grid_constant__ CUtensorMap tm0o,
                             const __grid_constant__ CUtensorMap tm1,
                             const __grid_constant__ CUtensorMap tm2,
                             const __grid_constant__ CUtensorMap tm3,
                             const __grid_constant__ CUtensorMap ty5,
                             const __grid_constant__ CUtensorMap tg5,
                             wgc::Weights ww, bf16* __restrict__ gxe,
                             bf16* __restrict__ gxo, int H, int wlh) {
  using namespace k2;
  using wgc::BoxMask;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t s0 = wg::smem_u32(sm);
  const uint32_t bar_in = s0 + BAR_AT, bar_m32 = bar_in + 8;
  const uint32_t bar_m01 = bar_in + 16, bar_r1 = bar_in + 24;
  auto ring = wg::make_ring<wgc::STAGES, wgc::SLOT>(s0 + RING_AT);
  if (threadIdx.x == 0) {
    wg::mbar_init(bar_in, 1);
    wg::mbar_init(bar_m32, 1);
    wg::mbar_init(bar_m01, 1);
    wg::mbar_init(bar_r1, wg::CONSUMER_WARPS);
    wg::fence_barrier_init();
  }
  __syncthreads();
  const int b = blockIdx.z;
  const int R0 = blockIdx.y * K::TX, C0 = blockIdx.x * K::TX;
  const int H5 = H / 4;
  // tile origins in image coordinates (rows; columns alike)
  const int o5r = R0 / 4 - 1, o5c = C0 / 4 - 1;  // gp5, N5
  const int o4r = R0 / 2 - 2, o4c = C0 / 2 - 2;  // gs4 / gp3, N4
  const int o1r = R0 / 2 - 1, o1c = C0 / 2 - 1;  // gp2 / gp1, N1
  const int o0r = R0 - 2, o0c = C0 - 2;          // gp0, N0
  // each window's first lane: the 16-byte boundary at or below the first
  // lane read (y3's from lane o4c + 1, y1's and y2's from o1c + 1, y0's
  // from (o0c >> 1) + 1, y5's and g5's from o5c + 1)
  const int l3 = (o4c + 1) & ~15, l12 = (o1c + 1) & ~15;
  const int l0 = ((o0c >> 1) + 1) & ~15, l5 = (o5c + 1) & ~7;
  if (threadIdx.x >= wg::NC) {
    // the producer warp: one thread issues every load, in the order the
    // consumers need them
    if (threadIdx.x == wg::NC) {
      wg::mbar_expect_tx(bar_in, 2 * Y5_B);
      wg::tma_load_4d(s0 + R1_AT, &ty5, l5, 0, o5r, b, bar_in);
      wg::tma_load_4d(s0 + R1_AT + Y5_B, &tg5, l5, 0, o5r, b, bar_in);
      wg::mbar_expect_tx(bar_m32, M3_B + M2_B);
      wg::tma_load_4d(s0 + M3_AT, &tm3, l3, 0, o4r, b, bar_m32);
      wg::tma_load_4d(s0 + M2_AT, &tm2, l12, 0, o1r, b, bar_m32);
      // R1 is free once gp5 is formed: the y0 and y1 windows into it
      wgc::produce(ring, ww, [&] {
        wg::mbar_wait(bar_r1, 0);
        wg::mbar_expect_tx(bar_m01, 2 * M0_B + M1_B);
        wg::tma_load_4d(s0 + M0_AT, &tm0e, l0, 0, o0r, b, bar_m01);
        wg::tma_load_4d(s0 + M0_AT + M0_B, &tm0o, l0, 0, o0r, b, bar_m01);
        wg::tma_load_4d(s0 + M1_AT, &tm1, l12, 0, o1r, b, bar_m01);
      });
    }
    return;
  }

  bf16* Z = reinterpret_cast<bf16*>(sm) + bwd_tc::SZ_X + bwd_tc::SZ_Y;
  // gp5 = T(g5 m(y5)) from the boxes into Z, zero outside the image; then
  // R1 is handed back to the producer
  wg::Lap lap;
  wg::mbar_wait(bar_in, 0);
  lap(wg::P_INPUT);
  wgc::gp5_from_boxes(Z, reinterpret_cast<const bf16*>(sm + R1_AT),
                      reinterpret_cast<const bf16*>(sm + R1_AT + Y5_B), o5r,
                      o5c, l5, H5);
  // the boxes' reads done (generic proxy) before the tensor unit rewrites
  // R1 (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  lap(wg::P_LOAD);
  wg::sync_consumers();
  if ((threadIdx.x & 31) == 0) wg::mbar_arrive(bar_r1);
  lap(wg::P_SYNC);
  const long long gb = (long long)b * H * 8 * wlh;
  wgc::chain(ring, sm, BoxMask<32, K::N0, true>{sm + M0_AT, l0},
             BoxMask<64, K::N1, false>{sm + M1_AT, l12},
             BoxMask<32, K::N1, false>{sm + M2_AT, l12},
             BoxMask<64, K::N4, false>{sm + M3_AT, l3},
             bwd_tc::EpiGx{gxe + gb, gxo + gb, R0, C0, wlh, H},
             Gates{bar_m32, bar_m01}, H, lap);
}

using wg::planar_map;

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

int launch_wg(const void* const* m, const void* y5, const void* g5,
              const void* const* u, void* gxe, void* gxo, int B, int H,
              int wlh, int wl5, cudaStream_t s) {
  using K = Chain;
  const int H1 = H / 2, H5 = H / 4;
  CUtensorMap tm[7];
  int err = 0;
  using wgc::WL;
  using wgc::WL5;
  err = err ? err : planar_map(&tm[0], m[0], false, B, H, 32, wlh, WL, K::N0);
  err = err ? err : planar_map(&tm[1], m[1], false, B, H, 32, wlh, WL, K::N0);
  err = err ? err : planar_map(&tm[2], m[2], false, B, H1, 64, wlh, WL, K::N1);
  err = err ? err : planar_map(&tm[3], m[3], false, B, H1, 32, wlh, WL, K::N1);
  err = err ? err : planar_map(&tm[4], m[4], false, B, H1, 64, wlh, WL, K::N4);
  err = err ? err : planar_map(&tm[5], y5, true, B, H5, 128, wl5, WL5, K::N5);
  err = err ? err : planar_map(&tm[6], g5, true, B, H5, 128, wl5, WL5, K::N5);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      fused_stem_bwd_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      k2::SMEM);
  if (e != cudaSuccess) return (int)e;
  const wgc::Weights ww = {{static_cast<const unsigned char*>(u[0]),
                           static_cast<const unsigned char*>(u[1]),
                           static_cast<const unsigned char*>(u[2]),
                           static_cast<const unsigned char*>(u[3]),
                           static_cast<const unsigned char*>(u[4])}};
  dim3 grid(H / K::TX, H / K::TX, B);
  fused_stem_bwd_wg_kernel<<<grid, wg::NTH, k2::SMEM, s>>>(
      tm[0], tm[1], tm[2], tm[3], tm[4], tm[5], tm[6], ww,
      static_cast<bf16*>(gxe), static_cast<bf16*>(gxo), H, wlh);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (y5, g5, weights and gx). Masks int8;
// v0 .. v5 the swapped-channel weights of convs 0, 1, 2, 3, 5 (read in
// float32), u0 .. u5 the same packed for wgmma (wg_weights, conv1^T's and
// conv5^T's per parity; read in bfloat16; null in float32). H must be a
// multiple of 16. Returns cudaGetLastError() (or a tensor map's error).
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
    return launch_wg(m, y5, g5, u, gxe, gxo, B, H, wlh, wl5, s);
  }
  const void* v[5] = {v0, v1, v2, v3, v5};
  return launch_f32(m, y5, g5, v, gxe, gxo, B, H, wlh, wl5, s);
}

// The kernel of dtype as the card sees it: info[0] registers a thread,
// info[1] the dynamic shared memory bytes of a launch, info[2] the blocks
// one multiprocessor holds. Returns the CUDA error.
extern "C" int apfp_fused_stem_bwd_info(int dtype, int* info) {
  if (dtype == 1)
    return info_of(fused_stem_bwd_wg_kernel, k2::SMEM, info, wg::NTH);
  return info_of(fused_stem_bwd_kernel<float>,
                 sizeof(float) * (size_t)Chain::ELEMS, info);
}
