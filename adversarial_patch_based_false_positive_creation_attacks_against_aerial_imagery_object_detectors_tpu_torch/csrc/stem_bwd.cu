// Fused YOLOv3 stem backward (K2): the input cotangent of layers 0-5 from
// the sign masks the forward saved.
//
// Replaces the JAX package's Pallas kernel ops/stem_fused.py
// fused_stem_bwd_saved (body _bwd_kernel_sv, then _grad_chain). The chain
// itself is stem_common.cuh's grad_chain, shared with K5 (stem_remat.cu),
// which feeds it recomputed signs instead of these masks. With
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

// bfloat16 fits two blocks a multiprocessor (75,776 bytes of shared
// memory each); float32 one
template <typename T>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 ? 2 : 1)
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

template <typename T>
int launch(const void* const* m, const void* y5, const void* g5,
           const void* const* v, void* gxe, void* gxo, int B, int H,
           int wlh, int wl5, cudaStream_t s) {
  const size_t smem = sizeof(T) * (size_t)Chain::ELEMS;
  cudaError_t e = cudaFuncSetAttribute(
      fused_stem_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H / Chain::TX, H / Chain::TX, B);
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
