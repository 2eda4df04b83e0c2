// Fused YOLOv3 stem backward with recompute (K5): the input cotangent of
// layers 0-5 from x, y5 and g5 alone, no saved masks.
//
// Replaces the JAX package's Pallas kernel ops/stem_fused.py
// fused_stem_bwd (body _bwd_kernel: recompute, then _grad_chain). Each
// block owns the 16 x 16 gx tile of K2 (stem_bwd.cu) and first recomputes,
// over that tile's receptive field, the activations whose signs the chain
// gates with: y0, y1, y2 and y3, with stem_common.cuh's conv_stage, the
// very code the float32 K1 (stem_fused.cu) runs. In float32 each element is
// then the same sum in the same order, rounded to the compute dtype before
// its sign is taken, so the recomputed signs equal K1's save_acts masks bit
// for bit, and so does gx equal K2's on those masks (the bfloat16 K1 and K2
// sum on the tensor cores, in another order). Only the sign bytes are
// kept; then
// stem_common.cuh's grad_chain runs with its gates read from them (y5's
// gate comes from the given y5, as the Pallas kernel's does).
//
// Inputs: the even/odd column phases of x, planar [B, H, 8, wlh]; y5 and g5
// planar [B, H/4, 128, wl5]; the forward's HWIO weights and float32 biases
// of convs 0-3 and the backward's swapped-channel weights (K2's). Output:
// gx as even/odd column phases [B, H, 8, wlh], every lane written.
//
// Tile geometry, rows (columns alike), for the gx tile at R0 (a multiple of
// 16): the chain's gates need y3 over 14^2 (origin R0/2 - 2), y1 and y2
// over 11^2 (R0/2 - 1) and y0 over 20^2 (R0 - 2). Recomputing y3 over 14^2
// needs y2 and y1 over 16^2 (R0/2 - 3), hence y0 over 33^2 (R0 - 7) and x
// over 35^2 (R0 - 8). y0 is computed in two chunks of 17 rows (the one row
// they share twice), each followed by the 8 rows of y1 it feeds, so only
// 17 x 33 x 32 values of y0 live at a time.
//
// What bounds it on the H100: operations. The recompute is the design's
// cost: per 608^2 image y0 over 34 x 33 positions a tile is 4.4x its own
// 16^2, y1 and y2 over 16^2 4x their own 8^2, y3 over 14^2 3.1x: ~28
// GFLOP, against 7.8 for y0..y3 without halo; the chain is K2's ~19 (11.2
// useful). So K5 does ~47 GFLOP an image where K1 save_acts + K2 do ~34;
// it trades that for device memory (no masks across the step). CUDA-core
// FMAs with float32 accumulation, as K1 and K2; a wider tile or a row
// stripe that keeps the halo rows between tiles would cut the recompute,
// and tensor cores are later work.
//
// Shared memory: the four sign tiles as bytes (y0 33^2x32, y1 16^2x64, y2
// 16^2x32, y3 14^2x64: 71,968 bytes) stay live to the end; after them one
// work region of 38,016 elements holds x 35^2x3, a y0 chunk 17x33x32 and
// y1 16^2x64, then y2 (over x and y0) and y3's values (over y1, their
// signs only are used), then the chain's three regions (37,888 elements).
// bfloat16 148,000 bytes, float32 224,032 bytes (of 232,448).

#include "stem_common.cuh"

namespace {

using namespace stem;

constexpr int TX = Chain::TX;
constexpr int N3 = Chain::N4;          // y3 tile side (the gs4 tile's)
constexpr int N2 = N3 + 2;             // y1 / y2 tile side
constexpr int NY0 = 2 * N2 + 1;        // y0 tile side
constexpr int NX = NY0 + 2;            // x tile side
constexpr int Y0_ROWS = NY0 / 2 + 1;   // rows of one y0 chunk (17)
constexpr int Y1_ROWS = N2 / 2;        // y1 rows one chunk feeds (8)

constexpr int S0 = NY0 * NY0 * 32;  // sign bytes
constexpr int S1 = N2 * N2 * 64;
constexpr int S2 = N2 * N2 * 32;
constexpr int S3 = N3 * N3 * 64;
constexpr int SIGN_BYTES = S0 + S1 + S2 + S3;
constexpr int XA = (NX * NX * 3 + 7) / 8 * 8;  // work region, elements
constexpr int Y0C = Y0_ROWS * NY0 * 32;
constexpr int Y1 = N2 * N2 * 64;
constexpr int WORK = XA + Y0C + Y1;
static_assert(SIGN_BYTES % 16 == 0, "alignment of the work region");
static_assert(WORK >= Chain::ELEMS, "the chain's regions fit");
static_assert(N2 * N2 * 32 <= XA + Y0C && N3 * N3 * 64 <= Y1, "y2, y3");
static_assert(2 * (Y0_ROWS - 1) + 1 == NY0 && 2 * Y1_ROWS == N2, "chunks");

template <typename T>
__global__ void __launch_bounds__(NT, 1)
    fused_stem_remat_kernel(const T* __restrict__ xe, const T* __restrict__ xo,
                            const T* __restrict__ w0, const T* __restrict__ w1,
                            const T* __restrict__ w2, const T* __restrict__ w3,
                            const float* __restrict__ b0,
                            const float* __restrict__ b1,
                            const float* __restrict__ b2,
                            const float* __restrict__ b3,
                            const T* __restrict__ y5, const T* __restrict__ g5,
                            const T* __restrict__ v0, const T* __restrict__ v1,
                            const T* __restrict__ v2, const T* __restrict__ v3,
                            const T* __restrict__ v5, T* __restrict__ gxe,
                            T* __restrict__ gxo, int H, int wlh, int wl5) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* s0 = smem_raw;  // signs of y0 [NY0^2][32]
  unsigned char* s1 = s0 + S0;   // y1 [N2^2][64]
  unsigned char* s2 = s1 + S1;   // y2 [N2^2][32]
  unsigned char* s3 = s2 + S2;   // y3 [N3^2][64]
  T* W = reinterpret_cast<T*>(smem_raw + SIGN_BYTES);
  T* xs = W;            // x [NX^2][3]
  T* y0 = W + XA;       // one chunk of y0 [Y0_ROWS][NY0][32]
  T* y1 = y0 + Y0C;     // y1 [N2^2][64]
  T* y2 = W;            // y2 [N2^2][32], once conv1 is done
  T* y3 = y1;           // y3 [N3^2][64], once conv2 is done

  const int b = blockIdx.z;
  const int R0 = blockIdx.y * TX, C0 = blockIdx.x * TX;
  const int H1 = H / 2;
  const int x_r = R0 - 8, x_c = C0 - 8;            // x tile origin
  const int y1_r = R0 / 2 - 3, y1_c = C0 / 2 - 3;  // y1 / y2 tile origin

  // x tile; column c of x is lane c/2 + 1 of the even or odd phase
  for (int idx = threadIdx.x; idx < NX * NX * 3; idx += NT) {
    const int ci = idx % 3;
    const int p = idx / 3;
    const int gr = x_r + p / NX, gc = x_c + p % NX;
    T v = from_f<T>(0.f);
    if (gr >= 0 && gr < H && gc >= 0 && gc < H) {
      const T* src = (gc & 1) ? xo : xe;
      v = src[(((long long)b * H + gr) * 8 + ci) * wlh + (gc >> 1) + 1];
    }
    xs[idx] = v;
  }
  __syncthreads();
  // y0 in two chunks of rows [16k, 16k + 17), each then feeding y1 rows
  // [8k, 8k + 8); conv_stage, so every sum is the float32 K1's
  for (int k = 0; k < 2; ++k) {
    const int r0 = k * (Y0_ROWS - 1);
    conv_stage<T, 3, 32, 3, 1, 4, true>(xs + r0 * NX * 3, NX, y0, Y0_ROWS,
                                        NY0, w0, b0, x_r + 1 + r0, x_c + 1,
                                        H, nullptr, 0, s0 + r0 * NY0 * 32);
    __syncthreads();
    conv_stage<T, 32, 64, 3, 2, 4, true>(
        y0, NY0, y1 + k * Y1_ROWS * N2 * 64, Y1_ROWS, N2, w1, b1,
        y1_r + k * Y1_ROWS, y1_c, H1, nullptr, 0,
        s1 + k * Y1_ROWS * N2 * 64);
    __syncthreads();
  }
  conv_stage<T, 64, 32, 1, 1, 4, true>(y1, N2, y2, N2, N2, w2, b2, y1_r, y1_c,
                                       H1, nullptr, 0, s2);
  __syncthreads();
  // y3's sign is that of its own stored value, before the shortcut sum
  conv_stage<T, 32, 64, 3, 1, 4, true>(y2, N2, y3, N3, N3, w3, b3, y1_r + 1,
                                       y1_c + 1, H1, nullptr, 0, s3);
  __syncthreads();
  // the chain's gates: gp0 at tile origin R0 - 2 (y0's + 5), gp2 / gp1 at
  // R0/2 - 1 (y1's + 2), gs4 at R0/2 - 2 (y3's own)
  grad_chain<T>(W, y5, g5, v0, v1, v2, v3, v5, gxe, gxo,
                TileMask<32>{s0, NY0, 5}, TileMask<64>{s1, N2, 2},
                TileMask<32>{s2, N2, 2}, TileMask<64>{s3, N3, 0}, H, wlh,
                wl5);
}

template <typename T>
int launch(const void* xe, const void* xo, const void* const* w,
           const float* const* bias, const void* y5, const void* g5,
           const void* const* v, void* gxe, void* gxo, int B, int H, int wlh,
           int wl5, cudaStream_t s) {
  const size_t smem = SIGN_BYTES + sizeof(T) * (size_t)WORK;
  cudaError_t e = cudaFuncSetAttribute(
      fused_stem_remat_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H / TX, H / TX, B);
  fused_stem_remat_kernel<T><<<grid, NT, smem, s>>>(
      static_cast<const T*>(xe), static_cast<const T*>(xo),
      static_cast<const T*>(w[0]), static_cast<const T*>(w[1]),
      static_cast<const T*>(w[2]), static_cast<const T*>(w[3]), bias[0],
      bias[1], bias[2], bias[3], static_cast<const T*>(y5),
      static_cast<const T*>(g5), static_cast<const T*>(v[0]),
      static_cast<const T*>(v[1]), static_cast<const T*>(v[2]),
      static_cast<const T*>(v[3]), static_cast<const T*>(v[4]),
      static_cast<T*>(gxe), static_cast<T*>(gxo), H, wlh, wl5);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, y5, g5, weights and gx). w0 .. w3
// the forward's HWIO weights of convs 0-3, b0 .. b3 their float32 biases;
// v0 .. v5 K2's swapped-channel weights of convs 0, 1, 2, 3, 5. H must be a
// multiple of 16. Returns cudaGetLastError().
extern "C" int apfp_fused_stem_remat(const void* xe, const void* xo,
                                     const void* w0, const void* w1,
                                     const void* w2, const void* w3,
                                     const void* b0, const void* b1,
                                     const void* b2, const void* b3,
                                     const void* y5, const void* g5,
                                     const void* v0, const void* v1,
                                     const void* v2, const void* v3,
                                     const void* v5, void* gxe, void* gxo,
                                     int dtype, int B, int H, int wlh, int wl5,
                                     void* stream) {
  const void* w[4] = {w0, w1, w2, w3};
  const float* bias[4] = {
      static_cast<const float*>(b0), static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<const float*>(b3)};
  const void* v[5] = {v0, v1, v2, v3, v5};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xe, xo, w, bias, y5, g5, v, gxe, gxo, B, H,
                                 wlh, wl5, s);
  return launch<float>(xe, xo, w, bias, y5, g5, v, gxe, gxo, B, H, wlh, wl5,
                       s);
}
