// Fused YOLOv3 stem backward with recompute (K5): the input cotangent of
// layers 0-5 from x, y5 and g5 alone, no saved masks.
//
// Replaces the JAX package's Pallas kernel ops/stem_fused.py
// fused_stem_bwd (body _bwd_kernel: recompute, then _grad_chain). Each
// block owns the 16 x 16 gx tile of K2 (stem_bwd.cu) and first recomputes,
// over that tile's receptive field, the activations whose signs the chain
// gates with: y0, y1, y2 and y3, each with the very arithmetic K1
// (stem_fused.cu) runs for the same dtype: each element is the same sum in
// the same order, rounded to the compute dtype before its sign is taken,
// so the recomputed signs equal K1's save_acts masks bit for bit, and gx
// equals K2's on those masks. Only the signs are kept; then K2's chain runs
// with its gates read from them (y5's gate comes from the given y5, as the
// Pallas kernel's does).
//
// Inputs: the even/odd column phases of x, planar [B, H, 8, wlh]; y5 and g5
// planar [B, H/4, 128, wl5]; the forward's HWIO weights and float32 biases
// of convs 0-3 and the backward's swapped-channel weights (K2's), in
// bfloat16 also both in mma.sync's fragment order (K1's and K2's). Output:
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
// it trades that for device memory (no masks across the step).
//
// bfloat16 runs on the tensor cores: the recompute is K1's mma_conv calls
// (RowsConv0 with conv0's 3 channels padded to 8 and two taps of a row in
// one 16-deep step, RowsConv<3, 2>, RowsConv<1, 1>, RowsConv<3, 1>; the
// same CIN and weights in fragment order, the same epilogue arithmetic), and
// the chain is K2's (stem_common.cuh: bwd_tc::chain) with its gates read
// from the recomputed signs, bit-packed in shared memory (y0 33^2 x 32,
// y1 16^2 x 64, y2 16^2 x 32, y3 14^2 x 64 bits: 8,996 bytes; set with
// shared-memory atomicOr, as the two channels of an epilogue call share a
// word with 30 others). The warp tiling (MT, NW) differs from K1's, which
// moves no sum: each output's products run over the same taps and 16-deep
// steps in the same order. Shared memory, 110,368 bytes, two blocks a
// multiprocessor: the signs, then one work region holding x [35^2 + 1][8],
// a y0 chunk [17 x 33][40] and y1 [16^2][72] (pitches padded by 16 bytes
// as K1's), then y2 [16^2][40] over x and the y0 chunk; the chain's three
// regions (69,312 bytes) over the whole work region once the recompute is
// done. float32 keeps stem_common.cuh's conv_stage + grad_chain on
// CUDA-core FMAs (the float32 K1's and K2's code, so it too equals K2 on
// K1's masks bit for bit): sign bytes 71,968, work 38,016 elements,
// 224,032 bytes, one block a multiprocessor.

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

// ---------------------------------------------------------------------------
// bfloat16: K1's tensor-core stages, then K2's tensor-core chain
// ---------------------------------------------------------------------------

namespace tcr {

constexpr int P32 = 32 + 8, P64 = 64 + 8;  // row pitches (K1's)
constexpr int XPOS = NX * NX + 1;  // x positions (the last zero, RowsConv0)
constexpr int XE = XPOS * 8;       // x elements, 8 channels a position
constexpr int Y0E = Y0_ROWS * NY0 * P32;
constexpr int Y1E = N2 * N2 * P64;
constexpr int Y2E = N2 * N2 * P32;
constexpr int WORK = XE + Y0E + Y1E;  // bfloat16 elements
// sign words (32 channels a word): y0, y1, y2, y3
constexpr int W0 = NY0 * NY0, W1 = N2 * N2 * 2, W2 = N2 * N2, W3 = N3 * N3 * 2;
constexpr int SIGN_WORDS = (W0 + W1 + W2 + W3 + 3) / 4 * 4;
constexpr int SMEM = SIGN_WORDS * 4 + WORK * 2;
static_assert(Y2E <= XE + Y0E && bwd_tc::ELEMS <= WORK, "regions");
static_assert(XE % 8 == 0 && Y0E % 8 == 0, "16-byte aligned regions");

// K1's EpiConv arithmetic (y = acc + bias, T(leaky), zero outside
// [0, img)^2), the value stored to out [pos][OP] of row width OW (unless
// out is null) and its sign (inside and > 0) OR-ed into bits [pos][C/32]
template <int OP, int C>
struct EpiSign {
  bf16* out;
  int OW;
  const float* bias;
  int org_r, org_c, img;
  uint32_t* bits;
  __device__ void operator()(int oy, int ox, int n, float v0,
                             float v1) const {
    const int gr = org_r + oy, gc = org_c + ox;
    const bool inside = gr >= 0 && gr < img && gc >= 0 && gc < img;
    const int p = oy * OW + ox;
    const float v[2] = {v0, v1};
    float r[2];
    uint32_t sg = 0;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float y = v[c] + bias[n + c];
      const float yt = round_t<bf16>(fmaxf(y, y * LEAKY));
      r[c] = inside ? yt : 0.f;
      if (r[c] > 0.f) sg |= 1u << ((n + c) & 31);
    }
    if (out != nullptr) store2(out + p * OP + n, r[0], r[1]);
    if (sg) atomicOr(bits + p * (C / 32) + (n >> 5), sg);
  }
};

// A gate's sign from a bit tile [pos][C/32] of side TW, whose position
// (off, off) is the epilogue's tile position (0, 0)
template <int C>
struct BitMask {
  const uint32_t* s;
  int TW, off;
  __device__ int8_t operator()(int oy, int ox, int, int, int ch) const {
    return (s[((oy + off) * TW + ox + off) * (C / 32) + (ch >> 5)] >>
            (ch & 31)) & 1u;
  }
};

}  // namespace tcr

// The bfloat16 K5. f0 .. f3: K1's fragment-order weights of convs 0-3
// (conv0 as RowsConv0 reads it); u0 .. u5: K2's.
__global__ void __launch_bounds__(NT, 2)
    fused_stem_remat_tc_kernel(const bf16* __restrict__ xe,
                               const bf16* __restrict__ xo,
                               const uint2* __restrict__ f0,
                               const uint2* __restrict__ f1,
                               const uint2* __restrict__ f2,
                               const uint2* __restrict__ f3,
                               const float* __restrict__ b0,
                               const float* __restrict__ b1,
                               const float* __restrict__ b2,
                               const float* __restrict__ b3,
                               const bf16* __restrict__ y5,
                               const bf16* __restrict__ g5,
                               const uint2* __restrict__ u0,
                               const uint2* __restrict__ u1,
                               const uint2* __restrict__ u2,
                               const uint2* __restrict__ u3,
                               const uint2* __restrict__ u5,
                               bf16* __restrict__ gxe, bf16* __restrict__ gxo,
                               int H, int wlh, int wl5) {
  using namespace tcr;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* s0 = reinterpret_cast<uint32_t*>(smem_raw);  // y0 [NY0^2][1]
  uint32_t* s1 = s0 + W0;                                // y1 [N2^2][2]
  uint32_t* s2 = s1 + W1;                                // y2 [N2^2][1]
  uint32_t* s3 = s2 + W2;                                // y3 [N3^2][2]
  bf16* W = reinterpret_cast<bf16*>(smem_raw + SIGN_WORDS * 4);
  bf16* xs = W;           // x [XPOS][8]
  bf16* y0 = W + XE;      // one chunk of y0 [Y0_ROWS * NY0][P32]
  bf16* y1 = y0 + Y0E;    // y1 [N2^2][P64]
  bf16* y2 = W;           // y2 [N2^2][P32], once conv1 is done

  const int b = blockIdx.z;
  const int R0 = blockIdx.y * TX, C0 = blockIdx.x * TX;
  const int H1 = H / 2;
  const int x_r = R0 - 8, x_c = C0 - 8;            // x tile origin
  const int y1_r = R0 / 2 - 3, y1_c = C0 / 2 - 3;  // y1 / y2 tile origin

  for (int i = threadIdx.x; i < SIGN_WORDS; i += NT) s0[i] = 0u;
  // x tile, columns fastest (a warp reads neighbouring lanes of both
  // phases); channels 3..7 and the last position zero
  for (int idx = threadIdx.x; idx < NX * NX * 8; idx += NT) {
    const int col = idx % NX;
    const int rest = idx / NX;
    const int ci = rest % 8, r = rest / 8;
    const int gr = x_r + r, gc = x_c + col;
    bf16 v = __float2bfloat16_rn(0.f);
    if (ci < 3 && gr >= 0 && gr < H && gc >= 0 && gc < H) {
      const bf16* src = (gc & 1) ? xo : xe;
      v = src[(((long long)b * H + gr) * 8 + ci) * wlh + (gc >> 1) + 1];
    }
    xs[(r * NX + col) * 8 + ci] = v;
  }
  if (threadIdx.x < 8) xs[NX * NX * 8 + threadIdx.x] = __float2bfloat16_rn(0.f);
  __syncthreads();
  // y0 in two chunks of rows [16k, 16k + 17), each then feeding y1 rows
  // [8k, 8k + 8); K1's convs, so every sum is the bfloat16 K1's
  for (int k = 0; k < 2; ++k) {
    const int r0 = k * (Y0_ROWS - 1);
    mma_conv<16, 8, 32, 4, 1>(
        xs + r0 * NX * 8, Y0_ROWS * NY0, f0, RowsConv0{NY0, NX},
        EpiSign<P32, 32>{y0, NY0, b0, x_r + 1 + r0, x_c + 1, H,
                         s0 + r0 * NY0});
    __syncthreads();
    mma_conv<32, P32, 64, 4, 1>(
        y0, Y1_ROWS * N2, f1, RowsConv<3, 2>{N2, NY0},
        EpiSign<P64, 64>{y1 + k * Y1_ROWS * N2 * P64, N2, b1,
                         y1_r + k * Y1_ROWS, y1_c, H1,
                         s1 + k * Y1_ROWS * N2 * 2});
    __syncthreads();
  }
  mma_conv<64, P64, 32, 4, 2>(
      y1, N2 * N2, f2, RowsConv<1, 1>{N2, N2},
      EpiSign<P32, 32>{y2, N2, b2, y1_r, y1_c, H1, s2});
  __syncthreads();
  // y3's sign is that of its own value, before the shortcut sum (K1's
  // save_acts mask): only the sign is kept
  mma_conv<32, P32, 64, 8, 1>(
      y2, N3 * N3, f3, RowsConv<3, 1>{N3, N2},
      EpiSign<P32, 64>{nullptr, N3, b3, y1_r + 1, y1_c + 1, H1, s3});
  __syncthreads();
  // K2's chain over the work region, its gates from the signs: gp0 at tile
  // origin R0 - 2 (y0's + 5), gp2 / gp1 at R0/2 - 1 (y1's + 2), gs4 at
  // R0/2 - 2 (y3's own)
  bwd_tc::load_gp5(W + bwd_tc::SZ_X + bwd_tc::SZ_Y, y5, g5, b, H, wl5);
  __syncthreads();
  bwd_tc::chain(W, u0, u1, u2, u3, u5, BitMask<32>{s0, NY0, 5},
                BitMask<64>{s1, N2, 2}, BitMask<32>{s2, N2, 2},
                BitMask<64>{s3, N3, 0}, gxe, gxo, b, H, wlh);
}

int launch_tc(const void* xe, const void* xo, const void* const* f,
              const float* const* bias, const void* y5, const void* g5,
              const void* const* u, void* gxe, void* gxo, int B, int H,
              int wlh, int wl5, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_stem_remat_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tcr::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H / TX, H / TX, B);
  fused_stem_remat_tc_kernel<<<grid, NT, tcr::SMEM, s>>>(
      static_cast<const bf16*>(xe), static_cast<const bf16*>(xo),
      static_cast<const uint2*>(f[0]), static_cast<const uint2*>(f[1]),
      static_cast<const uint2*>(f[2]), static_cast<const uint2*>(f[3]),
      bias[0], bias[1], bias[2], bias[3], static_cast<const bf16*>(y5),
      static_cast<const bf16*>(g5), static_cast<const uint2*>(u[0]),
      static_cast<const uint2*>(u[1]), static_cast<const uint2*>(u[2]),
      static_cast<const uint2*>(u[3]), static_cast<const uint2*>(u[4]),
      static_cast<bf16*>(gxe), static_cast<bf16*>(gxo), H, wlh, wl5);
  return (int)cudaGetLastError();
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
// v0 .. v5 K2's swapped-channel weights of convs 0, 1, 2, 3, 5 (read in
// float32); f0 .. f3 and u0 .. u5 the same forward and backward weights in
// mma.sync's fragment order (K1's and K2's; read in bfloat16, null in
// float32). H must be a multiple of 16. Returns cudaGetLastError().
extern "C" int apfp_fused_stem_remat(
    const void* xe, const void* xo, const void* w0, const void* w1,
    const void* w2, const void* w3, const void* b0, const void* b1,
    const void* b2, const void* b3, const void* y5, const void* g5,
    const void* v0, const void* v1, const void* v2, const void* v3,
    const void* v5, const void* f0, const void* f1, const void* f2,
    const void* f3, const void* u0, const void* u1, const void* u2,
    const void* u3, const void* u5, void* gxe, void* gxo, int dtype, int B,
    int H, int wlh, int wl5, void* stream) {
  const float* bias[4] = {
      static_cast<const float*>(b0), static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<const float*>(b3)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const void* f[4] = {f0, f1, f2, f3};
    const void* u[5] = {u0, u1, u2, u3, u5};
    return launch_tc(xe, xo, f, bias, y5, g5, u, gxe, gxo, B, H, wlh, wl5, s);
  }
  const void* w[4] = {w0, w1, w2, w3};
  const void* v[5] = {v0, v1, v2, v3, v5};
  return launch<float>(xe, xo, w, bias, y5, g5, v, gxe, gxo, B, H, wlh, wl5,
                       s);
}

// The kernel of dtype as the card sees it: info[0] registers a thread,
// info[1] the dynamic shared memory bytes of a launch, info[2] the blocks
// one multiprocessor holds. Returns the CUDA error.
extern "C" int apfp_fused_stem_remat_info(int dtype, int* info) {
  if (dtype == 1)
    return info_of(fused_stem_remat_tc_kernel, tcr::SMEM, info);
  return info_of(fused_stem_remat_kernel<float>,
                 SIGN_BYTES + sizeof(float) * (size_t)WORK, info);
}
