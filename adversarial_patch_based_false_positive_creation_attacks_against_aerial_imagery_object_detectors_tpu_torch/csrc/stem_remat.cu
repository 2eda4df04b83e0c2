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
// bfloat16 also both packed for wgmma (K1's and K2's: ops/stem_fused.py:
// wg_weights). Output: gx as even/odd column phases [B, H, 8, wlh], every
// lane written.
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
// bfloat16 (fused_stem_remat_wg_kernel) is built for Hopper's units as K1
// and K2 are (stem_common.cuh: wg), one block a multiprocessor: two
// consumer warpgroups and a producer warp. The recompute is K1's four
// convs as wg::conv GEMMs on K1's packed weights (RowsConv0 with conv0's 3
// channels padded to 8 and two taps of a row a 16-deep step, RowsConv<3,
// 2>, <1, 1>, <3, 1>; K1's chunks, tap order and 16-deep steps, so every
// recomputed value is K1's bit for bit; the row tiling differs, which
// moves no sum); each epilogue is K1's arithmetic and keeps the sign
// (inside the image and > 0) in bit tiles (y0 33^2 x 32, y1 16^2 x 64, y2
// 16^2 x 32, y3 14^2 x 64 bits: 8,996 bytes), a position's words
// assembled by the quad of lanes that holds its row (shuffles) and stored
// whole: a shared-memory atomicOr a channel pair took 55% of the blocks'
// cycles (epilogues) and made K5 slower than its mma.sync form. Then K2's
// chain (stem_common.cuh: wgc::chain) runs with its gates read from the
// bits. The weights stream through K2's ring of six 8 KB slots: conv0's
// 8 KB and conv1's 40 KB stay in it across both y0 chunks (together the
// six slots; streamed twice they would add 48 KB of L2 reads to the
// tile's 322), conv2 (4 KB) and conv3 (40 KB) are resident across their
// passes, then the chain's GEMMs stream (229 KB). The producer issues
// y5's and g5's TMA boxes first (K2's maps, 8 rows x 128 x 16 lanes), so
// they land during the recompute, then every GEMM's chunks in order. The x
// tile comes in 16-byte loads of 8 lanes by the consumers. Shared memory
// (227,312 bytes): one work region holding x [35^2 + 1][8], a y0 chunk
// [17 x 33][40] and y1 [16^2][72] (pitches padded by 16 bytes as K1's),
// then y2 [16^2][40] over x and the y0 chunk; the chain's three regions
// (69,312 bytes) over the work region once the recompute is done; the
// bits; y5's and g5's boxes (65,536); the ring. What bounds this design:
// one block a multiprocessor, whose serial parts (the x loads, the
// epilogues, the gp5 pass, the chain's epilogues) leave
// the tensor cores idle, and the halo recompute. float32 keeps
// stem_common.cuh's conv_stage + grad_chain on CUDA-core FMAs (the float32
// K1's and K2's code, so it too equals K2 on K1's masks bit for bit): sign
// bytes 71,968, work 38,016 elements, 224,032 bytes, one block a
// multiprocessor.

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
// bfloat16: K1's convs and K2's chain on wgmma
// ---------------------------------------------------------------------------

namespace k5 {

constexpr int P32 = 32 + 8, P64 = 64 + 8;  // row pitches (K1's)
constexpr int XPOS = NX * NX + 1;  // x positions (the last zero, RowsConv0)
constexpr int XE = XPOS * 8;       // x elements, 8 channels a position
constexpr int Y0E = Y0_ROWS * NY0 * P32;
constexpr int Y1E = N2 * N2 * P64;
constexpr int Y2E = N2 * N2 * P32;
constexpr int WORK_B = 2 * (XE + Y0E + Y1E);  // the work region, bytes
// sign words (32 channels a word): y0, y1, y2, y3
constexpr int W0 = NY0 * NY0, W1 = N2 * N2 * 2, W2 = N2 * N2, W3 = N3 * N3 * 2;
constexpr int SIGN_WORDS = W0 + W1 + W2 + W3;
// shared memory from a 1024-aligned base (bytes): the work region (the
// chain's regions once the recompute is done), the bits, the biases of
// convs 0-3 (read from shared memory: ptxas hoists an epilogue's loads
// from device memory into the GEMM before it, where their registers
// spill), y5's and g5's boxes, one barrier (the boxes), the ring
constexpr int BITS_AT = (WORK_B + 127) / 128 * 128;
constexpr int NBIAS = 32 + 64 + 32 + 64;
constexpr int BIAS_AT = (BITS_AT + 4 * SIGN_WORDS + 15) / 16 * 16;
constexpr int BOX_AT = (BIAS_AT + 4 * NBIAS + 127) / 128 * 128;
constexpr int BAR_AT = BOX_AT + 2 * wgc::Y5_B;
constexpr int RING_AT = BAR_AT + 16;
constexpr int SMEM =
    1024 + RING_AT + wg::ring_bytes(wgc::STAGES, wgc::SLOT);
static_assert(SMEM <= 232448 && 2 * bwd_tc::ELEMS <= WORK_B, "regions");
static_assert(Y2E <= XE + Y0E && XE % 8 == 0 && Y0E % 8 == 0,
              "16-byte aligned regions");
// K1's four convs (its chunks, taps and 16-deep steps) over this tile's
// rows; conv0 and conv1 run once a y0 chunk (CALLS 2) and stay resident.
// conv0 takes one 64-row block an item (K1's two would pad a chunk's 561
// rows to 768, and hold 48 more registers a thread)
using wgc::SLOT;
using wgc::STAGES;
using Conv0 = wg::Gemm<6, 16, 32, 1, 1, Y0_ROWS * NY0, SLOT, STAGES, 2>;
using Conv1 = wg::Gemm<9, 32, 64, 1, 1, Y1_ROWS * N2, SLOT, STAGES, 2>;
using Conv2 = wg::Gemm<1, 64, 32, 1, 1, N2 * N2, SLOT, STAGES>;
using Conv3 = wg::Gemm<9, 32, 64, 1, 1, N3 * N3, SLOT, STAGES>;
static_assert(Conv0::RES && Conv1::RES && Conv2::RES && Conv3::RES &&
                  Conv0::NSL + Conv1::NSL <= STAGES,
              "the ring's plan");

// K1's packed weights of convs 0-3 (wg_weights)
struct Weights {
  const unsigned char* w[4];
};

// K1's EpiConv arithmetic (y = acc + bias, T(leaky), zero outside
// [0, img)^2) a row at a time (wg's row epilogue): the values stored to
// out [pos][OP] of row width OW (STORE), and the row's signs (inside and
// > 0) as bits [pos][C/32]: the four lanes of a quad hold the item's NN
// channels of the row (a multiple of 32, from n0 & ~31), so each ORs its
// channels' bits into their words, the quad combines them by shuffles and
// its lanes 0 (and 1) store the words
template <int OP, int C, bool STORE>
struct EpiSign {
  static constexpr bool ROWS = true;
  bf16* out;
  int OW;
  const float* bias;
  int org_r, org_c, img;
  uint32_t* bits;
  template <int NN>
  __device__ __forceinline__ void row(bool valid, int oy, int ox, int n0,
                                      const float (&acc)[NN / 2],
                                      int h) const {
    static_assert(NN % 32 == 0 && C % NN == 0, "whole words in one quad");
    constexpr int NW = NN / 32;  // the item's words of the row
    const int gr = org_r + oy, gc = org_c + ox;
    const bool inside = gr >= 0 && gr < img && gc >= 0 && gc < img;
    const int p = oy * OW + ox;
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
    uint32_t w[NW] = {};
#pragma unroll
    for (int j = 0; j < NN / 8; ++j) {
      const int n = n0 + 8 * j;
      float y[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        y[c] = acc[4 * j + 2 * h + c] + bias[n + c];
        y[c] = fmaxf(y[c], y[c] * LEAKY);
      }
      // the pair rounded once; its signs by one bfloat16x2 compare (the
      // stored values' > 0, as K1's masks)
      const __nv_bfloat162 v =
          inside ? __floats2bfloat162_rn(y[0], y[1]) : zero;
      if (STORE && valid)
        *reinterpret_cast<__nv_bfloat162*>(out + p * OP + n) = v;
      const uint32_t m = __hgt2_mask(v, zero);
      w[j / 4] |= ((m & 1u) | ((m >> 15) & 2u)) << (n & 31);
    }
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      w[k] |= __shfl_xor_sync(0xffffffffu, w[k], 1);
      w[k] |= __shfl_xor_sync(0xffffffffu, w[k], 2);
    }
    if (valid && t < NW)
      bits[p * (C / 32) + (n0 >> 5) + t] = t ? w[NW - 1] : w[0];
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

// y0 chunk CALL (rows [16 CALL, 16 CALL + 17) of the y0 tile) from x,
// then the y1 rows [8 CALL, 8 CALL + 8) it feeds; r at conv0's slots
// (chunk 1: a copy of the ring as it stood for chunk 0), past conv1's
// after
template <int CALL, class R>
__device__ __forceinline__ void y0_chunk(R& r, const bf16* xs, bf16* y0,
                                         bf16* y1, const float* b0,
                                         const float* b1, uint32_t* s0,
                                         uint32_t* s1, int x_r, int x_c,
                                         int y1_r, int y1_c, int H,
                                         wg::Lap& lap) {
  constexpr int r0 = CALL * (Y0_ROWS - 1);  // the chunk's first y0 row
  wg::conv<Conv0, 8, CALL>(
      r, xs + r0 * NX * 8, RowsConv0{NY0, NX},
      EpiSign<P32, 32, true>{y0, NY0, b0, x_r + 1 + r0, x_c + 1, H,
                             s0 + r0 * NY0},
      lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  wg::conv<Conv1, P32, CALL>(
      r, y0, RowsConv<3, 2>{N2, NY0},
      EpiSign<P64, 64, true>{y1 + CALL * Y1_ROWS * N2 * P64, N2, b1,
                             y1_r + CALL * Y1_ROWS, y1_c, H / 2,
                             s1 + CALL * Y1_ROWS * N2 * 2},
      lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
}

}  // namespace k5

// The bfloat16 K5: y5's and g5's tensor maps (K2's: 16 lanes x 128 x 8
// rows), K1's packed weights of convs 0-3 and its biases, K2's packed
// adjoints.
__global__ void __launch_bounds__(wg::NTH, 1)
    fused_stem_remat_wg_kernel(const bf16* __restrict__ xe,
                               const bf16* __restrict__ xo,
                               const float* __restrict__ b0,
                               const float* __restrict__ b1,
                               const float* __restrict__ b2,
                               const float* __restrict__ b3,
                               const __grid_constant__ CUtensorMap ty5,
                               const __grid_constant__ CUtensorMap tg5,
                               k5::Weights fw, wgc::Weights uw,
                               bf16* __restrict__ gxe, bf16* __restrict__ gxo,
                               int H, int wlh) {
  using namespace k5;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sa = wg::smem_u32(sm);
  const uint32_t bar_in = sa + BAR_AT;
  auto ring = wg::make_ring<STAGES, SLOT>(sa + RING_AT);
  if (threadIdx.x == 0) {
    wg::mbar_init(bar_in, 1);
    wg::fence_barrier_init();
  }
  __syncthreads();
  const int b = blockIdx.z;
  const int R0 = blockIdx.y * TX, C0 = blockIdx.x * TX;
  const int H1 = H / 2, H5 = H / 4;
  const int o5r = R0 / 4 - 1, o5c = C0 / 4 - 1;  // gp5 tile origin
  const int l5 = (o5c + 1) & ~7;                 // y5's and g5's boxes
  if (threadIdx.x >= wg::NC) {
    // the producer warp: y5's and g5's boxes first (they land during the
    // recompute), then K1's convs' chunks and the chain's, in order
    if (threadIdx.x == wg::NC) {
      wg::mbar_expect_tx(bar_in, 2 * wgc::Y5_B);
      wg::tma_load_4d(sa + BOX_AT, &ty5, l5, 0, o5r, b, bar_in);
      wg::tma_load_4d(sa + BOX_AT + wgc::Y5_B, &tg5, l5, 0, o5r, b, bar_in);
      wg::produce<Conv0>(ring, fw.w[0]);
      wg::produce<Conv1>(ring, fw.w[1]);
      wg::produce<Conv2>(ring, fw.w[2]);
      wg::produce<Conv3>(ring, fw.w[3]);
      wgc::produce(ring, uw, [] {});
    }
    return;
  }

  uint32_t* s0 = reinterpret_cast<uint32_t*>(sm + BITS_AT);  // y0 [NY0^2]
  uint32_t* s1 = s0 + W0;                                     // y1 [N2^2][2]
  uint32_t* s2 = s1 + W1;                                     // y2 [N2^2]
  uint32_t* s3 = s2 + W2;                                     // y3 [N3^2][2]
  bf16* W = reinterpret_cast<bf16*>(sm);
  bf16* xs = W;         // x [XPOS][8]
  bf16* y0 = W + XE;    // one chunk of y0 [Y0_ROWS * NY0][P32]
  bf16* y1 = y0 + Y0E;  // y1 [N2^2][P64]
  bf16* y2 = W;         // y2 [N2^2][P32], once conv1 is done
  float* sb = reinterpret_cast<float*>(sm + BIAS_AT);  // the biases
  const int x_r = R0 - 8, x_c = C0 - 8;            // x tile origin
  const int y1_r = R0 / 2 - 3, y1_c = C0 / 2 - 3;  // y1 / y2 tile origin

  wg::Lap lap;
  if (threadIdx.x < NBIAS) {
    const int i = threadIdx.x;
    sb[i] = i < 32 ? b0[i] : i < 96 ? b1[i - 32] : i < 128 ? b2[i - 96]
                                                     : b3[i - 128];
  }
  // x tile [XPOS][8]; column c of x is lane c/2 + 1 of the even (c even)
  // or odd phase. A thread takes 8 lanes of one row and phase, 16 bytes
  // from each of the three channels, from the 16-byte boundary 8 lanes
  // below the tile's block (three such runs a row and phase cover its 18
  // lanes), and writes each column's whole 16-byte position (channels
  // 3..7 zero); the last position is zero (read by conv0's paired taps
  // with zero weights)
  const int lv0 = 8 * blockIdx.x - 8;  // ((x_c >> 1) + 1) rounded down to 8
  for (int idx = threadIdx.x; idx < NX * 2 * 3; idx += wg::NC) {
    const int v = idx % 3, ph = (idx / 3) % 2, r = idx / 6;
    const int gr = x_r + r, l = lv0 + 8 * v;
    uint4 ch[3] = {};
    if (gr >= 0 && gr < H && l >= 0 && l + 8 <= wlh) {
      const bf16* src = (ph ? xo : xe) + ((long long)b * H + gr) * 8 * wlh + l;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        ch[c] = __ldg(reinterpret_cast<const uint4*>(src + c * wlh));
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int gc = 2 * (l + k - 1) + ph, col = gc - x_c;
      if (col < 0 || col >= NX) continue;
      const bool in = gc >= 0 && gc < H;
      uint32_t u[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const uint32_t w = reinterpret_cast<const uint32_t*>(&ch[c])[k / 2];
        u[c] = in ? (k & 1 ? w >> 16 : w & 0xffffu) : 0u;
      }
      *reinterpret_cast<uint4*>(xs + (r * NX + col) * 8) =
          make_uint4(u[0] | (u[1] << 16), u[2], 0u, 0u);
    }
  }
  if (threadIdx.x < 8) xs[NX * NX * 8 + threadIdx.x] = __float2bfloat16_rn(0.f);
  lap(wg::P_LOAD);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  // y0 in two chunks, each then feeding its y1 rows (K1's convs: every sum
  // is the bfloat16 K1's)
  auto r01 = ring;  // conv0's and conv1's slots, for chunk 1
  y0_chunk<0>(ring, xs, y0, y1, sb, sb + 32, s0, s1, x_r, x_c, y1_r, y1_c,
              H, lap);
  y0_chunk<1>(r01, xs, y0, y1, sb, sb + 32, s0, s1, x_r, x_c, y1_r, y1_c,
              H, lap);
  wg::conv<Conv2, P64>(ring, y1, RowsConv<1, 1>{N2, N2},
                    EpiSign<P32, 32, true>{y2, N2, sb + 96, y1_r, y1_c, H1,
                                           s2},
                    lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  // y3's sign is that of its own value, before the shortcut sum (K1's
  // save_acts mask): only the sign is kept
  wg::conv<Conv3, P32>(ring, y2, RowsConv<3, 1>{N3, N2},
                    EpiSign<P32, 64, false>{nullptr, N3, sb + 128,
                                            y1_r + 1, y1_c + 1, H1, s3},
                    lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  // gp5 = T(g5 m(y5)) from the boxes into Z (the work region is free)
  wg::mbar_wait(bar_in, 0);
  lap(wg::P_INPUT);
  bf16* Z = W + bwd_tc::SZ_X + bwd_tc::SZ_Y;
  wgc::gp5_from_boxes(Z, reinterpret_cast<const bf16*>(sm + BOX_AT),
                      reinterpret_cast<const bf16*>(sm + BOX_AT + wgc::Y5_B),
                      o5r, o5c, l5, H5);
  lap(wg::P_LOAD);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  // K2's chain, its gates from the bits: gp0 at tile origin R0 - 2 (y0's
  // + 5), gp2 / gp1 at R0/2 - 1 (y1's + 2), gs4 at R0/2 - 2 (y3's own)
  const long long gb = (long long)b * H * 8 * wlh;
  wgc::chain(ring, sm, BitMask<32>{s0, NY0, 5}, BitMask<64>{s1, N2, 2},
             BitMask<32>{s2, N2, 2}, BitMask<64>{s3, N3, 0},
             bwd_tc::EpiGx{gxe + gb, gxo + gb, R0, C0, wlh, H}, wgc::Ready{},
             H, lap);
}

int launch_wg(const void* xe, const void* xo, const void* const* f,
              const float* const* bias, const void* y5, const void* g5,
              const void* const* u, void* gxe, void* gxo, int B, int H,
              int wlh, int wl5, cudaStream_t s) {
  using K = Chain;
  CUtensorMap tm[2];
  int err = wg::planar_map(&tm[0], y5, true, B, H / 4, 128, wl5, wgc::WL5,
                           K::N5);
  err = err ? err : wg::planar_map(&tm[1], g5, true, B, H / 4, 128, wl5,
                                   wgc::WL5, K::N5);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      fused_stem_remat_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      k5::SMEM);
  if (e != cudaSuccess) return (int)e;
  const k5::Weights fw = {{static_cast<const unsigned char*>(f[0]),
                           static_cast<const unsigned char*>(f[1]),
                           static_cast<const unsigned char*>(f[2]),
                           static_cast<const unsigned char*>(f[3])}};
  const wgc::Weights uw = {{static_cast<const unsigned char*>(u[0]),
                            static_cast<const unsigned char*>(u[1]),
                            static_cast<const unsigned char*>(u[2]),
                            static_cast<const unsigned char*>(u[3]),
                            static_cast<const unsigned char*>(u[4])}};
  dim3 grid(H / TX, H / TX, B);
  fused_stem_remat_wg_kernel<<<grid, wg::NTH, k5::SMEM, s>>>(
      static_cast<const bf16*>(xe), static_cast<const bf16*>(xo), bias[0],
      bias[1], bias[2], bias[3], tm[0], tm[1], fw, uw,
      static_cast<bf16*>(gxe), static_cast<bf16*>(gxo), H, wlh);
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
// float32); f0 .. f3 and u0 .. u5 the same forward and backward weights
// packed for wgmma (K1's and K2's wg_weights; read in bfloat16, null in
// float32). H must be a multiple of 16. Returns cudaGetLastError() (or a
// tensor map's error).
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
    return launch_wg(xe, xo, f, bias, y5, g5, u, gxe, gxo, B, H, wlh, wl5, s);
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
    return info_of(fused_stem_remat_wg_kernel, k5::SMEM, info, wg::NTH);
  return info_of(fused_stem_remat_kernel<float>,
                 SIGN_BYTES + sizeof(float) * (size_t)WORK, info);
}
