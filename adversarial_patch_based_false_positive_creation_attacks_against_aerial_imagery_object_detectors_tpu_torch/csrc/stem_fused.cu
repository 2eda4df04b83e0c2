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
// ~295 FLOP/byte ridge. Each block owns a TILE x TILE tile of y5 for all
// 128 channels and computes backwards over its receptive field entirely in
// shared memory (x 41^2 -> y0 39^2x32 -> y1 19^2x64 -> y2 19^2x32 ->
// s4 17^2x64 -> y5 8^2x128 at TILE 8), so no intermediate touches device
// memory; the halo recompute costs ~1.35x the FLOPs.
//
// bfloat16 (TILE 8; fused_stem_fwd_wg_kernel) is built for Hopper's units
// (stem_common.cuh: wg): the five convs are implicit GEMMs on
// wgmma.mma_async (M the tile's positions in items of 64-row blocks, N
// COUT, K CIN x taps; A from registers by ldmatrix, B from shared
// memory), issued by two consumer warpgroups, with K1's epilogue
// (stem_common.cuh: EpiConv: bias, leaky, round, the sign byte, the
// shortcut sum, zero outside the image). The weights, packed on the host
// in the descriptor's 128-byte-swizzled K-major chunks (ops/stem_fused.py:
// wg_weights; conv0's 3 channels padded to 8, two taps of a row a 16-deep
// step as RowsConv0 pairs them: K 96 for 27 real), reach shared memory by
// cp.async.bulk into a ring of seven 8 KB slots, which a producer warp
// keeps in flight while the consumers run the MMAs: no consumer reads a
// weight from L1 or L2. Convs 0-3 take several passes over the tile and
// are resident (loaded once a tile, 8 + 40 + 4 + 40 KB; conv1's and conv3's
// five slots leave two for the next conv's first chunks); conv5 streams
// (nine 16 KB chunks, each over two slots, one a warpgroup's 64 output
// channels): 236 KB a tile from L2. The x tile comes in 16-byte loads of
// 8 lanes. The tiles' row pitches stay padded by 16 bytes (P32/P64/P128)
// so that the eight rows of an ldmatrix phase fall in distinct bank groups
// at stride 1 (two-way at stride 2). With save_acts every mask word is 16
// bytes (save_mask16: at TILE 8 a block's own region is 16 lanes of each
// (row, channel) line). What bounds this design: one block a multiprocessor
// (232,144 bytes: the tiles' 173,664 and the ring's 58,480; registers are
// allotted by warpgroup, 168 a thread for the three), so its serial parts
// (the epilogues, the mask and y5 stores) leave the tensor cores idle; the
// y5 tile cannot grow past 8 beside the ring, and its halo stays (1.35x).
// float32 (TILE 4) runs every conv on conv_stage's FMAs: TF32 tensor cores
// would not hold the float32 gradient checks.
//
// Conv padding applies to each layer's input, so every halo position of
// y0, y1, y2 and s4 that lies outside the image is stored as zero (not
// leaky(bias)), as the Pallas kernel's in-range scale does.
//
// Shared memory at peak: bfloat16 TILE 8 = 173,664 bytes of tiles (y0, y1;
// x sits in y1's region until conv1; y2, s4 and, with save_acts, y3's sign
// bytes reuse y0's region once conv1 has read it and y0's masks are
// stored, y5 reuses y1's) and the ring; float32 TILE 4 = 106,208 bytes (x
// in a region of its own).

#include <type_traits>

#include "stem_common.cuh"

namespace {

using namespace stem;

// Sign masks of one own (non-halo) N x N region of a tile of side TW with
// row pitch P (C channels a position), whose first own position is
// (off, off) in the tile and (r0, c0) in the image, into a planar int8
// tensor [B, rows, C, wl]: 1 where the value is > 0, else 0, and 0 at
// columns outside the image. PHASE splits the columns into the even (d0)
// and odd (d1) column phases, value j at lane j + 1, as the y0 masks are;
// otherwise column c goes to lane c + 1 of d0. Each thread stores one
// aligned 4-byte word of one channel, channels fastest (a warp's tile
// reads then fall in distinct banks or share a word): the block writes
// lanes [l0, l0 + n) of its rows (l0 = c0, or c0 / 2 with PHASE, a
// multiple of 4; n the own columns a phase), so lane l0 holds the column
// left of its own region, read from the tile's halo, and no lane is
// written by two blocks. The
// block of the last tile column writes one word more where its own last
// column is the image's (no right neighbour holds it) and zeroes the rest
// of its rows' lanes, all past the image.
template <typename V, int C, int P, int N, bool PHASE>
__device__ void save_mask(const V* __restrict__ tile, int TW, int off,
                          int r0, int c0, int8_t* __restrict__ d0,
                          int8_t* __restrict__ d1, int rows, int wl, int b,
                          bool last) {
  constexpr int NPH = PHASE ? 2 : 1;
  constexpr int NQ = N / NPH / 4;  // words of one phase of a row
  const int l0 = PHASE ? c0 / 2 : c0;
  const bool extra = last && c0 + N <= rows;
  for (int idx = threadIdx.x; idx < N * C * NPH * (NQ + 1); idx += NT) {
    const int ch = idx % C;
    int rest = idx / C;
    const int ph = rest % NPH;
    rest /= NPH;
    const int q = rest % (NQ + 1), rr = rest / (NQ + 1);
    // square images: the last tile row may reach past the image
    if (r0 + rr >= rows || (q == NQ && !extra)) continue;
    const V* t = tile + (rr + off) * TW * P + ch;
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * q + i - 1;  // lane l0 + 4q + i holds own column j
      const int col = PHASE ? 2 * j + ph : j;
      if (c0 + col >= 0 && c0 + col < rows &&
          to_f(t[(col + off) * P]) > 0.f)
        word |= 1u << (8 * i);
    }
    int8_t* d = ph ? d1 : d0;
    *reinterpret_cast<uint32_t*>(
        d + (((long long)b * rows + r0 + rr) * C + ch) * wl + l0 + 4 * q) =
        word;
  }
  if (last) {
    const int n = min(N, rows - r0) * C;  // the own rows' lines
    const long long o = ((long long)b * rows + r0) * C * wl;
    const int lz = l0 + 4 * (NQ + (extra ? 1 : 0));
    zero_tail(d0 + o, n, lz, wl);
    if (PHASE) zero_tail(d1 + o, n, lz, wl);
  }
}

// PAD: elements added to each position's row (bfloat16 8, float32 0)
template <int TILE, int PAD>
struct Geom {
  static constexpr int S4N = 2 * TILE + 1;  // s4 / y3 tile side
  static constexpr int Y1N = S4N + 2;       // y1 / y2 tile side
  static constexpr int Y0N = 2 * Y1N + 1;   // y0 tile side
  static constexpr int XN = Y0N + 2;        // x tile side
  // row pitches of the 32-, 64- and 128-channel tiles
  static constexpr int P32 = 32 + PAD, P64 = 64 + PAD, P128 = 128 + PAD;
  // the x tile: float32 [XN^2][3] in a region of its own (A); bfloat16
  // [XN^2 + 1][8] in y1's region (channels 3..7 and the last position
  // zero, read by conv0's tensor-core taps with zero weights)
  static constexpr int XC = PAD ? 8 : 3;
  static constexpr int XP = XN * XN + (PAD ? 1 : 0);
  static constexpr int XE = (XP * XC + 7) / 8 * 8;
  static constexpr int A = PAD ? 0 : XE;
  static constexpr int Y2 = Y1N * Y1N * P32;
  static constexpr int B0 = Y0N * Y0N * P32;
  static constexpr int B1 = Y2 + S4N * S4N * P64;
  static constexpr int B = B0 > B1 ? B0 : B1;
  static constexpr int C0 = Y1N * Y1N * P64;
  static constexpr int C1 = TILE * TILE * P128;
  static constexpr int C01 = C0 > C1 ? C0 : C1;
  static constexpr int C = PAD && XE > C01 ? XE : C01;
  static constexpr int ELEMS = A + B + C;
  // y3's signs (SAVE) past s4 in y0's region
  static constexpr int SIGN_AT = Y2 + S4N * S4N * P64;
  static constexpr int SIGN_BYTES = S4N * S4N * 64;
};

// The int8 sign masks of save_acts, planar as the Pallas kernel's outputs:
// y0 as even/odd column phases [B, H, 32, wlh], y1 and y3 [B, H/2, 64, wlh],
// y2 [B, H/2, 32, wlh]. All null when the forward saves nothing.
struct Masks {
  int8_t* y0e;
  int8_t* y0o;
  int8_t* y1;
  int8_t* y2;
  int8_t* y3;
};

// The float32 K1 (TILE 4): every conv on conv_stage's CUDA-core FMAs, one
// block a multiprocessor
template <int TILE, bool SAVE>
__global__ void __launch_bounds__(NT, 1)
    fused_stem_fwd_kernel(const float* __restrict__ xe,
                          const float* __restrict__ xo,
                          const float* __restrict__ w0,
                          const float* __restrict__ w1,
                          const float* __restrict__ w2,
                          const float* __restrict__ w3,
                          const float* __restrict__ w5,
                          const float* __restrict__ b0,
                          const float* __restrict__ b1,
                          const float* __restrict__ b2,
                          const float* __restrict__ b3,
                          const float* __restrict__ b5,
                          float* __restrict__ y5, Masks mk, int H, int wlh,
                          int wl5) {
  using T = float;
  using G = Geom<TILE, 0>;
  static_assert(sizeof(T) * (G::B - G::SIGN_AT) >= G::SIGN_BYTES,
                "y3 signs past s4");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* y0 = reinterpret_cast<T*>(smem_raw) + G::A;  // [Y0N][Y0N][P32]
  T* y2 = y0;                              // [Y1N][Y1N][P32], after conv1
  T* s4 = y0 + G::Y2;                      // [S4N][S4N][P64]
  T* y1 = y0 + G::B;                       // [Y1N][Y1N][P64]
  T* ys = y1;                              // [TILE][TILE][P128], after conv3
  T* xs = reinterpret_cast<T*>(smem_raw);  // [XP][XC]
  // [S4N][S4N][64] signs of y3 (SAVE only), past s4
  unsigned char* y3s = reinterpret_cast<unsigned char*>(y0 + G::SIGN_AT);

  const int b = blockIdx.z;
  const int R5 = blockIdx.y * TILE, C5 = blockIdx.x * TILE;
  const int H1 = H / 2, H5 = H / 4;
  const bool first = blockIdx.x == 0, last = blockIdx.x == gridDim.x - 1;

  // x tile, image rows/cols from 4*R5 - 6; column c of x is lane c/2 + 1
  // of the even (c even) or odd phase. Columns run fastest, so that a
  // warp reads neighbouring lanes of both phases
  const int xr0 = 4 * R5 - 6, xc0 = 4 * C5 - 6;
  for (int idx = threadIdx.x; idx < G::XN * G::XN * G::XC; idx += NT) {
    const int col = idx % G::XN;
    const int rest = idx / G::XN;
    const int ci = rest % G::XC, r = rest / G::XC;
    const int gr = xr0 + r, gc = xc0 + col;
    T v = 0.f;
    if (ci < 3 && gr >= 0 && gr < H && gc >= 0 && gc < H) {
      const T* src = (gc & 1) ? xo : xe;
      v = src[(((long long)b * H + gr) * 8 + ci) * wlh + (gc >> 1) + 1];
    }
    xs[(r * G::XN + col) * G::XC + ci] = v;
  }
  __syncthreads();
  conv_stage<T, 3, 32, 3, 1, 4>(xs, G::XN, y0, G::Y0N, G::Y0N, w0, b0,
                                4 * R5 - 5, 4 * C5 - 5, H, nullptr, 0);
  __syncthreads();
  // the own region of each layer: y0 rows/cols [4 R5, 4 R5 + 4 TILE) at
  // tile offset 5, y1 and y2 [2 R5, 2 R5 + 2 TILE) at offset 2, y3 at
  // offset 1; the tiles of all blocks partition the image
  if (SAVE)
    save_mask<T, 32, G::P32, 4 * TILE, true>(y0, G::Y0N, 5, 4 * R5, 4 * C5,
                                             mk.y0e, mk.y0o, H, wlh, b, last);
  conv_stage<T, 32, 64, 3, 2, 4>(y0, G::Y0N, y1, G::Y1N, G::Y1N, w1, b1,
                                 2 * R5 - 2, 2 * C5 - 2, H1, nullptr, 0);
  __syncthreads();
  if (SAVE)
    save_mask<T, 64, G::P64, 2 * TILE, false>(y1, G::Y1N, 2, 2 * R5, 2 * C5,
                                              mk.y1, nullptr, H1, wlh, b,
                                              last);
  conv_stage<T, 64, 32, 1, 1, 4>(y1, G::Y1N, y2, G::Y1N, G::Y1N, w2, b2,
                                 2 * R5 - 2, 2 * C5 - 2, H1, nullptr, 0);
  __syncthreads();
  if (SAVE)
    save_mask<T, 32, G::P32, 2 * TILE, false>(y2, G::Y1N, 2, 2 * R5, 2 * C5,
                                              mk.y2, nullptr, H1, wlh, b,
                                              last);
  conv_stage<T, 32, 64, 3, 1, 4, SAVE>(y2, G::Y1N, s4, G::S4N, G::S4N, w3,
                                       b3, 2 * R5 - 1, 2 * C5 - 1, H1, y1,
                                       G::Y1N, y3s);
  __syncthreads();
  if (SAVE)
    save_mask<unsigned char, 64, 64, 2 * TILE, false>(
        y3s, G::S4N, 1, 2 * R5, 2 * C5, mk.y3, nullptr, H1, wlh, b, last);
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
          ys[(rr * TILE + cc) * G::P128 + co];
  }
  // zero border and padding lanes of this tile row: lane 0 (first tile
  // column) and lanes H5+1 .. wl5-1 (last tile column)
  const int n5 = min(TILE, H5 - R5) * 128;  // the tile row's lines
  T* y5r = y5 + ((long long)b * H5 + R5) * 128 * wl5;
  if (first)
    for (int line = threadIdx.x; line < n5; line += NT)
      y5r[(long long)line * wl5] = 0.f;
  if (last) zero_tail(y5r, n5, H5 + 1, wl5);
}

constexpr int F32_TILE = 4;
constexpr size_t F32_SMEM = sizeof(float) * (size_t)Geom<F32_TILE, 0>::ELEMS;

// ---------------------------------------------------------------------------
// The bfloat16 K1 on wgmma, its weights streamed by a producer warp
// ---------------------------------------------------------------------------

// Sign masks as save_mask's, each word 16 bytes: a block's own region is N
// columns, N / NPH lanes a phase, a multiple of 16 (at TILE 8 one word a
// (row, channel, phase) line); lane l0 + 16 q + i holds own column
// 16 q + i - 1. A thread takes one word's 16 columns for 4 channels (one
// 8-byte shared load of a position's 4 channels, 4 bytes for the sign
// tile) and stores the 4 words. Run by the NC consumer threads.
template <typename V, int C, int P, int N, bool PHASE>
__device__ void save_mask16(const V* __restrict__ tile, int TW, int off,
                            int r0, int c0, int8_t* __restrict__ d0,
                            int8_t* __restrict__ d1, int rows, int wl,
                            int b, bool last) {
  constexpr int NPH = PHASE ? 2 : 1;
  constexpr int NQ = N / NPH / 16;  // words of one phase of a row
  constexpr int CG = C / 4;         // channel groups
  static_assert(N % (16 * NPH) == 0 && C % 4 == 0, "16-byte words");
  using Vec = typename std::conditional<sizeof(V) == 2, uint2, uint32_t>::type;
  const int l0 = PHASE ? c0 / 2 : c0;
  // the last tile column's extra word: its own last column is the image's
  const bool extra = last && c0 + N <= rows;
  const int nr = min(N, rows - r0);  // square images: the last tile row
#pragma unroll 1
  for (int q = 0; q <= NQ; ++q) {
    if (q == NQ && !extra) break;
    for (int idx = threadIdx.x; idx < nr * NPH * CG; idx += wg::NC) {
      const int cg = idx % CG;
      const int ph = (idx / CG) % NPH, rr = idx / (CG * NPH);
      const V* t = tile + (rr + off) * TW * P + 4 * cg;
      uint32_t word[4][4] = {};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int j = 16 * q + i - 1;
        const int col = PHASE ? 2 * j + ph : j;
        if (c0 + col < 0 || c0 + col >= rows) continue;
        const Vec v = *reinterpret_cast<const Vec*>(t + (col + off) * P);
        const V* e = reinterpret_cast<const V*>(&v);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (to_f(e[c]) > 0.f) word[c][i / 4] |= 1u << (8 * (i % 4));
      }
      int8_t* d = (ph ? d1 : d0) +
                  (((long long)b * rows + r0 + rr) * C + 4 * cg) * wl + l0 +
                  16 * q;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<uint4*>(d + (long long)c * wl) =
            make_uint4(word[c][0], word[c][1], word[c][2], word[c][3]);
    }
  }
  if (last) {
    const long long o = ((long long)b * rows + r0) * C * wl;
    const int lz = l0 + 16 * (NQ + (extra ? 1 : 0));
    zero_tail(d0 + o, nr * C, lz, wl, wg::NC);
    if (PHASE) zero_tail(d1 + o, nr * C, lz, wl, wg::NC);
  }
}

namespace k1 {
constexpr int TILE = 8;
using G = Geom<TILE, 8>;
// the five GEMMs: taps, depth a tap, COUT, channel groups, 64-row blocks an
// item, rows; the ring: seven 8 KB slots. Convs 0-3 are resident (loaded
// once, read by every pass; conv1's and conv3's five slots leave two for
// the next GEMM's first chunks), conv5 streams (a 16 KB chunk over two
// slots, one a warpgroup's channel group)
constexpr int STAGES = 7, SLOT = 8192;
using C0 = wg::Gemm<6, 16, 32, 1, 2, G::Y0N * G::Y0N, SLOT, STAGES>;
using C1 = wg::Gemm<9, 32, 64, 1, 1, G::Y1N * G::Y1N, SLOT, STAGES>;
using C2 = wg::Gemm<1, 64, 32, 1, 1, G::Y1N * G::Y1N, SLOT, STAGES>;
using C3 = wg::Gemm<9, 32, 64, 1, 1, G::S4N * G::S4N, SLOT, STAGES>;
using C5 = wg::Gemm<9, 64, 128, 2, 1, TILE * TILE, SLOT, STAGES>;
static_assert(C0::RES && C1::RES && C2::RES && C3::RES && !C5::RES,
              "the ring's plan");
constexpr int TILE_BYTES = 2 * G::ELEMS;
constexpr int SMEM = TILE_BYTES + wg::ring_bytes(STAGES, SLOT);
static_assert(SMEM <= 232448, "shared memory");
// the packed weights of convs 0, 1, 2, 3, 5 (wg_weights)
struct Weights {
  const unsigned char* w[5];
};
}  // namespace k1

template <bool SAVE>
__global__ void __launch_bounds__(wg::NTH, 1)
    fused_stem_fwd_wg_kernel(const bf16* __restrict__ xe,
                             const bf16* __restrict__ xo,
                             const float* __restrict__ b0,
                             const float* __restrict__ b1,
                             const float* __restrict__ b2,
                             const float* __restrict__ b3,
                             const float* __restrict__ b5, k1::Weights ww,
                             bf16* __restrict__ y5, Masks mk, int H, int wlh,
                             int wl5) {
  using namespace k1;
  static_assert(2 * (G::B - G::SIGN_AT) >= G::SIGN_BYTES, "y3 signs past s4");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* y0 = reinterpret_cast<bf16*>(smem_raw);  // [Y0N][Y0N][P32]
  bf16* y2 = y0;                          // [Y1N][Y1N][P32], after conv1
  bf16* s4 = y0 + G::Y2;                  // [S4N][S4N][P64]
  bf16* y1 = y0 + G::B;                   // [Y1N][Y1N][P64]
  bf16* ys = y1;                          // [TILE][TILE][P128], after conv3
  bf16* xs = y1;                          // [XP][8], before conv1 writes y1
  // [S4N][S4N][64] signs of y3 (SAVE only), past s4
  unsigned char* y3s = reinterpret_cast<unsigned char*>(y0 + G::SIGN_AT);
  auto ring = wg::make_ring<STAGES, SLOT>(wg::smem_u32(smem_raw + TILE_BYTES));
  __syncthreads();
  if (threadIdx.x >= wg::NC) {
    // the producer warp: one thread streams every GEMM's chunks in order
    if (threadIdx.x == wg::NC) {
      wg::produce<C0>(ring, ww.w[0]);
      wg::produce<C1>(ring, ww.w[1]);
      wg::produce<C2>(ring, ww.w[2]);
      wg::produce<C3>(ring, ww.w[3]);
      wg::produce<C5>(ring, ww.w[4]);
    }
    return;
  }

  const int b = blockIdx.z;
  const int R5 = blockIdx.y * TILE, C5r = blockIdx.x * TILE;
  const int H1 = H / 2, H5 = H / 4;
  const bool first = blockIdx.x == 0, last = blockIdx.x == gridDim.x - 1;

  // x tile [XN^2 + 1][8], image rows/cols from 4*R5 - 6; column c of x is
  // lane c/2 + 1 of the even (c even) or odd phase. A thread takes 8 lanes
  // of one row and phase, 16 bytes from each of the three channels, from
  // the 16-byte boundary 8 lanes below the tile's first (four such runs a
  // row and phase cover its 21 lanes), and writes each column's whole
  // 16-byte position (channels 3..7 zero); the last position is zero
  // (read by conv0's paired taps with zero weights)
  wg::Lap lap;
  const int xr0 = 4 * R5 - 6, xc0 = 4 * C5r - 6;
  const int lv0 = 16 * blockIdx.x - 8;  // = (xc0 >> 1) + 1 rounded down
  for (int idx = threadIdx.x; idx < G::XN * 2 * 4; idx += wg::NC) {
    const int v = idx % 4, ph = (idx / 4) % 2, r = idx / 8;
    const int gr = xr0 + r, l = lv0 + 8 * v;
    uint4 ch[3] = {};
    if (gr >= 0 && gr < H && l >= 0 && l + 8 <= wlh) {
      const bf16* src = (ph ? xo : xe) + ((long long)b * H + gr) * 8 * wlh + l;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        ch[c] = __ldg(reinterpret_cast<const uint4*>(src + c * wlh));
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int gc = 2 * (l + k - 1) + ph, col = gc - xc0;
      if (col < 0 || col >= G::XN) continue;
      const bool in = gc >= 0 && gc < H;
      uint32_t u[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const uint32_t w = reinterpret_cast<const uint32_t*>(&ch[c])[k / 2];
        u[c] = in ? (k & 1 ? w >> 16 : w & 0xffffu) : 0u;
      }
      *reinterpret_cast<uint4*>(xs + (r * G::XN + col) * 8) =
          make_uint4(u[0] | (u[1] << 16), u[2], 0u, 0u);
    }
  }
  if (threadIdx.x < 8)
    xs[G::XN * G::XN * 8 + threadIdx.x] = __float2bfloat16_rn(0.f);
  lap(wg::P_LOAD);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  wg::conv<C0, 8>(ring, xs, RowsConv0{G::Y0N, G::XN},
                  EpiConv<G::P32, false, false>{y0, G::Y0N, b0, 4 * R5 - 5,
                                                4 * C5r - 5, H, nullptr, 0,
                                                nullptr},
                  lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  // the own region of each layer: y0 rows/cols [4 R5, 4 R5 + 4 TILE) at
  // tile offset 5, y1 and y2 [2 R5, 2 R5 + 2 TILE) at offset 2, y3 at
  // offset 1; the tiles of all blocks partition the image
  if (SAVE)
    save_mask16<bf16, 32, G::P32, 4 * TILE, true>(
        y0, G::Y0N, 5, 4 * R5, 4 * C5r, mk.y0e, mk.y0o, H, wlh, b, last);
  lap(wg::P_MASK);
  wg::conv<C1, G::P32>(
      ring, y0, RowsConv<3, 2>{G::Y1N, G::Y0N},
      EpiConv<G::P64, false, false>{y1, G::Y1N, b1, 2 * R5 - 2, 2 * C5r - 2,
                                    H1, nullptr, 0, nullptr},
      lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  if (SAVE)
    save_mask16<bf16, 64, G::P64, 2 * TILE, false>(
        y1, G::Y1N, 2, 2 * R5, 2 * C5r, mk.y1, nullptr, H1, wlh, b, last);
  lap(wg::P_MASK);
  wg::conv<C2, G::P64>(
      ring, y1, RowsConv<1, 1>{G::Y1N, G::Y1N},
      EpiConv<G::P32, false, false>{y2, G::Y1N, b2, 2 * R5 - 2, 2 * C5r - 2,
                                    H1, nullptr, 0, nullptr},
      lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  if (SAVE)
    save_mask16<bf16, 32, G::P32, 2 * TILE, false>(
        y2, G::Y1N, 2, 2 * R5, 2 * C5r, mk.y2, nullptr, H1, wlh, b, last);
  lap(wg::P_MASK);
  wg::conv<C3, G::P32>(
      ring, y2, RowsConv<3, 1>{G::S4N, G::Y1N},
      EpiConv<G::P64, SAVE, true, G::P64>{s4, G::S4N, b3, 2 * R5 - 1,
                                          2 * C5r - 1, H1, y1, G::Y1N, y3s},
      lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  if (SAVE)
    save_mask16<unsigned char, 64, 64, 2 * TILE, false>(
        y3s, G::S4N, 1, 2 * R5, 2 * C5r, mk.y3, nullptr, H1, wlh, b, last);
  lap(wg::P_MASK);
  wg::conv<C5, G::P64>(ring, s4, RowsConv<3, 2>{TILE, G::S4N},
                       EpiConv<G::P128, false, false>{
                           ys, TILE, b5, 0, 0, 0x7fffffff, nullptr, 0,
                           nullptr}, lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  // y5 tile -> planar rows, lanes fastest
  for (int idx = threadIdx.x; idx < TILE * 128 * TILE; idx += wg::NC) {
    const int cc = idx % TILE;
    const int rest = idx / TILE;
    const int co = rest % 128, rr = rest / 128;
    const int gr = R5 + rr, gc = C5r + cc;
    if (gr < H5 && gc < H5)
      y5[(((long long)b * H5 + gr) * 128 + co) * wl5 + gc + 1] =
          ys[(rr * TILE + cc) * G::P128 + co];
  }
  // zero border and padding lanes of this tile row: lane 0 (first tile
  // column) and lanes H5+1 .. wl5-1 (last tile column)
  const int n5 = min(TILE, H5 - R5) * 128;  // the tile row's lines
  bf16* y5r = y5 + ((long long)b * H5 + R5) * 128 * wl5;
  if (first)
    for (int line = threadIdx.x; line < n5; line += wg::NC)
      y5r[(long long)line * wl5] = __float2bfloat16_rn(0.f);
  if (last) zero_tail(y5r, n5, H5 + 1, wl5, wg::NC);
  lap(wg::P_STORE);
}

int launch_f32(const void* xe, const void* xo, const void* const* w,
               const float* const* bias, void* y5, Masks mk, int B, int H,
               int wlh, int wl5, cudaStream_t s) {
  auto kernel = mk.y0e != nullptr ? fused_stem_fwd_kernel<F32_TILE, true>
                                  : fused_stem_fwd_kernel<F32_TILE, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F32_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int nt = (H / 4 + F32_TILE - 1) / F32_TILE;
  kernel<<<dim3(nt, nt, B), NT, F32_SMEM, s>>>(
      static_cast<const float*>(xe), static_cast<const float*>(xo),
      static_cast<const float*>(w[0]), static_cast<const float*>(w[1]),
      static_cast<const float*>(w[2]), static_cast<const float*>(w[3]),
      static_cast<const float*>(w[4]), bias[0], bias[1], bias[2], bias[3],
      bias[4], static_cast<float*>(y5), mk, H, wlh, wl5);
  return (int)cudaGetLastError();
}

int launch_wg(const void* xe, const void* xo, const float* const* bias,
              k1::Weights ww, void* y5, Masks mk, int B, int H, int wlh,
              int wl5, cudaStream_t s) {
  auto kernel = mk.y0e != nullptr ? fused_stem_fwd_wg_kernel<true>
                                  : fused_stem_fwd_wg_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, k1::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int nt = (H / 4 + k1::TILE - 1) / k1::TILE;
  kernel<<<dim3(nt, nt, B), wg::NTH, k1::SMEM, s>>>(
      static_cast<const bf16*>(xe), static_cast<const bf16*>(xo), bias[0],
      bias[1], bias[2], bias[3], bias[4], ww, static_cast<bf16*>(y5), mk, H,
      wlh, wl5);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wgmma k16 step against mma.sync's on the same operands
// ---------------------------------------------------------------------------

// One warpgroup computes D = A B for A [64][K] (K a multiple of 64 up to
// 768) and B
// [K][64] twice, one 16-deep step after another from a zero float32
// accumulator: with mma.sync.m16n8k16 (B in mma_weights' fragment order)
// into dm, and with wgmma.m64n64k16 (A from the same ldmatrix registers, B
// from shared memory in wg_weights' packing) into dw, both [64][64].
__global__ void __launch_bounds__(128, 1)
    wgmma_bitcheck_kernel(const bf16* __restrict__ a,
                          const uint2* __restrict__ bf,
                          const unsigned char* __restrict__ bp,
                          float* __restrict__ dm, float* __restrict__ dw,
                          int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int AP = K + 8;  // A's row pitch, elements
  bf16* as = reinterpret_cast<bf16*>(smem_raw);
  const uint32_t bs =
      (wg::smem_u32(smem_raw + 64 * AP * 2) + 1023) & ~1023u;
  const uint32_t bytes = K / 64 * 64 * 128;
  const uint32_t bar = bs + bytes;
  for (int idx = threadIdx.x; idx < 64 * K / 8; idx += 128) {
    const int r = idx / (K / 8), q = idx - r * (K / 8);
    *reinterpret_cast<uint4*>(as + r * AP + 8 * q) =
        __ldg(reinterpret_cast<const uint4*>(a + (long long)r * K + 8 * q));
  }
  if (threadIdx.x == 0) {
    wg::mbar_init(bar, 1);
    wg::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    wg::mbar_expect_tx(bar, bytes);
    wg::bulk_load(bs, bp, bytes, bar);
  }
  wg::mbar_wait(bar, 0);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* ap = as + (16 * w + (lane & 15)) * AP + (lane >> 4) * 8;
  float am[8][4], aw[32];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) am[j][e] = aw[4 * j + e] = 0.f;
  for (int s = 0; s < K / 16; ++s) {
    uint32_t fr[4];
    ldsm_x4(fr, ap + 16 * s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mma_bf16(am[j], fr, __ldg(bf + (s * 8 + j) * 32 + lane));
    wg::fence();
    wg::mma_async<64>(aw, fr,
                      wg::desc_sw128(bs + (s / 4) * 8192 + (s % 4) * 32));
    wg::commit();
    wg::wait<0>();
  }
  const int g = lane >> 2;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = (16 * w + g + 8 * (e >> 1)) * 64 + 8 * j + 2 * (lane & 3) +
                    (e & 1);
      dm[o] = am[j][e];
      dw[o] = aw[4 * j + e];
    }
}

}  // namespace

// dtype: 0 = float32 (TILE 4), 1 = bfloat16 (TILE 8). Weights are HWIO in
// the compute dtype (read in float32), biases float32; f0 .. f5 the
// bfloat16 convs 0, 1, 2, 3, 5 packed for wgmma (wg_weights; null in
// float32). m0e .. m3 are the save_acts sign masks (int8, planar), all
// null for the forward alone (serving), which then runs the kernel
// instantiated without any mask code. Returns cudaGetLastError().
extern "C" int apfp_fused_stem_fwd(const void* xe, const void* xo,
                                   const void* w0, const void* w1,
                                   const void* w2, const void* w3,
                                   const void* w5, const void* b0,
                                   const void* b1, const void* b2,
                                   const void* b3, const void* b5,
                                   const void* f0, const void* f1,
                                   const void* f2, const void* f3,
                                   const void* f5, void* y5,
                                   void* m0e, void* m0o, void* m1, void* m2,
                                   void* m3, int dtype, int B, int H, int wlh,
                                   int wl5, void* stream) {
  const void* w[5] = {w0, w1, w2, w3, w5};
  const float* bias[5] = {
      static_cast<const float*>(b0), static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<const float*>(b3),
      static_cast<const float*>(b5)};
  const Masks mk = {static_cast<int8_t*>(m0e), static_cast<int8_t*>(m0o),
                    static_cast<int8_t*>(m1), static_cast<int8_t*>(m2),
                    static_cast<int8_t*>(m3)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const k1::Weights ww = {{static_cast<const unsigned char*>(f0),
                             static_cast<const unsigned char*>(f1),
                             static_cast<const unsigned char*>(f2),
                             static_cast<const unsigned char*>(f3),
                             static_cast<const unsigned char*>(f5)}};
    return launch_wg(xe, xo, bias, ww, y5, mk, B, H, wlh, wl5, s);
  }
  return launch_f32(xe, xo, w, bias, y5, mk, B, H, wlh, wl5, s);
}

// The kernel instantiation of (dtype, save) as the card sees it: info[0]
// registers a thread, info[1] the dynamic shared memory bytes of a launch,
// info[2] the blocks one multiprocessor holds. Returns the CUDA error.
extern "C" int apfp_fused_stem_fwd_info(int dtype, int save, int* info) {
  if (dtype == 1)
    return save ? info_of(fused_stem_fwd_wg_kernel<true>, k1::SMEM, info,
                          wg::NTH)
                : info_of(fused_stem_fwd_wg_kernel<false>, k1::SMEM, info,
                          wg::NTH);
  return save ? info_of(fused_stem_fwd_kernel<F32_TILE, true>, F32_SMEM, info)
              : info_of(fused_stem_fwd_kernel<F32_TILE, false>, F32_SMEM,
                        info);
}

// wgmma_bitcheck_kernel on a [64][K] (bfloat16), bf (mma_weights of B as
// [1, 1, K, 64]) and bp (wg_weights of the same): the two [64][64] float32
// results into dm and dw. K a multiple of 64 up to 768. Returns the CUDA
// error.
extern "C" int apfp_wgmma_bitcheck(const void* a, const void* bf,
                                   const void* bp, void* dm, void* dw, int K,
                                   void* stream) {
  if (K % 64 || K > 768) return (int)cudaErrorInvalidValue;
  const size_t smem = 64 * (K + 8) * 2 + 1024 + K / 64 * 8192 + 8;
  cudaError_t e = cudaFuncSetAttribute(
      wgmma_bitcheck_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  wgmma_bitcheck_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const uint2*>(bf),
      static_cast<const unsigned char*>(bp), static_cast<float*>(dm),
      static_cast<float*>(dw), K);
  return (int)cudaGetLastError();
}
