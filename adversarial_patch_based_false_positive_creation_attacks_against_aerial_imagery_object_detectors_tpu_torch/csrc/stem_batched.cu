// Batch-on-lanes fused YOLOv3 stem: the forward (K8a) and the input
// backward from saved activations (K8b).
//
// Replace the JAX package's Pallas kernels experimental/stem_batched.py
// fused_stem_fwd_b (body _fwd_kernel_b) and fused_stem_bwd_b (body
// _bwd_kernel_b). The layout is that module's: a row of a tensor is
// [C, B * seg], image b's column j at lane b * seg + j + 1 with
// seg = round_up(H/2 + 2, 128), lane 0 and the slack past the values zero.
// Both kernels write every lane of their outputs, so no output needs a
// memset. The batch lives on the lanes only in device memory: each block
// works on one image's tile, as K1, K2 and K5 do.
//
// K8a computes K1's stem (stem_fused.cu) from the even/odd column phases
// of x, [H, 8, B*seg] each, with conv5 at stride (2, 1): y5 lane-dense,
// [H/4, 128, B*seg], value lane j + 1 of a row holding conv5 centred on s4
// column j for every j < H/2, so the even columns are K1's y5 and the odd
// ones the 2x conv5 work the Pallas kernel does by design. With save_acts it
// also writes the activations themselves in the compute dtype T: y0 as
// even/odd column phases [H, 32, B*seg], y1 [H/2, 64, .], y2 [H/2, 32, .]
// and y3 [H/2, 64, .], y3 before the shortcut sum. Rounding points are
// _fwd_kernel_b's: float32 accumulation, each activation rounded to T when
// stored, s4 = T(y3 + y1).
//
// K8b takes the conv5 cotangent gp5dd [H/2, 128, B*seg] and K8a's saved
// activations, and returns the phase-split input cotangent (gxe, gxo),
// [H, 8, B*seg] each. Its input contract is the JAX kernel's: gp5dd is
// already gated by y5's sign and zero-interleaved in rows and lanes (gp5
// (r, c) at row 2r, lane 2c + 1 of the image's segment, zero elsewhere), as
// FusedStemBatched.backward builds it. With m(v) = 1 if the stored v > 0
// else 0.1:
//   gs4 = T(conv5^T gp5)       (the stride-1 adjoint over gp5dd, the same
//                               function on the interleaved data)
//   gp3 = T(gs4 m(y3)), gp2 = T(conv3^T(gp3) m(y2)),
//   gp1 = T((conv2^T(gp2) + gs4) m(y1)), gp0 = T(conv1^T(gp1) m(y0)),
//   gx  = T(conv0^T gp0)
// with float32 accumulation.
//
// What bounds them on the H100. K8a: with save_acts, bytes (~2.0 GB of
// activations written at b24 608^2 bf16, 0.60 ms); without, operations
// (14.6 GFLOP an image: 7.8 for y0-y3 and 2 x 3.4 for the dense conv5).
// K8b: bytes (~1.6 GB read), 11.2 GFLOP an image of real work. Each block
// owns a tile of one image and computes over its receptive field in shared
// memory, so no intermediate touches device memory.
//
// bfloat16 runs on Hopper's units. K8a is K1's wgmma kernel
// (stem_fused.cu: fused_stem_fwd_wg_kernel: the five convs as wg::conv
// GEMMs on K1's packed weights, ops/stem_fused.py: k1_packed, streamed by a
// producer warp into an mbarrier ring; the same CIN walk, tap order and
// epilogue, stem_common.cuh: EpiConv) over an 8 x 8 sparse (8 x 16 dense)
// y5 tile with K1's halos, conv5 at stride (2, 1) (RowsConv21, M = 128:
// two 64-row blocks) with K1's conv5's taps; every sum is then the sum K1
// forms for the same position (the tiling differs, which moves no sum), so
// the even lanes of y5 are K1's y5 bit for bit and the activations' signs
// are K1's masks. Its tiles (182,640 bytes: y0 [39 x 41][40], then y2
// [19 x 20][40] and s4 [17 x 18][72]; y1 [19 x 20][72], holding x
// [41 x 43 + 1][8] before conv1 and the dense y5 tile [8 x 16][136] after
// the shortcut sum) leave room for a ring of five 8 KB slots (K1 has seven):
// convs 0-3 resident, conv1's and conv3's five slots the whole ring, so the
// next conv's first chunk is loaded once the previous conv is done; conv5
// one pass, streamed once. 224,704 bytes, one block a multiprocessor. The
// stores leave the tile by ldmatrix.trans (positions to lanes) and 4-byte
// words, a line's 32-byte sector a block: with save_acts, y3 is stored on
// its own and the shortcut sum s4 = T(y3 + y1) formed in place after (K1's
// epilogue forms it in the same rounding).
//
// K8b (fused_stem_bwd_b_wg_kernel) is K2's wgmma kernel (stem_common.cuh:
// wgc::chain, the same eleven GEMMs on K2's packed adjoints, ring and
// epilogues) on its 16 x 16 gx tile, with two other loads, both TMA boxes
// of the batch-on-lanes tensors issued by the producer warp: gp5 from
// gp5dd's data positions alone (a tensor map whose row stride is two rows
// brings the data rows, the consumers pick the odd lanes; no gate and no
// rounding, gp5dd is gated), so conv5^T runs as K2's four parity GEMMs
// (K = 1, 2, 2 or 4 taps x 128) and not over the interleaved zeros (4x the
// multiply-adds); the gates from boxes of the saved bfloat16 activations,
// which the consumers turn into K2's int8 window layout (1 where the
// stored value is > 0) before the epilogues that read them: y3's (24
// lanes) lands in the chain's X and Y regions, free until conv5^T's
// epilogue, and becomes a window of its own; y2's, y1's and y0's (16
// lanes: a 32-byte line, an int8 window line) become their windows in
// place, y0 and y1 in the region gp5dd's box held. So K8b holds K2's
// shared-memory plan, 224,128 bytes, one block a multiprocessor, and
// reads twice K2's gate bytes. Given the bfloat16 K1's y5 and masks, every
// value equals K2's: the same gp5, the same chain, the same gates. gx goes
// to the batched segment; the last tile may reach past the image (H a
// multiple of 8): its rows and lanes arrive as zeros or belong to the
// segment's slack, and gx drops the positions past the image.
//
// float32 keeps the first design on CUDA-core FMAs (TF32 would not hold
// the float32 gradient checks): K8a's convs are stem_common.cuh's
// conv_stage (the float32 K1's code, conv5 with its column stride set to
// 1), so its even y5 lanes equal K1's bit for bit, over a 4 x 4 y5 tile
// (4 x 8 dense), 115,520 bytes; K8b runs conv5's stride-1 adjoint over all
// of its 16^2 x 128 gp5dd tile, zeros included (~42 GFLOP an image), then
// stem_common.cuh's chain_tail, the code the float32 K2 and K5 run, with its
// gates read from the saved values (ActMask): 57,856 elements (gs4; gp3
// then gp1; the gp5dd tile, then gp2, then gp0), 231,424 bytes.

#include "stem_common.cuh"

namespace {

using namespace stem;

// K8a's tile geometry: TILE x TILE sparse y5 positions (TILE x 2 TILE dense)
template <int TILE>
struct GeomB {
  static constexpr int S4N = 2 * TILE + 1;  // s4 / y3 tile rows
  static constexpr int S4W = S4N + 1;       // s4 / y3 tile columns
  static constexpr int Y1N = S4N + 2;       // y1 / y2 tile rows
  static constexpr int Y1W = S4W + 2;       // y1 / y2 tile columns
  static constexpr int Y0N = 2 * Y1N + 1;   // y0 tile rows
  static constexpr int Y0W = 2 * Y1W + 1;   // y0 tile columns
  static constexpr int XN = Y0N + 2;        // x tile rows
  static constexpr int XW = Y0W + 2;        // x tile columns
  static constexpr int A = (XN * XW * 3 + 7) / 8 * 8;
  static constexpr int Y2 = Y1N * Y1W * 32;
  static constexpr int B0 = Y0N * Y0W * 32;
  static constexpr int B1 = Y2 + S4N * S4W * 64;
  static constexpr int B = B0 > B1 ? B0 : B1;
  static constexpr int C0 = Y1N * Y1W * 64;
  static constexpr int C1 = TILE * 2 * TILE * 128;
  static constexpr int C = C0 > C1 ? C0 : C1;
  static constexpr int ELEMS = A + B + C;
};

// The own nr x nc region of a [pos][P] tile (C channels, P >= C elements a
// position) of row width TW, whose position
// (rr + off, k + off) is image position (r0 + rr, c0 + k), into a
// batch-on-lanes tensor [rows, C, pitch] whose image segment starts at lane
// lb: column c at lane lb + c + 1 of d0, or with PHASE the even columns into
// d0 and the odd ones into d1, column c at lane lb + c/2 + 1. Lanes run
// fastest. Positions past the image (rows x cols) are skipped. The block of
// the first tile column also zeroes lane 0 of its rows, the block of the last
// tile column the lanes past the values (wq + 1 .. seg - 1).
template <typename T, int C, bool PHASE, int P = C>
__device__ void store_own(const T* __restrict__ tile, int TW, int off, int nr,
                          int nc, int r0, int c0, T* __restrict__ d0,
                          T* __restrict__ d1, int rows, int cols,
                          long long pitch, long long lb, int seg, bool first,
                          bool last) {
  const int half = PHASE ? nc / 2 : nc;
  const int wq = PHASE ? cols / 2 : cols;  // value lanes per segment
  for (int idx = threadIdx.x; idx < nr * C * nc; idx += NT) {
    const int k = idx % nc;
    const int rest = idx / nc;
    const int ch = rest % C, rr = rest / C;
    const int ph = k / half, j = k - ph * half;
    const int col = PHASE ? 2 * j + ph : k;
    if (r0 + rr >= rows || c0 + col >= cols) continue;
    const int lane = PHASE ? c0 / 2 + j + 1 : c0 + k + 1;
    (ph ? d1 : d0)[((long long)(r0 + rr) * C + ch) * pitch + lb + lane] =
        tile[((rr + off) * TW + col + off) * P + ch];
  }
  if (first || last) {
    const int nz_r = last ? seg - wq - 1 : 0;
    const int nz = nz_r + (first ? 1 : 0);
    const int nd = PHASE ? 2 : 1;
    for (int idx = threadIdx.x; idx < nr * C * nz * nd; idx += NT) {
      const int k = idx % nz;
      int rest = idx / nz;
      const int ch = rest % C;
      rest /= C;
      const int rr = rest % nr, ph = rest / nr;
      const int lane = k < nz_r ? wq + 1 + k : 0;
      if (r0 + rr < rows)
        (ph ? d1 : d0)[((long long)(r0 + rr) * C + ch) * pitch + lb + lane] =
            from_f<T>(0.f);
    }
  }
}

// save_acts' outputs; all null for the forward alone
template <typename T>
struct Acts {
  T* y0e;
  T* y0o;
  T* y1;
  T* y2;
  T* y3;
};

template <typename T, int TILE, bool SAVE>
__global__ void __launch_bounds__(NT, 1)
    fused_stem_fwd_b_kernel(const T* __restrict__ xe, const T* __restrict__ xo,
                            const T* __restrict__ w0, const T* __restrict__ w1,
                            const T* __restrict__ w2, const T* __restrict__ w3,
                            const T* __restrict__ w5,
                            const float* __restrict__ b0,
                            const float* __restrict__ b1,
                            const float* __restrict__ b2,
                            const float* __restrict__ b3,
                            const float* __restrict__ b5, T* __restrict__ y5,
                            Acts<T> ac, int H, int seg, long long pitch) {
  using G = GeomB<TILE>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // [XN][XW][3]
  T* y0 = xs + G::A;                       // [Y0N][Y0W][32]
  T* y2 = y0;                              // [Y1N][Y1W][32], after conv1
  T* s4 = y0 + G::Y2;                      // [S4N][S4W][64]: y3, then s4
  T* y1 = y0 + G::B;                       // [Y1N][Y1W][64]
  T* ys = y1;                              // [TILE][2 TILE][128], after s4

  const long long lb = (long long)blockIdx.z * seg;
  const int R5 = blockIdx.y * TILE, C5 = blockIdx.x * TILE;
  const int H1 = H / 2, H5 = H / 4;
  const bool first = blockIdx.x == 0, last = blockIdx.x == gridDim.x - 1;

  // x tile from image row 4 R5 - 6 and column 4 C5 - 6; column c of x is
  // lane c/2 + 1 of the even (c even) or odd phase
  const int xr0 = 4 * R5 - 6, xc0 = 4 * C5 - 6;
  for (int idx = threadIdx.x; idx < G::XN * G::XW * 3; idx += NT) {
    const int ci = idx % 3;
    const int p = idx / 3;
    const int gr = xr0 + p / G::XW, gc = xc0 + p % G::XW;
    T v = from_f<T>(0.f);
    if (gr >= 0 && gr < H && gc >= 0 && gc < H) {
      const T* src = (gc & 1) ? xo : xe;
      v = src[((long long)gr * 8 + ci) * pitch + lb + (gc >> 1) + 1];
    }
    xs[idx] = v;
  }
  __syncthreads();
  conv_stage<T, 3, 32, 3, 1, 4>(xs, G::XW, y0, G::Y0N, G::Y0W, w0, b0,
                                4 * R5 - 5, 4 * C5 - 5, H, nullptr, 0);
  __syncthreads();
  // own regions: y0 rows/columns [4 R5, 4 R5 + 4 TILE) at tile offset 5, y1
  // and y2 [2 R5, 2 R5 + 2 TILE) at offset 2, y3 at offset 1; the tiles of
  // all blocks partition the image
  if (SAVE)
    store_own<T, 32, true>(y0, G::Y0W, 5, 4 * TILE, 4 * TILE, 4 * R5, 4 * C5,
                           ac.y0e, ac.y0o, H, H, pitch, lb, seg, first, last);
  conv_stage<T, 32, 64, 3, 2, 4>(y0, G::Y0W, y1, G::Y1N, G::Y1W, w1, b1,
                                 2 * R5 - 2, 2 * C5 - 2, H1, nullptr, 0);
  __syncthreads();
  if (SAVE)
    store_own<T, 64, false>(y1, G::Y1W, 2, 2 * TILE, 2 * TILE, 2 * R5, 2 * C5,
                            ac.y1, nullptr, H1, H1, pitch, lb, seg, first,
                            last);
  conv_stage<T, 64, 32, 1, 1, 4>(y1, G::Y1W, y2, G::Y1N, G::Y1W, w2, b2,
                                 2 * R5 - 2, 2 * C5 - 2, H1, nullptr, 0);
  __syncthreads();
  if (SAVE)
    store_own<T, 32, false>(y2, G::Y1W, 2, 2 * TILE, 2 * TILE, 2 * R5, 2 * C5,
                            ac.y2, nullptr, H1, H1, pitch, lb, seg, first,
                            last);
  conv_stage<T, 32, 64, 3, 1, 4>(y2, G::Y1W, s4, G::S4N, G::S4W, w3, b3,
                                 2 * R5 - 1, 2 * C5 - 1, H1, nullptr, 0);
  __syncthreads();
  if (SAVE) {
    store_own<T, 64, false>(s4, G::S4W, 1, 2 * TILE, 2 * TILE, 2 * R5, 2 * C5,
                            ac.y3, nullptr, H1, H1, pitch, lb, seg, first,
                            last);
    __syncthreads();
  }
  // s4 = T(y3 + y1) in place, y1 at its tile position (oy + 1, ox + 1): K1's
  // shortcut sum (zero outside the image, where both are zero)
  for (int idx = threadIdx.x; idx < G::S4N * G::S4W * 64; idx += NT) {
    const int ch = idx % 64;
    const int p = idx / 64;
    const int oy = p / G::S4W, ox = p - oy * G::S4W;
    s4[idx] = from_f<T>(to_f(s4[idx]) +
                        to_f(y1[((oy + 1) * G::Y1W + ox + 1) * 64 + ch]));
  }
  __syncthreads();
  // conv5 at stride (2, 1): dense y5 (R5 + oy, 2 C5 + ox) reads s4 at tile
  // (2 oy + ky, ox + kx)
  conv_stage<T, 64, 128, 3, 2, 4, false, 1>(s4, G::S4W, ys, TILE, 2 * TILE,
                                            w5, b5, 0, 0, 0x7fffffff,
                                            nullptr, 0);
  __syncthreads();
  store_own<T, 128, false>(ys, 2 * TILE, 0, TILE, 2 * TILE, R5, 2 * C5, y5,
                           nullptr, H5, H1, pitch, lb, seg, first, last);
}

template <typename T, int TILE, bool SAVE>
int launch_fwd(const void* xe, const void* xo, const void* const* w,
               const float* const* bias, void* y5, Acts<T> ac, int B, int H,
               int seg, cudaStream_t s) {
  const size_t smem = sizeof(T) * (size_t)GeomB<TILE>::ELEMS;
  cudaError_t e = cudaFuncSetAttribute(
      fused_stem_fwd_b_kernel<T, TILE, SAVE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nt = (H / 4 + TILE - 1) / TILE;
  dim3 grid(nt, nt, B);
  fused_stem_fwd_b_kernel<T, TILE, SAVE><<<grid, NT, smem, s>>>(
      static_cast<const T*>(xe), static_cast<const T*>(xo),
      static_cast<const T*>(w[0]), static_cast<const T*>(w[1]),
      static_cast<const T*>(w[2]), static_cast<const T*>(w[3]),
      static_cast<const T*>(w[4]), bias[0], bias[1], bias[2], bias[3],
      bias[4], static_cast<T*>(y5), ac, H, seg, (long long)B * seg);
  return (int)cudaGetLastError();
}

template <typename T, int TILE>
int launch_fwd_any(const void* xe, const void* xo, const void* const* w,
                   const float* const* bias, void* y5, void* const* a, int B,
                   int H, int seg, cudaStream_t s) {
  const Acts<T> ac = {static_cast<T*>(a[0]), static_cast<T*>(a[1]),
                      static_cast<T*>(a[2]), static_cast<T*>(a[3]),
                      static_cast<T*>(a[4])};
  if (ac.y0e != nullptr)
    return launch_fwd<T, TILE, true>(xe, xo, w, bias, y5, ac, B, H, seg, s);
  return launch_fwd<T, TILE, false>(xe, xo, w, bias, y5, ac, B, H, seg, s);
}

// ---------------------------------------------------------------------------
// K8a in bfloat16: K1's convs on wgmma
// ---------------------------------------------------------------------------

// The tiles of GeomB<8> with K1's padded row pitches (stem_fused.cu: Geom)
struct GeomTC {
  using G = GeomB<8>;
  static constexpr int TILE = 8;
  static constexpr int P32 = 32 + 8, P64 = 64 + 8, P128 = 128 + 8;
  // x [XN XW + 1][8]: channels 3..7 and the last position zero, read by
  // conv0's tensor-core taps with zero weights
  static constexpr int XE = (G::XN * G::XW + 1) * 8;
  static constexpr int Y2 = G::Y1N * G::Y1W * P32;
  static constexpr int B0 = G::Y0N * G::Y0W * P32;
  static constexpr int B1 = Y2 + G::S4N * G::S4W * P64;
  static constexpr int B = B0 > B1 ? B0 : B1;
  static constexpr int C0 = G::Y1N * G::Y1W * P64;
  static constexpr int C1 = TILE * 2 * TILE * P128;
  static constexpr int C01 = C0 > C1 ? C0 : C1;
  static constexpr int C = XE > C01 ? XE : C01;
  static constexpr int ELEMS = B + C;  // bfloat16 elements, 182,640 bytes
};
static_assert(GeomTC::Y2 % 8 == 0 && GeomTC::B % 8 == 0,
              "16-byte aligned regions");

namespace k8a {
using G = GeomB<8>;
using Q = GeomTC;
constexpr int TILE = Q::TILE;
// K1's five GEMMs at this tile (wg::Gemm: taps, depth a tap, COUT, channel
// groups, 64-row blocks an item, rows) on a ring of five 8 KB slots: convs
// 0-3 resident (conv1's and conv3's five slots the whole ring), conv5 one
// pass of two items, each a warpgroup's 64 channels over the dense 8 x 16
// tile's two 64-row blocks, streamed once (a 16 KB chunk over two slots; a
// wgmma group two 16-deep steps)
constexpr int STAGES = 5, SLOT = 8192;
using C0 = wg::Gemm<6, 16, 32, 1, 2, G::Y0N * G::Y0W, SLOT, STAGES>;
using C1 = wg::Gemm<9, 32, 64, 1, 1, G::Y1N * G::Y1W, SLOT, STAGES>;
using C2 = wg::Gemm<1, 64, 32, 1, 1, G::Y1N * G::Y1W, SLOT, STAGES>;
using C3 = wg::Gemm<9, 32, 64, 1, 1, G::S4N * G::S4W, SLOT, STAGES>;
using C5 = wg::Gemm<9, 64, 128, 2, 2, TILE * 2 * TILE, SLOT, STAGES, 1, 2>;
static_assert(C0::RES && C1::RES && C2::RES && C3::RES && !C5::RES &&
                  C5::NPASS == 1,
              "the ring's plan");
constexpr int TILE_BYTES = 2 * Q::ELEMS;
constexpr int STAGE_AT = TILE_BYTES;  // the warps' transposing stages
constexpr int RING_AT = STAGE_AT + wg::CONSUMER_WARPS * 512;
constexpr int SMEM = RING_AT + wg::ring_bytes(STAGES, SLOT);
static_assert(SMEM <= 232448, "shared memory");
// K1's packed weights of convs 0, 1, 2, 3, 5 (ops/stem_fused.py: k1_packed)
struct Weights {
  const unsigned char* w[5];
};

// lanes [from, to) of one line zero (to a multiple of 8): single elements
// up to the first 16-byte boundary, 16-byte stores past it
__device__ __forceinline__ void zero_lanes(bf16* __restrict__ p, int from,
                                           int to) {
  int l = from;
  for (; l < to && (l & 7); ++l) p[l] = __float2bfloat16_rn(0.f);
  for (; l < to; l += 8)
    *reinterpret_cast<uint4*>(p + l) = make_uint4(0, 0, 0, 0);
}

// A warp's transposing stage (Stage::BYTES a warp, past the tiles): one
// unit of 16 positions x 16 channels of a [pos][P] tile, read by one
// ldmatrix.x4.trans (matrix k: positions 8 (k % 2) .., channels
// 8 (k / 2) ..), written back by stmatrix as 16 channel lines of 16 lanes
// (32 bytes), the line's two 16-byte units at (2 line + half) XOR bit 2 of
// the line: the eight rows of an stmatrix phase, and the eight units a
// quarter-warp reads, fall in distinct bank groups
struct Stage {
  static constexpr int BYTES = 512;
  unsigned char* base;  // this warp's
  uint32_t st;          // the stmatrix row address of this lane
  __device__ explicit Stage(unsigned char* all) {
    const int lane = threadIdx.x & 31;
    base = all + (threadIdx.x >> 5) * BYTES;
    const int line = 8 * (lane >> 4) + (lane & 7), half = (lane >> 3) & 1;
    st = wg::smem_u32(base) + 16 * unit(line, half);
  }
  static __device__ int unit(int line, int half) {
    return (2 * line + half) ^ ((line >> 2) & 1);
  }
  // the unit whose position rows this lane addresses (a: its first
  // channel's element of position L = 8 ((lane / 8) % 2) + lane % 8) into
  // the stage
  __device__ void put(const bf16* a) const {
    uint32_t v[4];
    ldsm4t(v, wg::smem_u32(a));
    put(v);
  }
  __device__ void put(const uint32_t (&v)[4]) const {
    stsm4(st, v);
    __syncwarp();
  }
  // 8 lanes (16 bytes) of a line
  __device__ uint4 get(int line, int half) const {
    return *reinterpret_cast<const uint4*>(base + 16 * unit(line, half));
  }
  __device__ bf16 at(int line, int lane16) const {
    return reinterpret_cast<const bf16*>(
        base + 16 * unit(line, lane16 >> 3))[lane16 & 7];
  }
};

// save_acts' store of one activation: the own NR x 16 region (16 columns,
// or with PHASE 32 columns as 16 lanes a phase) of a [pos][P] tile of row
// width TW (C channels) whose own first position is (off, off) in the tile
// and (r0, c0) in the image, into a batch-on-lanes tensor [rows, C, pitch]
// (d0, d1 at the image's segment lane 0; PHASE: the even columns into d0,
// the odd into d1). A block writes lanes [l0, l0 + 16) of its rows' lines
// (l0 = c0, or c0 / 2 with PHASE: a 32-byte sector), lane l0 + i holding
// own column i - 1 of its phase: lane l0 from the tile's halo, zero left of
// the image, else the left neighbour's last own column with its bits (the
// same sums); columns past the image are zero in the tile. A warp takes a
// unit of 16 lanes x 16 channels of one row and phase through its Stage,
// then each thread stores 16 bytes, two threads a line's sector. The block
// of the last tile column writes lane l0 + 16 (own column 15) and zeroes
// the rest of its rows' lines. Rows past the image are skipped. Run by the
// NC consumer threads.
template <int C, int P, int NR, bool PHASE>
__device__ void store_act(const bf16* __restrict__ tile, int TW, int off,
                          int r0, int c0, bf16* __restrict__ d0,
                          bf16* __restrict__ d1, int rows, long long pitch,
                          int seg, bool last, const Stage& sg) {
  constexpr int NPH = PHASE ? 2 : 1, CG = C / 16;
  static_assert(C % 16 == 0 && P % 8 == 0, "16-channel units");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l0 = PHASE ? c0 / 2 : c0;
  // this lane's matrix row: unit lane L (own column L - 1 of its phase)
  // and the matrix's channels
  const int L = 8 * ((lane >> 3) & 1) + (lane & 7);
  const int col = off + (PHASE ? 2 * (L - 1) : L - 1);
  const int ch8 = 8 * (lane >> 4);
  for (int u = warp; u < NR * NPH * CG; u += wg::CONSUMER_WARPS) {
    const int cg = u % CG, ph = (u / CG) % NPH, rr = u / (CG * NPH);
    if (r0 + rr >= rows) continue;
    sg.put(tile + ((rr + off) * TW + col + ph) * P + 16 * cg + ch8);
    const uint4 w = sg.get(lane >> 1, lane & 1);
    __syncwarp();
    *reinterpret_cast<uint4*>(
        (ph ? d1 : d0) +
        ((long long)(r0 + rr) * C + 16 * cg + (lane >> 1)) * pitch + l0 +
        8 * (lane & 1)) = w;
  }
  if (last) {
    const int nr = min(NR, rows - r0);
    for (int idx = threadIdx.x; idx < nr * C * NPH; idx += wg::NC) {
      const int ch = idx % C, ph = (idx / C) % NPH, rr = idx / (C * NPH);
      bf16* d = (ph ? d1 : d0) + ((long long)(r0 + rr) * C + ch) * pitch;
      d[l0 + 16] =
          tile[((rr + off) * TW + off + (PHASE ? 30 + ph : 15)) * P + ch];
      zero_lanes(d, l0 + 17, seg);
    }
  }
}

// y5's store: the dense 8 x 16 tile [8][16][P128] (dense columns 2 C5 ..
// 2 C5 + 15 of rows R5 ..) into lanes l0 + 1 .. l0 + 16 (l0 = 2 C5) of its
// rows' lines of y5 [H5, 128, pitch] (d at the image's segment lane 0). The
// tile has no column left of its own, so a line's 16 values straddle two
// 32-byte sectors (lane l0 is the left neighbour's): a unit of 16 lines
// goes through the warp's Stage, then each thread stores one value, half
// a warp a line (two sectors a line, the fewest). Columns past the image's
// H1 are zero; rows past H5 are skipped. The block of the first tile
// column zeroes lane 0, that of the last the lanes past l0 + 16.
__device__ void store_y5(const bf16* __restrict__ ys, int R5, int l0,
                         bf16* __restrict__ d, int H5, int H1,
                         long long pitch, int seg, bool first, bool last,
                         const Stage& sg) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane & 3, e = lane & 15;
  const int L = 8 * ((lane >> 3) & 1) + (lane & 7);
  const int ch8 = 8 * (lane >> 4);
  const int nv = H1 - l0;  // the tile's columns inside the image
  for (int u = warp; u < TILE * 8; u += wg::CONSUMER_WARPS) {
    const int cg = u % 8, rr = u / 8;
    if (R5 + rr >= H5) continue;
    uint32_t v[4];
    ldsm4t(v, wg::smem_u32(ys + (rr * 2 * TILE + L) * Q::P128 + 16 * cg +
                           ch8));
    // register k: columns 8 (k % 2) + 2 q and the next
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 8 * (k & 1) + 2 * q;
      v[k] &= (c < nv ? 0xffffu : 0u) | (c + 1 < nv ? 0xffff0000u : 0u);
    }
    sg.put(v);
    bf16* p = d + ((long long)(R5 + rr) * 128 + 16 * cg) * pitch + l0 + 1 +
              e;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int line = 2 * i + (lane >> 4);
      p[line * pitch] = sg.at(line, e);
    }
    __syncwarp();
  }
  if (first || last) {
    const int n = min(TILE, H5 - R5) * 128;  // the own rows' lines
    for (int line = threadIdx.x; line < n; line += wg::NC) {
      bf16* p = d + ((long long)R5 * 128 + line) * pitch;
      if (first) p[0] = __float2bfloat16_rn(0.f);
      if (last) zero_lanes(p, l0 + 17, seg);
    }
  }
}

// s4 = T(y3 + y1) in place over the s4 tile, y1 at its tile position
// (oy + 1, ox + 1): EpiConv's RES sum, 8 channels a thread (outside the
// image both are zero, and so is s4)
__device__ __forceinline__ void shortcut_sum(bf16* __restrict__ s4,
                                             const bf16* __restrict__ y1) {
  for (int idx = threadIdx.x; idx < G::S4N * G::S4W * 8; idx += wg::NC) {
    const int u = idx % 8, p = idx / 8;
    const int oy = p / G::S4W, ox = p - oy * G::S4W;
    uint4* d = reinterpret_cast<uint4*>(s4 + p * Q::P64 + 8 * u);
    const uint4 r = *reinterpret_cast<const uint4*>(
        y1 + ((oy + 1) * G::Y1W + ox + 1) * Q::P64 + 8 * u);
    uint4 a = *d;
    uint32_t* av = reinterpret_cast<uint32_t*>(&a);
    const uint32_t* rv = reinterpret_cast<const uint32_t*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(av + i));
      const float2 y = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(rv + i));
      const __nv_bfloat162 s = __floats2bfloat162_rn(x.x + y.x, x.y + y.y);
      av[i] = *reinterpret_cast<const uint32_t*>(&s);
    }
    *d = a;
  }
}

}  // namespace k8a

// The bfloat16 K8a: K1's wgmma kernel (stem_fused.cu:
// fused_stem_fwd_wg_kernel) over GeomB<8>'s tiles, conv5 at stride (2, 1)
// (RowsConv21 over the dense 8 x 16 y5 tile, M = 128), the batch-on-lanes
// x tile by K1's 16-byte loads, the activations (SAVE) and y5 by store_act
// and store_y5. Shared memory: the tiles (GeomTC, 182,640 bytes: y0, then
// y2 and s4, in region B; x, then y1, then the y5 tile in region C), then
// the ring (five 8 KB slots and their barriers, 42,064 bytes with the
// alignment slack): 224,704 bytes, one block a multiprocessor. ww: K1's
// packed weights.
template <bool SAVE>
__global__ void __launch_bounds__(wg::NTH, 1)
    fused_stem_fwd_b_wg_kernel(const bf16* __restrict__ xe,
                               const bf16* __restrict__ xo,
                               const float* __restrict__ b0,
                               const float* __restrict__ b1,
                               const float* __restrict__ b2,
                               const float* __restrict__ b3,
                               const float* __restrict__ b5, k8a::Weights ww,
                               bf16* __restrict__ y5, Acts<bf16> ac, int H,
                               int seg, long long pitch) {
  using namespace k8a;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* y0 = reinterpret_cast<bf16*>(smem_raw);  // [Y0N Y0W][P32]
  bf16* y2 = y0;          // [Y1N Y1W][P32], after conv1
  bf16* s4 = y0 + Q::Y2;  // [S4N S4W][P64]: y3, then s4
  bf16* y1 = y0 + Q::B;   // [Y1N Y1W][P64]
  bf16* xs = y1;          // [XN XW + 1][8], before conv1 writes y1
  bf16* ys = y1;          // [TILE 2 TILE][P128], after the shortcut sum
  auto ring = wg::make_ring<STAGES, SLOT>(wg::smem_u32(smem_raw + RING_AT));
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

  const long long lb = (long long)blockIdx.z * seg;
  const int R5 = blockIdx.y * TILE, C5r = blockIdx.x * TILE;
  const int H1 = H / 2, H5 = H / 4;
  const bool first = blockIdx.x == 0, last = blockIdx.x == gridDim.x - 1;
  const Stage sg(smem_raw + STAGE_AT);

  // x tile [XN XW + 1][8] from image row 4 R5 - 6 and column 4 C5 - 6;
  // column c of x is lane c/2 + 1 of the even (c even) or odd phase. K1's
  // loads: a thread takes 8 lanes of one row and phase, 16 bytes from each
  // of the three channels, from the 16-byte boundary 8 lanes below the
  // tile's first (four such runs a row and phase cover its 22 lanes), and
  // writes each column's whole 16-byte position (channels 3..7 zero); the
  // last position is zero (read by conv0's paired taps with zero weights)
  wg::Lap lap;
  const int xr0 = 4 * R5 - 6, xc0 = 4 * C5r - 6;
  const int lv0 = 16 * blockIdx.x - 8;  // = (xc0 >> 1) + 1 rounded down
  for (int idx = threadIdx.x; idx < G::XN * 2 * 4; idx += wg::NC) {
    const int v = idx % 4, ph = (idx / 4) % 2, r = idx / 8;
    const int gr = xr0 + r, l = lv0 + 8 * v;
    uint4 ch[3] = {};
    if (gr >= 0 && gr < H && l >= 0 && l + 8 <= seg) {
      const bf16* src = (ph ? xo : xe) + (long long)gr * 8 * pitch + lb + l;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        ch[c] = __ldg(reinterpret_cast<const uint4*>(src + c * pitch));
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int gc = 2 * (l + k - 1) + ph, col = gc - xc0;
      if (col < 0 || col >= G::XW) continue;
      const bool in = gc >= 0 && gc < H;
      uint32_t u[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const uint32_t w = reinterpret_cast<const uint32_t*>(&ch[c])[k / 2];
        u[c] = in ? (k & 1 ? w >> 16 : w & 0xffffu) : 0u;
      }
      *reinterpret_cast<uint4*>(xs + (r * G::XW + col) * 8) =
          make_uint4(u[0] | (u[1] << 16), u[2], 0u, 0u);
    }
  }
  if (threadIdx.x < 8)
    xs[G::XN * G::XW * 8 + threadIdx.x] = __float2bfloat16_rn(0.f);
  lap(wg::P_LOAD);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  wg::conv<C0, 8>(ring, xs, RowsConv0{G::Y0W, G::XW},
                  EpiConv<Q::P32, false, false>{y0, G::Y0W, b0, 4 * R5 - 5,
                                                4 * C5r - 5, H, nullptr, 0,
                                                nullptr},
                  lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  // own regions: y0 rows/columns [4 R5, 4 R5 + 4 TILE) at tile offset 5, y1
  // and y2 [2 R5, 2 R5 + 2 TILE) at offset 2, y3 at offset 1; the tiles of
  // all blocks partition the image
  if (SAVE) {
    store_act<32, Q::P32, 4 * TILE, true>(y0, G::Y0W, 5, 4 * R5, 4 * C5r,
                                          ac.y0e + lb, ac.y0o + lb, H, pitch,
                                          seg, last, sg);
    lap(wg::P_STORE);
  }
  wg::conv<C1, Q::P32>(
      ring, y0, RowsConv<3, 2>{G::Y1W, G::Y0W},
      EpiConv<Q::P64, false, false>{y1, G::Y1W, b1, 2 * R5 - 2, 2 * C5r - 2,
                                    H1, nullptr, 0, nullptr},
      lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  if (SAVE) {
    store_act<64, Q::P64, 2 * TILE, false>(y1, G::Y1W, 2, 2 * R5, 2 * C5r,
                                           ac.y1 + lb, nullptr, H1, pitch,
                                           seg, last, sg);
    lap(wg::P_STORE);
  }
  wg::conv<C2, Q::P64>(
      ring, y1, RowsConv<1, 1>{G::Y1W, G::Y1W},
      EpiConv<Q::P32, false, false>{y2, G::Y1W, b2, 2 * R5 - 2, 2 * C5r - 2,
                                    H1, nullptr, 0, nullptr},
      lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  if (SAVE) {
    store_act<32, Q::P32, 2 * TILE, false>(y2, G::Y1W, 2, 2 * R5, 2 * C5r,
                                           ac.y2 + lb, nullptr, H1, pitch,
                                           seg, last, sg);
    lap(wg::P_STORE);
  }
  // conv3: without SAVE K1's epilogue with the shortcut sum; with SAVE y3
  // alone (its own value is saved), the sum after its store
  wg::conv<C3, Q::P32>(
      ring, y2, RowsConv<3, 1>{G::S4W, G::Y1W},
      EpiConv<Q::P64, false, !SAVE, Q::P64>{s4, G::S4W, b3, 2 * R5 - 1,
                                            2 * C5r - 1, H1, y1, G::Y1W,
                                            nullptr},
      lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  if (SAVE) {
    store_act<64, Q::P64, 2 * TILE, false>(s4, G::S4W, 1, 2 * R5, 2 * C5r,
                                           ac.y3 + lb, nullptr, H1, pitch,
                                           seg, last, sg);
    lap(wg::P_STORE);
    wg::sync_consumers();
    lap(wg::P_SYNC);
    shortcut_sum(s4, y1);
    lap(wg::P_EPI);
    wg::sync_consumers();
    lap(wg::P_SYNC);
  }
  // conv5 at stride (2, 1): dense y5 (R5 + oy, 2 C5 + ox) reads s4 at tile
  // (2 oy + ky, ox + kx)
  wg::conv<C5, Q::P64>(
      ring, s4, RowsConv21<3>{2 * TILE, G::S4W},
      EpiConv<Q::P128, false, false>{ys, 2 * TILE, b5, 0, 0, 0x7fffffff,
                                     nullptr, 0, nullptr},
      lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  store_y5(ys, R5, 2 * C5r, y5 + lb, H5, H1, pitch, seg, first, last, sg);
  lap(wg::P_STORE);
}

template <bool SAVE>
int launch_fwd_wg(const void* xe, const void* xo, const float* const* bias,
                  k8a::Weights ww, void* y5, Acts<bf16> ac, int B, int H,
                  int seg, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_stem_fwd_b_wg_kernel<SAVE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, k8a::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int nt = (H / 4 + k8a::TILE - 1) / k8a::TILE;
  fused_stem_fwd_b_wg_kernel<SAVE><<<dim3(nt, nt, B), wg::NTH, k8a::SMEM,
                                     s>>>(
      static_cast<const bf16*>(xe), static_cast<const bf16*>(xo), bias[0],
      bias[1], bias[2], bias[3], bias[4], ww, static_cast<bf16*>(y5), ac, H,
      seg, (long long)B * seg);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K8b
// ---------------------------------------------------------------------------

struct ChainB {
  static constexpr int N5D = Chain::N4 + 2;  // gp5dd tile side (16)
  static constexpr int SZ_G = N5D * N5D * 128;
  static constexpr int SZ_Z = SZ_G > Chain::SZ_Z ? SZ_G : Chain::SZ_Z;
  static constexpr int ELEMS = Chain::SZ_X + Chain::SZ_Y + SZ_Z;
};

// Zero the border and slack lanes of the gx tile's rows (R0 .. R0 + TX - 1
// below H) in both phases of one image's segment (d0, d1 at its lane 0):
// lane 0 (first tile column), lanes H/2 + 1 .. seg - 1 (last tile column)
template <typename T>
__device__ void zero_gx_lanes(T* __restrict__ d0, T* __restrict__ d1,
                              int R0, int H, int seg, long long pitch) {
  const bool first = blockIdx.x == 0, last = blockIdx.x == gridDim.x - 1;
  if (!first && !last) return;
  const int nr = last ? seg - H / 2 - 1 : 0;
  const int n = nr + (first ? 1 : 0);
  for (int idx = threadIdx.x; idx < 2 * Chain::TX * 8 * n; idx += NT) {
    const int k = idx % n;
    int rest = idx / n;
    const int c = rest % 8;
    rest /= 8;
    const int r = rest % Chain::TX, ph = rest / Chain::TX;
    const int lane = k < nr ? H / 2 + 1 + k : 0;
    if (R0 + r < H)
      (ph ? d1 : d0)[((long long)(R0 + r) * 8 + c) * pitch + lane] =
          from_f<T>(0.f);
  }
}

// gx = T(v), 8 channels, into the even/odd column phases of one image's
// batch-on-lanes segment; positions past the image (H not a multiple of the
// tile) are dropped
template <typename T>
struct EpiGxB {
  T* gxe;
  T* gxo;
  int org_r, org_c, H;
  long long pitch, lb;
  __device__ void operator()(int oy, int ox, int, const float* v) const {
    const int gr = org_r + oy, gc = org_c + ox;
    if (gr >= H || gc >= H) return;
    T* d = (gc & 1) ? gxo : gxe;
    const long long o = (long long)gr * 8 * pitch + lb + (gc >> 1) + 1;
#pragma unroll
    for (int c = 0; c < CT; ++c) d[o + (long long)c * pitch] = from_f<T>(v[c]);
  }
};

template <typename T>
__global__ void __launch_bounds__(NT, 1)
    fused_stem_bwd_b_kernel(const T* __restrict__ gp5dd,
                            const T* __restrict__ y0e,
                            const T* __restrict__ y0o,
                            const T* __restrict__ y1,
                            const T* __restrict__ y2,
                            const T* __restrict__ y3,
                            const T* __restrict__ v0, const T* __restrict__ v1,
                            const T* __restrict__ v2, const T* __restrict__ v3,
                            const T* __restrict__ v5, T* __restrict__ gxe,
                            T* __restrict__ gxo, int H, int seg,
                            long long pitch) {
  using K = Chain;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* X = reinterpret_cast<T*>(smem_raw);  // gs4
  T* Y = X + K::SZ_X;                      // gp3, then gp1
  T* Z = Y + K::SZ_Y;                      // gp5dd, then gp2, then gp0
  const long long lb = (long long)blockIdx.z * seg;
  const int R0 = blockIdx.y * K::TX, C0 = blockIdx.x * K::TX;
  const int H1 = H / 2;
  const int o4r = R0 / 2 - 2, o4c = C0 / 2 - 2;  // gs4 / gp3 tile origin

  // the gp5dd tile over gs4's receptive field, from (o4r - 1, o4c - 1),
  // lanes fastest; zero outside the image
  constexpr int N = ChainB::N5D;
  for (int idx = threadIdx.x; idx < N * N * 128; idx += NT) {
    const int k = idx % N;
    const int rest = idx / N;
    const int co = rest % 128, r = rest / 128;
    const int gr = o4r - 1 + r, gc = o4c - 1 + k;
    T v = from_f<T>(0.f);
    if (gr >= 0 && gr < H1 && gc >= 0 && gc < H1)
      v = gp5dd[((long long)gr * 128 + co) * pitch + lb + gc + 1];
    Z[(r * N + k) * 128 + co] = v;
  }
  __syncthreads();
  // gs4 (X) and gp3 (Y): the stride-1 adjoint of conv5 over the whole tile,
  // gs4 (oy, ox) reading gp5dd at tile (oy + 2 - dy, ox + 2 - dx)
  convt_s1<T, 128, 64, 3, 2, 7>(
      Z, N, K::N4, K::N4, v5,
      EpiGs4<T, ActMask<T, 64, false>>{
          X, Y, ActMask<T, 64, false>{y3, nullptr, pitch, lb}, o4r, o4c,
          H1});
  __syncthreads();
  chain_tail<T>(X, Y, Z, v0, v1, v2, v3,
                ActMask<T, 32, true>{y0e, y0o, pitch, lb},
                ActMask<T, 64, false>{y1, nullptr, pitch, lb},
                ActMask<T, 32, false>{y2, nullptr, pitch, lb}, H,
                EpiGxB<T>{gxe, gxo, R0, C0, H, pitch, lb});
  zero_gx_lanes(gxe + lb, gxo + lb, R0, H, seg, pitch);
}

template <typename T>
int launch_bwd(const void* gp5dd, const void* const* a, const void* const* v,
               void* gxe, void* gxo, int B, int H, int seg, cudaStream_t s) {
  const size_t smem = sizeof(T) * (size_t)ChainB::ELEMS;
  cudaError_t e = cudaFuncSetAttribute(
      fused_stem_bwd_b_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nt = (H + Chain::TX - 1) / Chain::TX;
  dim3 grid(nt, nt, B);
  fused_stem_bwd_b_kernel<T><<<grid, NT, smem, s>>>(
      static_cast<const T*>(gp5dd), static_cast<const T*>(a[0]),
      static_cast<const T*>(a[1]), static_cast<const T*>(a[2]),
      static_cast<const T*>(a[3]), static_cast<const T*>(a[4]),
      static_cast<const T*>(v[0]), static_cast<const T*>(v[1]),
      static_cast<const T*>(v[2]), static_cast<const T*>(v[3]),
      static_cast<const T*>(v[4]), static_cast<T*>(gxe), static_cast<T*>(gxo),
      H, seg, (long long)B * seg);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K8b in bfloat16: K2's chain on wgmma
// ---------------------------------------------------------------------------

// The chain's gx epilogue into one image's segment of the batch-on-lanes
// phases [H, 8, B*seg] (gxe, gxo at its lane 0; row pitch 8 pitch, channel
// pitch pitch): channels n and n + 1; positions past the image (H not a
// multiple of the tile) are dropped
struct GxBatched {
  bf16* gxe;
  bf16* gxo;
  int org_r, org_c, H, seg;
  long long pitch;
  __device__ void operator()(int oy, int ox, int n, float v0,
                             float v1) const {
    const int gr = org_r + oy, gc = org_c + ox;
    if (gr >= H || gc >= H) return;
    bf16* d = ((gc & 1) ? gxo : gxe) + ((long long)gr * 8 + n) * pitch +
              (gc >> 1) + 1;
    d[0] = __float2bfloat16_rn(v0);
    d[pitch] = __float2bfloat16_rn(v1);
  }
  __device__ void zero_borders() const {
    zero_gx_lanes(gxe, gxo, org_r, H, seg, pitch);
  }
};

namespace k8b {

using K = Chain;
// The boxes (bfloat16; a box's first lane on a 16-byte boundary, 8 lanes,
// at or below the first lane read, and inside the image's segment): gp5dd
// and y3 24 lanes, y0, y1 and y2 16. Shared memory from a 1024-aligned
// base (bytes), K2's plan: the chain's X, Y, Z (the y3 box lands in X and
// Y, which the chain first writes in conv5^T's epilogue); region R1 holds
// gp5dd's box [N5][128][24] until gp5 is formed, then the y0 boxes (both
// phases) and y1's, each [row][channel][16 lanes]; region R2 y3's sign
// window (int8, [row][64][WL]) and y2's box; four barriers (gp5dd, the y3
// and y2 boxes, the y0 and y1 boxes, R1 free); the ring. A 16-lane bf16
// line is 32 bytes, an int8 window line's WL: the y0, y1 and y2 boxes turn
// into their sign windows in place.
constexpr int LB = 24, LW = 16;
constexpr int R1_AT = (2 * bwd_tc::ELEMS + 127) / 128 * 128;
constexpr int G5_B = K::N5 * 128 * LB * 2;
constexpr int M0_B = K::N0 * 32 * LW * 2;  // a phase
constexpr int M1_B = K::N1 * 64 * LW * 2;
constexpr int M0_AT = R1_AT, M1_AT = M0_AT + 2 * M0_B;
constexpr int R1_B = G5_B > 2 * M0_B + M1_B ? G5_B : 2 * M0_B + M1_B;
constexpr int R2_AT = R1_AT + R1_B;
constexpr int Y3_B = K::N4 * 64 * LB * 2;
constexpr int M3_B = K::N4 * 64 * wgc::WL, M2_B = K::N1 * 32 * LW * 2;
constexpr int M3_AT = R2_AT, M2_AT = M3_AT + M3_B;
constexpr int BAR_AT = M2_AT + M2_B;
constexpr int RING_AT = BAR_AT + 32;
constexpr int SMEM =
    1024 + RING_AT + wg::ring_bytes(wgc::STAGES, wgc::SLOT);
static_assert(SMEM <= 232448 && 2 * LW == wgc::WL && LB <= wgc::WL &&
                  Y3_B <= 2 * (bwd_tc::SZ_X + bwd_tc::SZ_Y) &&
                  M0_B % 128 == 0 && M1_B % 128 == 0 && M3_B % 128 == 0 &&
                  M2_B % 128 == 0 && G5_B % 128 == 0 && R1_B % 128 == 0,
              "shared memory");
static_assert(K::N5 == 8 && K::TX == 16, "the boxes cover the windows");

// lines lines of LANES bfloat16 values at src into sign bytes (1 where the
// value is > 0) at dst, a line of wgc::WL bytes each: a consumer thread a
// line, read whole before its signs are stored, so dst may be src where
// LANES * 2 == WL (a line in place)
template <int LANES>
__device__ __forceinline__ void signs(unsigned char* dst,
                                      const unsigned char* src, int lines) {
  static_assert(LANES % 8 == 0 && LANES <= wgc::WL, "whole 16-byte units");
  for (int i = threadIdx.x; i < lines; i += wg::NC) {
    const uint4* s = reinterpret_cast<const uint4*>(src + i * LANES * 2);
    uint32_t w[LANES / 4];
#pragma unroll
    for (int q = 0; q < LANES / 8; ++q) {
      const uint4 v = s[q];
      const uint32_t h[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t u = h[2 * j + e / 2];
          const float f = __uint_as_float(e & 1 ? u & 0xffff0000u : u << 16);
          if (f > 0.f) word |= 1u << (8 * e);
        }
        w[2 * q + j] = word;
      }
    }
    uint32_t* d = reinterpret_cast<uint32_t*>(dst + i * wgc::WL);
#pragma unroll
    for (int q = 0; q < LANES / 16; ++q)
      reinterpret_cast<uint4*>(d)[q] =
          make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
    if (LANES % 16)
      reinterpret_cast<uint2*>(d)[LANES / 8 - 1] =
          make_uint2(w[LANES / 4 - 2], w[LANES / 4 - 1]);
  }
}

// The gate windows: first(), before conv5^T, y3's box (in X and Y) into
// its sign window in R2 and y2's box in place; second(), before conv2^T,
// the y0 and y1 boxes in place; each then a consumers' barrier
struct Gates {
  unsigned char* sm;
  uint32_t m32, m01;
  __device__ void first(wg::Lap& lap) const {
    wg::mbar_wait(m32, 0);
    lap(wg::P_INPUT);
    signs<LB>(sm + M3_AT, sm, K::N4 * 64);
    signs<LW>(sm + M2_AT, sm + M2_AT, K::N1 * 32);
    wg::sync_consumers();
    lap(wg::P_MASK);
  }
  __device__ void second(wg::Lap& lap) const {
    wg::mbar_wait(m01, 0);
    lap(wg::P_INPUT);
    signs<LW>(sm + M0_AT, sm + M0_AT, 2 * K::N0 * 32 + K::N1 * 64);
    wg::sync_consumers();
    lap(wg::P_MASK);
  }
};

}  // namespace k8b

// The bfloat16 K8b: K2's kernel with gp5 read from gp5dd's data positions
// (no gate, no rounding: gp5dd is gated) and the gates from the saved
// activations' signs, every load issued by the producer warp through the
// tensor maps of the batch-on-lanes tensors (one image's boxes: its lanes
// from b seg): gp5dd's data rows (a row stride of two rows: 24 lanes x 128
// x 8 rows), y3 (24 lanes x 64 x 14 rows), y2 (16 x 32 x 11), y1 (16 x 64
// x 11), y0's phases (16 x 32 x 20). uw: K2's packed adjoints.
__global__ void __launch_bounds__(wg::NTH, 1)
    fused_stem_bwd_b_wg_kernel(const __grid_constant__ CUtensorMap tg5,
                               const __grid_constant__ CUtensorMap ty0e,
                               const __grid_constant__ CUtensorMap ty0o,
                               const __grid_constant__ CUtensorMap ty1,
                               const __grid_constant__ CUtensorMap ty2,
                               const __grid_constant__ CUtensorMap ty3,
                               wgc::Weights uw, bf16* __restrict__ gxe,
                               bf16* __restrict__ gxo, int H, int seg,
                               long long pitch) {
  using namespace k8b;
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
  const int lb = blockIdx.z * seg;  // the image's first lane
  const int R0 = blockIdx.y * K::TX, C0 = blockIdx.x * K::TX;
  const int H5 = H / 4;
  // K2's tile origins (rows; columns alike)
  const int o5r = R0 / 4 - 1, o5c = C0 / 4 - 1;  // gp5, N5
  const int o4r = R0 / 2 - 2, o4c = C0 / 2 - 2;  // gs4 / gp3, N4
  const int o1r = R0 / 2 - 1, o1c = C0 / 2 - 1;  // gp2 / gp1, N1
  const int o0r = R0 - 2, o0c = C0 - 2;          // gp0, N0
  // each box's first lane in the segment: the 16-byte boundary at or below
  // the first lane read, from the segment's lane 0 at least (gp5dd: gp5
  // column c at lane 2c + 1, from o5c; y3 from lane o4c + 1, y1 and y2
  // from o1c + 1, y0 from (o0c >> 1) + 1)
  const int l5 = max((2 * o5c + 1) & ~7, 0), l3 = max((o4c + 1) & ~7, 0);
  const int l12 = (o1c + 1) & ~7, l0 = ((o0c >> 1) + 1) & ~7;
  if (threadIdx.x >= wg::NC) {
    // the producer warp: one thread issues every load, in the order the
    // consumers need them
    if (threadIdx.x == wg::NC) {
      wg::mbar_expect_tx(bar_in, G5_B);
      wg::tma_load_4d(s0 + R1_AT, &tg5, lb + l5, 0, o5r, 0, bar_in);
      wg::mbar_expect_tx(bar_m32, Y3_B + M2_B);
      wg::tma_load_4d(s0, &ty3, lb + l3, 0, o4r, 0, bar_m32);
      wg::tma_load_4d(s0 + M2_AT, &ty2, lb + l12, 0, o1r, 0, bar_m32);
      // R1 is free once gp5 is formed: the y0 and y1 boxes into it
      wgc::produce(ring, uw, [&] {
        wg::mbar_wait(bar_r1, 0);
        wg::mbar_expect_tx(bar_m01, 2 * M0_B + M1_B);
        wg::tma_load_4d(s0 + M0_AT, &ty0e, lb + l0, 0, o0r, 0, bar_m01);
        wg::tma_load_4d(s0 + M0_AT + M0_B, &ty0o, lb + l0, 0, o0r, 0,
                        bar_m01);
        wg::tma_load_4d(s0 + M1_AT, &ty1, lb + l12, 0, o1r, 0, bar_m01);
      });
    }
    return;
  }

  bf16* Z = reinterpret_cast<bf16*>(sm) + bwd_tc::SZ_X + bwd_tc::SZ_Y;
  // gp5 into Z [N5^2][P5]: the box's odd lanes, zero outside the image; a
  // consumer thread one (row, channel) line's N5 columns. Then R1 is handed
  // back to the producer
  wg::Lap lap;
  wg::mbar_wait(bar_in, 0);
  lap(wg::P_INPUT);
  {
    const bf16* gb = reinterpret_cast<const bf16*>(sm + R1_AT);
    for (int idx = threadIdx.x; idx < K::N5 * 128; idx += wg::NC) {
      const int co = idx % 128, r = idx / 128;
      const int gr = o5r + r;
      const bool row_in = gr >= 0 && gr < H5;
#pragma unroll
      for (int k = 0; k < K::N5; ++k) {
        const int gc = o5c + k;
        bf16 v = __float2bfloat16_rn(0.f);
        if (row_in && gc >= 0 && gc < H5) v = gb[idx * LB + 2 * gc + 1 - l5];
        Z[(r * K::N5 + k) * bwd_tc::P5 + co] = v;
      }
    }
  }
  // the box's reads done (generic proxy) before the tensor unit rewrites
  // R1 (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  lap(wg::P_LOAD);
  wg::sync_consumers();
  if ((threadIdx.x & 31) == 0) wg::mbar_arrive(bar_r1);
  lap(wg::P_SYNC);
  wgc::chain(ring, sm, BoxMask<32, K::N0, true>{sm + M0_AT, l0},
             BoxMask<64, K::N1, false>{sm + M1_AT, l12},
             BoxMask<32, K::N1, false>{sm + M2_AT, l12},
             BoxMask<64, K::N4, false>{sm + M3_AT, l3},
             GxBatched{gxe + lb, gxo + lb, R0, C0, H, seg, pitch},
             Gates{sm, bar_m32, bar_m01}, H, lap);
}

int launch_bwd_wg(const void* gp5dd, const void* const* a,
                  const void* const* u, void* gxe, void* gxo, int B, int H,
                  int seg, cudaStream_t s) {
  using K = Chain;
  using k8b::LB;
  using k8b::LW;
  const int H1 = H / 2, tot = B * seg;
  // the batch-on-lanes tensors [rows, C, B seg] as planar [1, rows, C,
  // B seg]; gp5dd's data rows (the even ones) at a row stride of two rows
  CUtensorMap tm[6];
  int err = wg::planar_map(&tm[0], gp5dd, true, 1, H / 4, 128, tot, LB,
                           K::N5, 0, 2);
  err = err ? err : wg::planar_map(&tm[1], a[0], true, 1, H, 32, tot, LW,
                                   K::N0);
  err = err ? err : wg::planar_map(&tm[2], a[1], true, 1, H, 32, tot, LW,
                                   K::N0);
  err = err ? err : wg::planar_map(&tm[3], a[2], true, 1, H1, 64, tot, LW,
                                   K::N1);
  err = err ? err : wg::planar_map(&tm[4], a[3], true, 1, H1, 32, tot, LW,
                                   K::N1);
  err = err ? err : wg::planar_map(&tm[5], a[4], true, 1, H1, 64, tot, LB,
                                   K::N4);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      fused_stem_bwd_b_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      k8b::SMEM);
  if (e != cudaSuccess) return (int)e;
  const wgc::Weights uw = {{static_cast<const unsigned char*>(u[0]),
                            static_cast<const unsigned char*>(u[1]),
                            static_cast<const unsigned char*>(u[2]),
                            static_cast<const unsigned char*>(u[3]),
                            static_cast<const unsigned char*>(u[4])}};
  const int nt = (H + K::TX - 1) / K::TX;
  dim3 grid(nt, nt, B);
  fused_stem_bwd_b_wg_kernel<<<grid, wg::NTH, k8b::SMEM, s>>>(
      tm[0], tm[1], tm[2], tm[3], tm[4], tm[5], uw, static_cast<bf16*>(gxe),
      static_cast<bf16*>(gxo), H, seg, (long long)tot);
  return (int)cudaGetLastError();
}

}  // namespace

// K8a. dtype: 0 = float32 (TILE 4, CUDA cores), 1 = bfloat16 (TILE 8,
// wgmma). xe, xo the batch-on-lanes phases [H, 8, B*seg]; weights
// HWIO in the compute dtype (read in float32), biases float32; f0 .. f5
// K1's packed weights of convs 0, 1, 2, 3, 5 (k1_packed; read in bfloat16,
// null in float32); y5 dense [H/4, 128, B*seg]; a0e .. a3 save_acts'
// outputs, all null for the forward alone. H a multiple of 8. Returns
// cudaGetLastError().
extern "C" int apfp_fused_stem_fwd_b(
    const void* xe, const void* xo, const void* w0, const void* w1,
    const void* w2, const void* w3, const void* w5, const void* b0,
    const void* b1, const void* b2, const void* b3, const void* b5,
    const void* f0, const void* f1, const void* f2, const void* f3,
    const void* f5, void* y5, void* a0e, void* a0o, void* a1, void* a2,
    void* a3, int dtype, int B, int H, int seg, void* stream) {
  const float* bias[5] = {
      static_cast<const float*>(b0), static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<const float*>(b3),
      static_cast<const float*>(b5)};
  void* const a[5] = {a0e, a0o, a1, a2, a3};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const k8a::Weights ww = {{static_cast<const unsigned char*>(f0),
                              static_cast<const unsigned char*>(f1),
                              static_cast<const unsigned char*>(f2),
                              static_cast<const unsigned char*>(f3),
                              static_cast<const unsigned char*>(f5)}};
    const Acts<bf16> ac = {static_cast<bf16*>(a0e), static_cast<bf16*>(a0o),
                           static_cast<bf16*>(a1), static_cast<bf16*>(a2),
                           static_cast<bf16*>(a3)};
    if (a0e != nullptr)
      return launch_fwd_wg<true>(xe, xo, bias, ww, y5, ac, B, H, seg, s);
    return launch_fwd_wg<false>(xe, xo, bias, ww, y5, ac, B, H, seg, s);
  }
  const void* w[5] = {w0, w1, w2, w3, w5};
  return launch_fwd_any<float, 4>(xe, xo, w, bias, y5, a, B, H, seg, s);
}

// K8b. dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (wgmma).
// gp5dd [H/2, 128, B*seg], gated and zero-interleaved (the contract in the
// note above: the bfloat16 kernel reads its data positions only); y0e, y0o
// [H, 32, B*seg], y1, y3 [H/2, 64, .], y2 [H/2, 32, .]; v0 .. v5 K2's
// swapped-channel weights of convs 0, 1, 2, 3, 5 (read in float32), u0 ..
// u5 the same packed for wgmma (K2's wg_weights; read in bfloat16, null in
// float32); gxe, gxo [H, 8, B*seg]. H a multiple of 8. Returns
// cudaGetLastError() (or a tensor map's error).
extern "C" int apfp_fused_stem_bwd_b(
    const void* gp5dd, const void* y0e, const void* y0o, const void* y1,
    const void* y2, const void* y3, const void* v0, const void* v1,
    const void* v2, const void* v3, const void* v5, const void* u0,
    const void* u1, const void* u2, const void* u3, const void* u5,
    void* gxe, void* gxo, int dtype, int B, int H, int seg, void* stream) {
  const void* a[5] = {y0e, y0o, y1, y2, y3};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const void* u[5] = {u0, u1, u2, u3, u5};
    return launch_bwd_wg(gp5dd, a, u, gxe, gxo, B, H, seg, s);
  }
  const void* v[5] = {v0, v1, v2, v3, v5};
  return launch_bwd<float>(gp5dd, a, v, gxe, gxo, B, H, seg, s);
}

// The K8a kernel of (dtype, save) as the card sees it: info[0] registers a
// thread, info[1] the dynamic shared memory bytes of a launch, info[2] the
// blocks one multiprocessor holds. Returns the CUDA error.
extern "C" int apfp_fused_stem_fwd_b_info(int dtype, int save, int* info) {
  if (dtype == 1)
    return save ? info_of(fused_stem_fwd_b_wg_kernel<true>, k8a::SMEM, info,
                          wg::NTH)
                : info_of(fused_stem_fwd_b_wg_kernel<false>, k8a::SMEM, info,
                          wg::NTH);
  const size_t smem = sizeof(float) * (size_t)GeomB<4>::ELEMS;
  return save ? info_of(fused_stem_fwd_b_kernel<float, 4, true>, smem, info)
              : info_of(fused_stem_fwd_b_kernel<float, 4, false>, smem, info);
}

// The K8b kernel of dtype as the card sees it (info as above)
extern "C" int apfp_fused_stem_bwd_b_info(int dtype, int* info) {
  if (dtype == 1)
    return info_of(fused_stem_bwd_b_wg_kernel, k8b::SMEM, info, wg::NTH);
  return info_of(fused_stem_bwd_b_kernel<float>,
                 sizeof(float) * (size_t)ChainB::ELEMS, info);
}
