// The 152^2 residual stage (YOLOv3 layers 6-11) in one kernel each way:
// K6a forward, K6b saved-mask input backward, and K6c, K6b widened by
// conv12's input cotangent.
//
// What each kernel replaces (the JAX package's ops/res_fused.py):
//   K6a, K6a save  res152_fused (:432, pl.pallas_call at :449), body
//                  _fwd_kernel (:236)
//   K6b            res152_fused_grad (:472, at :484), body _bwd_kernel
//                  (:297) -> _stage_chain (:367)
//   K6c            res152_fused_grad12 (:511, at :538), body _bwd12_kernel
//                  (:317) -> _stage_chain
// With T the rounding to the compute dtype, leaky(v) = max(v, 0.1 v) and
// m(v) = 1 if v > 0 else 0.1, K6a computes, in _fwd_kernel's order and at
// its rounding points,
//   a      = T(leaky(W6 x + b6))            1x1 128 -> 64
//   post7  = T(leaky(W7 * a + b7))          3x3  64 -> 128
//   y8     = T(post7 + x)
//   c      = T(leaky(W9 y8 + b9))           1x1 128 -> 64
//   post10 = T(leaky(W10 * c + b10))        3x3  64 -> 128
//   y11    = T(post10 + y8)
// and, with SAVE, the int8 signs (stored value > 0) of a, post7, c and
// post10 over all lanes. K6b computes, in _stage_chain's order,
//   gp10 = T(g11 m(post10))
//   gp9  = T((W10^T * gp10) m(c))
//   g8   = T(W9^T gp9 + g11)
//   gp7  = T(g8 m(post7))
//   gp6  = T((W7^T * gp7) m(a))
//   g5   = T(W6^T gp6 + g8)
// where W^T is the flipped, channel-swapped kernel (a stride-1 conv's
// input cotangent is the correlation with it). K6c (K6b's kernel with its
// W12 flag) takes conv12's pre-gated cotangent gp12 [B, H/2, 256, wl12]
// instead of g11 and first computes
//   g11  = T(conv12^T gp12)                 3x3 s2 256 -> 128
// over the tile's halo in a prologue, per output parity (as K2's stride-2
// adjoints), then runs the same chain; g11 never touches device memory.
// Every value at a row or column outside the image is zero (conv padding).
// All convs accumulate in float32. Planar tensors are [B, H, C, Wl],
// column c at lane c + 1; the blocks of the first and last tile columns
// write the border and padding lanes, so nothing needs a memset.
//
// What bounds it on the H100: at b24 608^2 bfloat16 the forward moves
// ~0.74 GB with SAVE (x read, y11 and four masks written) against
// 1.82e11 FLOP: bytes and operations are about equal (0.22 and 0.18 ms).
// A 152-wide stripe of rows does not fit a block (8 rows of bfloat16 x
// alone are ~470 KB against 227 KB), so each block owns a tile of
// positions for all 128 channels and works over its receptive field in
// shared memory; no intermediate touches device memory. The halos and the
// 64-row wgmma blocks make a block's GEMMs 54.5 MFLOP (1.37x its own
// positions' 39.8), 0.25 TFLOP a launch over the 10 x 19 x 24 = 4,560
// blocks, 0.25 ms at the card's peak; each block also reads the stage's
// 327,680 bytes of packed weights from L2 once (1.49 GB a launch; K6c's
// conv12^T 589,824 more, 2.69 GB).
//
// bfloat16 (res152_fwd_wg_kernel, res152_bwd_wg_kernel) is built for
// Hopper's units (stem_common.cuh: wg), as K1 and K2 are: every conv is an
// implicit GEMM (M the tile's positions in 64-row blocks, N the output
// channels, K the input channels x taps) on wgmma.mma_async, A from the
// [pos][pitch] tiles by ldmatrix into registers (a tap shift is an address
// offset), B from shared memory. A block is 288 threads: two consumer
// warpgroups and a producer warp, whose lane 0 streams each GEMM's packed
// weights (ops/res_fused.py: stage_packed, conv12_packed: wg_weights'
// 64-deep, 128-byte-swizzled chunks, taps in the kernel's order) by
// cp.async.bulk into a ring of 8 KB slots (nine in K6a, seven with SAVE,
// five in K6b / K6c) under full / empty mbarriers, once a block: every
// GEMM is one pass of two warpgroup items, so the next GEMM's first chunks
// are in flight under the current one's epilogue. Its lane 1 loads the
// block's tile (x, g11 or gp12) as TMA boxes of 32 channels
// (wg::planar_map) through two landing buffers over regions not yet live;
// a box starts on a 16-byte boundary, 8 lanes left of the tile's first
// (x and g11 40 lanes, gp12 24), and the consumers transpose it into the
// [pos][pitch] tile by ldmatrix.trans / stmatrix (land_tile), zeroing the
// columns outside the image. The GEMMs (a warpgroup's item: 64-row blocks
// x channels):
//   K6a: W6 over 12 x 20 (2 x 64), W7 over 10 x 18 (3 x 64, its A one
//        16-deep step at a time), W9 over 10 x 18 (3 x 32), W10 over the
//        own 8 x 16 (2 x 64)
//   K6b: W10^T over 10 x 18 (3 x 32), W9^T over 10 x 18 as two GEMMs of
//        64 channels (3 x 32 each: one of 128 spilled), W7^T and W6^T over
//        8 x 16 (2 x 32, 2 x 64)
//   K6c: first conv12^T's four output parities (RowsT2, K = 1, 2, 2 or 4
//        taps x 256) over 6 x 10 super positions each (1 x 64): the
//        odd-column parities' grid from the gp12 tile's first column, the
//        even-column ones' one column right, so each parity covers the
//        12 x 20 halo and nothing past it; then K6b's chain.
// Registers: ptxas allots 168 a thread to a block of 288; these plans run
// without a spill. The steps run as K4's forward does (taps, then 16-deep
// steps from a zero float32 accumulator: a wgmma k16 step sums as an
// mma.sync one), so bf16 K6a's y11 and its four masks equal the planar
// stage route's (models/res_planar.py: _forward, K4 x 4) bit for bit. The
// epilogues keep the FMA kernel's arithmetic (EpiAct, EpiPost7, EpiY11,
// EpiGp9, EpiG8, EpiGp6, EpiG5 below), so a kernel differs from its plain
// version by summation order alone.
//   The tile is 8 rows x 16 planar lanes (columns C0 - 1 .. C0 + 14 for
// C0 = 16 blockIdx.x), so every (row, channel) line a block writes is one
// aligned 32-byte sector of bfloat16 (16 bytes of int8), and lane 0 is a
// column outside the image of the first tile column. Forward regions: x
// [12 x 20][136], then c [10 x 18][72]; a [12 x 20][72], then y11's
// write-back stage [128][136]; post7, then y8 [10 x 18][136]; with SAVE
// post7's, then post10's signs staged [128][144] bytes (a's and c's are
// read back from their stored tiles, put_tile_signs); 223,984 bytes,
// 226,000 with SAVE, the ring and barriers included. Backward: g11, gp10
// [12 x 20][136], then gp7 [10 x 18][136], then g5's stage [128][136];
// gp9 [10 x 18][72], then gp6 [8 x 16][72]; g11's inner 10 x 18, then g8
// [10 x 18][136]; the three gates' sign bytes staged once ([10 x 18][68],
// [10 x 18][132], [8 x 16][68]); K6c's gp12 tile [7 x 12][264] over gp9's
// and g8's regions, dead until conv10^T's epilogue: 226,960 bytes. One
// block a multiprocessor. The epilogues stage y11 / g5 and the signs
// channel-major, and each line goes back to device memory whole (K4's
// write-back, planar_conv.cu), a warp 16 lines.

// float32 (res152_fwd_kernel, res152_bwd_kernel) keeps the CUDA-core FMA
// kernels (TF32 would not hold the float32 gradient checks): 8 x 8 column
// tiles, [position][channel] tiles padded by one 32-bit word, each thread
// a PT-position x 8-channel register tile, each tap's weights staged in
// shared memory (conv_tile); K6c's prologue per 2x2 super position by
// parity (conv12_adjoint). Shared memory: K6a 196,112 bytes, K6b and K6c
// 184,672 bytes.

#include "stem_common.cuh"

namespace {

using namespace stem;

constexpr int C = 128;  // stage width
constexpr int M = 64;   // the 1x1 convs' width
constexpr int TS = 8;   // output tile side
constexpr int N12 = TS + 4, N10 = TS + 2;

// channel stride of a [position][channel] tile: one 32-bit word of padding
template <typename T>
__host__ __device__ constexpr int pitch(int c) {
  return c + (sizeof(T) == 4 ? 1 : 2);
}

// Element counts of the shared-memory regions (the staged tap first, so
// it keeps the 16-byte alignment of the dynamic shared memory).
template <typename T>
struct Smem {
  static constexpr int WTAP = C * M;               // one tap's weights
  static constexpr int R12 = N12 * N12 * pitch<T>(C);
  static constexpr int R12M = N12 * N12 * pitch<T>(M);
  static constexpr int R10 = N10 * N10 * pitch<T>(C);
  static constexpr int R10M = N10 * N10 * pitch<T>(M);
  static constexpr int FWD = WTAP + R12 + R12M + R10;
  static constexpr int BWD = WTAP + R12 + R10M + R10;
};

// One conv of the stage over a [position][CIN] tile of side OH + KS - 1:
// output position (oy, ox) of the OH x OH tile sums
// in[(oy + ky, ox + kx)][ci] w[ky][kx][ci][co], float32, and hands the
// 8 sums of channels co0 .. co0 + 7 to epi(oy, ox, co0, acc). One pass:
// every thread owns PT positions (the last ones clamped and not stored).
// Each tap's [CIN][COUT] weights are staged in shared memory (wsm); the
// __syncthreads() before staging also orders the previous stage's
// epilogue stores before this stage's reads.
template <typename T, int CIN, int COUT, int KS, int OH, int PT, class Epi>
__device__ void conv_tile(const T* __restrict__ in, const T* __restrict__ w,
                          T* __restrict__ wsm, const Epi& epi) {
  constexpr int IW = OH + KS - 1;
  constexpr int NCG = COUT / CT;
  constexpr int NPG = NT / NCG;
  constexpr int NPOS = OH * OH;
  constexpr int CP = pitch<T>(CIN);
  static_assert(COUT % CT == 0 && NPG * PT >= NPOS, "thread mapping");
  const int cg = threadIdx.x % NCG;
  const int pg = threadIdx.x / NCG;
  const int co0 = cg * CT;
  float acc[PT][CT];
  int base[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int p = min(pg * PT + i, NPOS - 1);
    base[i] = ((p / OH) * IW + p % OH) * CP;
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[i][c] = 0.f;
  }
  for (int tap = 0; tap < KS * KS; ++tap) {
    __syncthreads();
    copy_to_shared(wsm, w + tap * CIN * COUT, CIN * COUT);
    __syncthreads();
    const int toff = ((tap / KS) * IW + tap % KS) * CP;
#pragma unroll 4
    for (int ci = 0; ci < CIN; ++ci) {
      float wv[CT];
      load8s(wsm + ci * COUT + co0, wv);
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        const float a = to_f(in[base[i] + toff + ci]);
#pragma unroll
        for (int c = 0; c < CT; ++c) acc[i][c] = fmaf(a, wv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int p = pg * PT + i;
    if (p < NPOS) epi(p / OH, p % OH, co0, acc[i]);
  }
}

__device__ __forceinline__ float leaky(float v) { return fmaxf(v, v * LEAKY); }

// Where a tile of side n starting at image (r0, c0) lies: its position
// (oy, ox) in the image, and the planar offset of (row, channel 0) lane.
struct Place {
  int b, H, W, wl, r0, c0;
  __device__ bool inside(int oy, int ox) const {
    const int r = r0 + oy, c = c0 + ox;
    return r >= 0 && r < H && c >= 0 && c < W;
  }
  // offset of (oy, ox, channel ch) in a planar [B, H, CH, wl] tensor
  __device__ long long at(int oy, int ox, int ch, int CH) const {
    return (((long long)b * H + r0 + oy) * CH + ch) * wl + c0 + ox + 1;
  }
};

// out[pos][co] = T(leaky(acc + bias)), zero outside the image; with a
// mask pointer, its sign at the block's own positions (tile offset own,
// side TS) into the planar int8 mask.
template <typename T, int COUT>
struct EpiAct {
  T* out;
  int OW;
  const float* bias;
  Place pl;
  int8_t* mask;
  int own;
  __device__ void operator()(int oy, int ox, int co0, const float* v) const {
    const bool in = pl.inside(oy, ox);
    const bool mine = mask != nullptr && oy >= own && oy < own + TS &&
                      ox >= own && ox < own + TS;
    T* o = out + (oy * OW + ox) * pitch<T>(COUT) + co0;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const float y = in ? round_t<T>(leaky(v[c] + bias[co0 + c])) : 0.f;
      o[c] = from_f<T>(y);
      if (mine && in) mask[pl.at(oy, ox, co0 + c, COUT)] = y > 0.f ? 1 : 0;
    }
  }
};

// post7 = T(leaky(acc + b7)), its sign at the own positions, and
// y8 = T(post7 + x) into the post7 tile (x read at tile offset +1)
template <typename T>
struct EpiPost7 {
  T* y8;
  const T* x;
  const float* bias;
  Place pl;
  int8_t* mask;
  __device__ void operator()(int oy, int ox, int co0, const float* v) const {
    const bool in = pl.inside(oy, ox);
    const bool mine = mask != nullptr && oy >= 1 && oy <= TS && ox >= 1 &&
                      ox <= TS;
    T* o = y8 + (oy * N10 + ox) * pitch<T>(C) + co0;
    const T* xr = x + ((oy + 1) * N12 + ox + 1) * pitch<T>(C) + co0;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      float y = 0.f;
      if (in) {
        const float p = round_t<T>(leaky(v[c] + bias[co0 + c]));
        if (mine) mask[pl.at(oy, ox, co0 + c, C)] = p > 0.f ? 1 : 0;
        y = round_t<T>(p + to_f(xr[c]));
      }
      o[c] = from_f<T>(y);
    }
  }
};

// post10 = T(leaky(acc + b10)), its sign, and y11 = T(post10 + y8) into
// device memory (y8 read at tile offset +1)
template <typename T>
struct EpiY11 {
  T* y11;
  const T* y8;
  const float* bias;
  Place pl;
  int8_t* mask;
  __device__ void operator()(int oy, int ox, int co0, const float* v) const {
    if (!pl.inside(oy, ox)) return;
    const T* yr = y8 + ((oy + 1) * N10 + ox + 1) * pitch<T>(C) + co0;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const float p = round_t<T>(leaky(v[c] + bias[co0 + c]));
      const long long o = pl.at(oy, ox, co0 + c, C);
      if (mask != nullptr) mask[o] = p > 0.f ? 1 : 0;
      y11[o] = from_f<T>(p + to_f(yr[c]));
    }
  }
};

// Zero lane 0 (first tile column) and the lanes past the image (last tile
// column) of the block's own rows, all CH channels, of a planar tensor.
template <typename U>
__device__ void zero_edges(U* t, U zero, int CH, int b, int H, int W,
                           int wl, int r0, bool first, bool last) {
  if (!(first || last)) return;
  const int nr = last ? wl - W - 1 : 0;
  const int n = nr + (first ? 1 : 0);
  for (int idx = threadIdx.x; idx < TS * CH * n; idx += NT) {
    const int k = idx % n;
    const int rest = idx / n;
    const int ch = rest % CH, r = r0 + rest / CH;
    const int lane = k < nr ? W + 1 + k : 0;
    if (r < H) t[(((long long)b * H + r) * CH + ch) * wl + lane] = zero;
  }
}

template <typename T>
struct FwdArgs {
  const T* x;
  const T* w6;
  const T* w7;
  const T* w9;
  const T* w10;
  const float* b6;
  const float* b7;
  const float* b9;
  const float* b10;
  T* y11;
  int8_t* am;
  int8_t* p7m;
  int8_t* cm;
  int8_t* p10m;
};

template <typename T, bool SAVE>
__global__ void __launch_bounds__(NT, 2)
    res152_fwd_kernel(FwdArgs<T> g, int H, int W, int wl) {
  using S = Smem<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* wsm = reinterpret_cast<T*>(smem_raw);  // one tap's weights
  T* X = wsm + S::WTAP;   // x [12^2][C], then c [10^2][M]
  T* A = X + S::R12;      // a [12^2][M]
  T* P = A + S::R12M;     // post7, then y8 [10^2][C]

  const int b = blockIdx.z;
  const int R0 = blockIdx.y * TS, C0 = blockIdx.x * TS;
  const bool first = blockIdx.x == 0, last = blockIdx.x == gridDim.x - 1;
  const Place p12 = {b, H, W, wl, R0 - 2, C0 - 2};
  const Place p10 = {b, H, W, wl, R0 - 1, C0 - 1};
  const Place p8 = {b, H, W, wl, R0, C0};

  // x tile, columns fastest (neighbouring lanes of one channel row)
  for (int idx = threadIdx.x; idx < N12 * C * N12; idx += NT) {
    const int k = idx % N12;
    const int rest = idx / N12;
    const int ch = rest % C, r = rest / C;
    T v = from_f<T>(0.f);
    if (p12.inside(r, k)) v = g.x[p12.at(r, k, ch, C)];
    X[(r * N12 + k) * pitch<T>(C) + ch] = v;
  }
  // a over 12^2 (the x tile's __syncthreads() is conv_tile's first)
  conv_tile<T, C, M, 1, N12, 5>(
      X, g.w6, wsm,
      EpiAct<T, M>{A, N12, g.b6, p12, SAVE ? g.am : nullptr, 2});
  // post7 over 10^2, then y8 in its place
  conv_tile<T, M, C, 3, N10, 7>(
      A, g.w7, wsm, EpiPost7<T>{P, X, g.b7, p10, SAVE ? g.p7m : nullptr});
  // c over 10^2 into the x region (x is dead once y8 exists)
  conv_tile<T, C, M, 1, N10, 4>(
      P, g.w9, wsm,
      EpiAct<T, M>{X, N10, g.b9, p10, SAVE ? g.cm : nullptr, 1});
  // post10 over the own 8^2, and y11 = post10 + y8 into device memory
  conv_tile<T, M, C, 3, TS, 4>(
      X, g.w10, wsm, EpiY11<T>{g.y11, P, g.b10, p8, SAVE ? g.p10m : nullptr});
  zero_edges(g.y11, from_f<T>(0.f), C, b, H, W, wl, R0, first, last);
  if (SAVE) {
    const int8_t z = 0;
    zero_edges(g.am, z, M, b, H, W, wl, R0, first, last);
    zero_edges(g.p7m, z, C, b, H, W, wl, R0, first, last);
    zero_edges(g.cm, z, M, b, H, W, wl, R0, first, last);
    zero_edges(g.p10m, z, C, b, H, W, wl, R0, first, last);
  }
}

// gp9 = T(acc m(c)), zero outside the image
template <typename T>
struct EpiGp9 {
  T* out;
  Place pl;
  const int8_t* cm;
  __device__ void operator()(int oy, int ox, int co0, const float* v) const {
    const bool in = pl.inside(oy, ox);
    T* o = out + (oy * N10 + ox) * pitch<T>(M) + co0;
#pragma unroll
    for (int c = 0; c < CT; ++c)
      o[c] = from_f<T>(in ? v[c] * gate(cm[pl.at(oy, ox, co0 + c, M)]) : 0.f);
  }
};

// g8 = T(acc + g11) and gp7 = T(g8 m(post7)), zero outside the image;
// g11 from device memory (K6b) or, with W12, from the g8 tile itself, where
// K6c's prologue left it (each element read, then overwritten, by the one
// thread that owns it)
template <typename T, bool W12>
struct EpiG8 {
  T* g8;
  T* gp7;
  Place pl;
  const T* g11;
  const int8_t* p7m;
  __device__ void operator()(int oy, int ox, int co0, const float* v) const {
    const bool in = pl.inside(oy, ox);
    const int o = (oy * N10 + ox) * pitch<T>(C) + co0;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      float g = 0.f, p = 0.f;
      if (in) {
        const long long q = pl.at(oy, ox, co0 + c, C);
        g = round_t<T>(v[c] + to_f(W12 ? g8[o + c] : g11[q]));
        p = g * gate(p7m[q]);
      }
      g8[o + c] = from_f<T>(g);
      gp7[o + c] = from_f<T>(p);
    }
  }
};

// gp6 = T(acc m(a)) over the own 8^2
template <typename T>
struct EpiGp6 {
  T* out;
  Place pl;
  const int8_t* am;
  __device__ void operator()(int oy, int ox, int co0, const float* v) const {
    const bool in = pl.inside(oy, ox);
    T* o = out + (oy * TS + ox) * pitch<T>(M) + co0;
#pragma unroll
    for (int c = 0; c < CT; ++c)
      o[c] = from_f<T>(in ? v[c] * gate(am[pl.at(oy, ox, co0 + c, M)]) : 0.f);
  }
};

// g5 = T(acc + g8) into device memory (g8 read at tile offset +1)
template <typename T>
struct EpiG5 {
  T* g5;
  const T* g8;
  Place pl;
  __device__ void operator()(int oy, int ox, int co0, const float* v) const {
    if (!pl.inside(oy, ox)) return;
    const T* gr = g8 + ((oy + 1) * N10 + ox + 1) * pitch<T>(C) + co0;
#pragma unroll
    for (int c = 0; c < CT; ++c)
      g5[pl.at(oy, ox, co0 + c, C)] = from_f<T>(v[c] + to_f(gr[c]));
  }
};

template <typename T>
struct BwdArgs {
  const T* g11;   // K6b
  const T* gp12;  // K6c: the pre-gated conv12 cotangent [B, H/2, 256, wl12]
  const T* w12t;  // K6c: conv12's weight, channels swapped [3][3][256][128]
  const int8_t* am;
  const int8_t* p7m;
  const int8_t* cm;
  const int8_t* p10m;
  const T* w6t;
  const T* w7t;
  const T* w9t;
  const T* w10t;
  T* g5;
};

// K6c's prologue: g11 = T(conv12^T gp12) over the 12^2 tile of origin
// (R0 - 2, C0 - 2) into out ([pos][pitch(C)]), zero outside the image. The
// stride-2 adjoint is computed per 2x2 super position (a, b), a = R0/2 - 1
// + la for la in [0, 6): output rows 2a (tap dy = 1 at input row a) and
// 2a + 1 (dy = 0 at a + 1, dy = 2 at a), columns alike, so every tap is a
// dense product and no multiply-add meets a zero. in is the gp12 tile of
// origin (R0/2 - 1, C0/2 - 1), 7^2 positions [pos][pitch(256)]. Parity by
// parity, each thread holds PT super positions x 8 output channels; each
// tap's weights are staged in shared memory 64 input channels at a time
// (64 x 128, one K6b tap's size).
template <typename T>
__device__ void conv12_adjoint(const T* __restrict__ in,
                               const T* __restrict__ w12t, T* __restrict__ wsm,
                               T* __restrict__ out, const Place& pl) {
  constexpr int CIN = 2 * C, NS = N12 / 2, NIN = NS + 1, PT = 3;
  constexpr int NCG = C / CT;
  constexpr int NPG = NT / NCG;
  constexpr int CP = pitch<T>(CIN);
  constexpr int CH = Smem<T>::WTAP / C;  // input channels a staging
  static_assert(NPG * PT >= NS * NS && CIN % CH == 0, "thread mapping");
  const int cg = threadIdx.x % NCG;
  const int pg = threadIdx.x / NCG;
  const int co0 = cg * CT;
  int sa[PT], sb[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int sp = min(pg * PT + i, NS * NS - 1);
    sa[i] = sp / NS;
    sb[i] = sp % NS;
  }
  for (int q = 0; q < 4; ++q) {
    const int py = q >> 1, px = q & 1;
    float acc[PT][CT];
#pragma unroll
    for (int i = 0; i < PT; ++i)
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[i][c] = 0.f;
    for (int ty = 0; ty <= py; ++ty) {
      for (int tx = 0; tx <= px; ++tx) {
        // even output: tap 1 at offset 0; odd: tap 0 at +1, tap 2 at 0
        const int dy = py ? 2 * ty : 1, ay = py ? 1 - ty : 0;
        const int dx = px ? 2 * tx : 1, ax = px ? 1 - tx : 0;
        const T* wt = w12t + (dy * 3 + dx) * CIN * C;
        int base[PT];
#pragma unroll
        for (int i = 0; i < PT; ++i)
          base[i] = ((sa[i] + ay) * NIN + sb[i] + ax) * CP;
        for (int c0 = 0; c0 < CIN; c0 += CH) {
          __syncthreads();
          copy_to_shared(wsm, wt + c0 * C, CH * C);
          __syncthreads();
#pragma unroll 4
          for (int ci = 0; ci < CH; ++ci) {
            float wv[CT];
            load8s(wsm + ci * C + co0, wv);
#pragma unroll
            for (int i = 0; i < PT; ++i) {
              const float a = to_f(in[base[i] + c0 + ci]);
#pragma unroll
              for (int c = 0; c < CT; ++c)
                acc[i][c] = fmaf(a, wv[c], acc[i][c]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      if (pg * PT + i >= NS * NS) break;
      const int oy = 2 * sa[i] + py, ox = 2 * sb[i] + px;
      const bool inside = pl.inside(oy, ox);
      T* o = out + (oy * N12 + ox) * pitch<T>(C) + co0;
#pragma unroll
      for (int c = 0; c < CT; ++c) o[c] = from_f<T>(inside ? acc[i][c] : 0.f);
    }
  }
}

template <typename T, bool W12>
__global__ void __launch_bounds__(NT, 2)
    res152_bwd_kernel(BwdArgs<T> g, int H, int W, int wl, int wl12) {
  using S = Smem<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* wsm = reinterpret_cast<T*>(smem_raw);
  T* A = wsm + S::WTAP;   // gp10 [12^2][C], then gp7 [10^2][C]
  T* B = A + S::R12;      // gp9 [10^2][M], then gp6 [8^2][M]
  T* G8 = B + S::R10M;    // g8 [10^2][C]

  const int b = blockIdx.z;
  const int R0 = blockIdx.y * TS, C0 = blockIdx.x * TS;
  const Place p12 = {b, H, W, wl, R0 - 2, C0 - 2};
  const Place p10 = {b, H, W, wl, R0 - 1, C0 - 1};
  const Place p8 = {b, H, W, wl, R0, C0};

  if constexpr (W12) {
    // K6c: the gp12 tile over B and G8 (dead until conv10^T's epilogue),
    // then g11 over 12^2 into A
    constexpr int N = N12 / 2 + 1, CIN = 2 * C;
    static_assert(N * N * pitch<T>(CIN) <= S::R10M + S::R10, "gp12 tile");
    const int H12 = H / 2, W12c = W / 2;
    const int r0 = R0 / 2 - 1, c0 = C0 / 2 - 1;
    for (int idx = threadIdx.x; idx < N * CIN * N; idx += NT) {
      const int k = idx % N;
      const int rest = idx / N;
      const int ch = rest % CIN, r = rest / CIN;
      const int gr = r0 + r, gc = c0 + k;
      T v = from_f<T>(0.f);
      if (gr >= 0 && gr < H12 && gc >= 0 && gc < W12c)
        v = g.gp12[(((long long)b * H12 + gr) * CIN + ch) * wl12 + gc + 1];
      B[(r * N + k) * pitch<T>(CIN) + ch] = v;
    }
    conv12_adjoint<T>(B, g.w12t, wsm, A, p12);
    __syncthreads();
  }
  // gp10 = T(g11 m(post10)) over 12^2, columns fastest; with W12, g11 is
  // read from A and its inner 10^2 kept in G8 for EpiG8
  for (int idx = threadIdx.x; idx < N12 * C * N12; idx += NT) {
    const int k = idx % N12;
    const int rest = idx / N12;
    const int ch = rest % C, r = rest / C;
    const int o = (r * N12 + k) * pitch<T>(C) + ch;
    float v = 0.f;
    if constexpr (W12) {
      const T g11 = A[o];
      if (r >= 1 && r <= N10 && k >= 1 && k <= N10)
        G8[((r - 1) * N10 + k - 1) * pitch<T>(C) + ch] = g11;
      if (p12.inside(r, k))
        v = to_f(g11) * gate(g.p10m[p12.at(r, k, ch, C)]);
    } else if (p12.inside(r, k)) {
      const long long q = p12.at(r, k, ch, C);
      v = to_f(g.g11[q]) * gate(g.p10m[q]);
    }
    A[o] = from_f<T>(v);
  }
  conv_tile<T, C, M, 3, N10, 4>(A, g.w10t, wsm, EpiGp9<T>{B, p10, g.cm});
  conv_tile<T, M, C, 1, N10, 7>(B, g.w9t, wsm,
                                EpiG8<T, W12>{G8, A, p10, g.g11, g.p7m});
  conv_tile<T, C, M, 3, TS, 2>(A, g.w7t, wsm, EpiGp6<T>{B, p8, g.am});
  conv_tile<T, M, C, 1, TS, 4>(B, g.w6t, wsm, EpiG5<T>{g.g5, G8, p8});
  zero_edges(g.g5, from_f<T>(0.f), C, b, H, W, wl, R0, blockIdx.x == 0,
             blockIdx.x == gridDim.x - 1);
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma on weights streamed into shared memory
// ---------------------------------------------------------------------------

namespace tc {

constexpr int TR = 8, TL = 16;                // own tile: rows x lanes
constexpr int R12 = TR + 4, L12 = TL + 4;     // the 12 x 20 halo
constexpr int R10 = TR + 2, L10 = TL + 2;     // the 10 x 18 halo
constexpr int PC = C + 8, PM = M + 8;         // row pitches (elements)
constexpr int OP = TR * TL + 8;               // output stage, a channel
constexpr int SP = TR * TL + 16;              // sign stage: a channel's bytes
// K6c: NSR x NSC super positions a parity over the gp12 tile of
// (NSR + 1) x GW positions at pitch P12
constexpr int NSR = R12 / 2, NSC = L12 / 2, GW = NSC + 2;
constexpr int P12 = 2 * C + 8;
// element counts of the regions
constexpr int N12C = R12 * L12 * PC;          // x, g11, gp10
constexpr int N12M = R12 * L12 * PM;          // a
constexpr int N10C = R10 * L10 * PC;          // post7 / y8, gp7, g8
constexpr int N10M = R10 * L10 * PM;          // c, gp9
constexpr int NOUT = C * OP;                  // y11's or g5's stage
constexpr int FWD_A = N12M > NOUT ? N12M : NOUT;
constexpr int FWD_BYTES = 2 * (N12C + FWD_A + N10C);
constexpr int SIGN_BYTES = C * SP;            // SAVE: post7's, then post10's
// the backward's staged gate bytes: c and post7 over 10 x 18, a over 8 x 16
constexpr int MC = R10 * L10 * (M + 4), MP7 = R10 * L10 * (C + 4);
constexpr int MA = TR * TL * (M + 4);
constexpr int BWD_BYTES = 2 * (N12C + N10M + N10C) + MC + MP7 + MA;
static_assert(N10C <= N12C && NOUT <= N12C && TR * TL * PM <= N10M,
              "backward regions");
static_assert((NSR + 1) * GW * P12 <= N10M + N10C, "gp12 tile");
static_assert(FWD_BYTES % 16 == 0 && (2 * N12C) % 16 == 0 &&
                  (2 * FWD_A) % 16 == 0 && (2 * N10M) % 16 == 0 &&
                  MC % 16 == 0 && MP7 % 16 == 0,
              "16-byte aligned regions");

// The tile boxes (the tensor unit): BC channels of a planar tensor, their
// lanes from the 16-byte boundary 8 lanes below the tile's first lane (x
// and g11: XBL lanes from C0 - 8, 80-byte lines, so that the eight channel
// lines a transposing ldmatrix reads fall in distinct bank groups; gp12:
// GBL lanes from C0/2 - 8, 48-byte lines). Two landing buffers: x's over a
// and post7, g11's over gp9 and g8, gp12's over gp10.
constexpr int BC = 32, XBL = 40, GBL = 24;
constexpr int XBOX = R12 * BC * XBL * 2;         // bytes a box
constexpr int GBOX = (NSR + 1) * BC * GBL * 2;
static_assert(2 * XBOX <= 2 * (FWD_A + N10C) &&
                  2 * XBOX <= 2 * (N10M + N10C) && 2 * GBOX <= 2 * N12C &&
                  XBOX % 128 == 0 && GBOX % 128 == 0 && (2 * N12C) % 128 == 0,
              "landing buffers");

// The weight ring: 8 KB slots, nine beside the forward's regions (seven
// beside them and the sign stage with SAVE), five beside the backward's;
// then the landing buffers' full and empty barriers
constexpr int SLOT = 8192, BWD_STAGES = 5, LBAR_BYTES = 32;
template <bool SAVE>
__host__ __device__ constexpr int fwd_stages() {
  return SAVE ? 7 : 9;
}
template <bool SAVE>
__host__ __device__ constexpr int fwd_smem() {
  return FWD_BYTES + (SAVE ? SIGN_BYTES : 0) +
         wg::ring_bytes(fwd_stages<SAVE>(), SLOT) + LBAR_BYTES;
}
constexpr int BWD_SMEM =
    BWD_BYTES + wg::ring_bytes(BWD_STAGES, SLOT) + LBAR_BYTES;
static_assert(fwd_smem<false>() <= 232448 && fwd_smem<true>() <= 232448 &&
                  BWD_SMEM <= 232448,
              "shared memory");

// One GEMM of the stage: taps, depth a tap, N, channel groups, 64-row
// blocks an item, rows, the steps of a wgmma group; one pass, so its chunks
// stream through the ring once (no ring holds it resident: stages 0)
template <int NTAP, int KT, int N, int NG, int MT, int ROWS, int GS>
using Gemm = wg::Gemm<NTAP, KT, N, NG, MT, ROWS, SLOT, 0, 1, GS>;
// ptxas allots 168 registers a thread to a block of 288. A warpgroup's
// item of three 64-row blocks x 64 channels (W7 over the 10 x 18 halo: 96
// accumulators) fits with its A fragments loaded a step at a time (GS 1);
// the backward's W9^T of that shape spilled, so it runs as two GEMMs of 64
// output channels (B9h), each half's weights streamed once.
using F6 = Gemm<1, C, M, 1, 2, R12 * L12, 2>;
using F7 = Gemm<9, M, C, 2, 3, R10 * L10, 1>;
using F9 = Gemm<1, C, M, 2, 3, R10 * L10, 2>;
using F10 = Gemm<9, M, C, 2, 2, TR * TL, 2>;
// the backward: W10^T and W9^T over 10 x 18, W7^T and W6^T over 8 x 16
using B10 = Gemm<9, C, M, 2, 3, R10 * L10, 2>;
using B9h = Gemm<1, M, M, 2, 3, R10 * L10, 2>;
using B7 = Gemm<9, C, M, 2, 2, TR * TL, 4>;
using B6 = Gemm<1, M, C, 2, 2, TR * TL, 2>;
// K6c's prologue: conv12^T's output parity (PY, PX) over NSR x NSC super
// positions, K = 1, 2, 2 or 4 taps x 256
template <int PY, int PX>
using U12 = Gemm<(PY + 1) * (PX + 1), 2 * C, C, 2, 1, NSR * NSC, 4>;
template <class... G>
constexpr bool one_pass() {
  return ((G::NPASS == 1 && !G::RES) && ...);
}
static_assert(one_pass<F6, F7, F9, F10, B10, B9h, B7, B6, U12<0, 0>,
                       U12<0, 1>, U12<1, 0>, U12<1, 1>>(),
              "every GEMM in one pass: its weights read once a block");

// The bfloat16 kernels' weights packed for wgmma (ops/res_fused.py:
// stage_packed, conv12_packed): the forward's W6, W7, W9, W10, or the
// backward's W6^T, W7^T, W9^T (its two halves), W10^T and K6c's conv12^T
// by parity
struct Packed {
  const unsigned char* w[5];
};

// An epilogue for the output channels from n0 (a half's GEMM)
template <class E>
struct From {
  E e;
  int n0;
  __device__ void operator()(int oy, int ox, int n, float v0,
                             float v1) const {
    e(oy, ox, n0 + n, v0, v1);
  }
};

// A tile's origin in the image: tile position (oy, ox) is image (r0 + oy,
// c0 + ox)
struct Org {
  int r0, c0, H, W;
  __device__ bool inside(int oy, int ox) const {
    const int r = r0 + oy, c = c0 + ox;
    return r >= 0 && r < H && c >= 0 && c < W;
  }
};

// 4 channels' mask bytes of one vector of 8 lanes (zero where the row or
// the vector lies outside the tensor): m the image's [H][CH][wl] int8
// mask, lines ch .. ch + 3 of row gr, lanes l .. l + 7
__device__ __forceinline__ void load_mask4(uint2 (&mv)[4],
                                           const int8_t* __restrict__ m,
                                           int gr, int ch, int l, int H,
                                           int CH, int wl) {
#pragma unroll
  for (int t = 0; t < 4; ++t) mv[t] = make_uint2(0, 0);
  if (gr < 0 || gr >= H || l < 0 || l >= wl) return;
  const int8_t* s = m + ((long long)gr * CH + ch) * wl + l;
#pragma unroll
  for (int t = 0; t < 4; ++t)
    mv[t] = __ldg(reinterpret_cast<const uint2*>(s + (long long)t * wl));
}

// Stage the sign bytes of one image's planar int8 mask m [H][CH][wl] over
// a window (rows ir0 .., columns col0 .., R x NC; its first lane OFF past
// a multiple of 8) into s [pos][CH + 4]: 8-byte loads of 8 lanes, one
// 4-byte store of 4 channels a position. Rows and vectors outside the
// tensor stage zeros (no epilogue reads a gate outside the image).
template <int R, int NC, int OFF, int CH>
__device__ void stage_mask(unsigned char* __restrict__ s,
                           const int8_t* __restrict__ m, int ir0, int col0,
                           int H, int wl) {
  constexpr int NV = (OFF + NC + 7) / 8;
  constexpr int NQ = CH / 4;
  const int l0 = col0 + 1 - OFF;
  for (int idx = threadIdx.x; idx < R * NV * NQ; idx += NT) {
    const int p = idx % NQ;
    const int rest = idx / NQ;
    const int v = rest % NV, r = rest / NV;
    const int l = l0 + 8 * v;
    uint2 mv[4];
    load_mask4(mv, m, ir0 + r, 4 * p, l, H, CH, wl);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * v + j - OFF;
      if (col < 0 || col >= NC) continue;
      uint32_t word = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        word |= (uint32_t)reinterpret_cast<const unsigned char*>(&mv[t])[j]
                << (8 * t);
      *reinterpret_cast<uint32_t*>(s + (r * NC + col) * (CH + 4) + 4 * p) =
          word;
    }
  }
}

// gp10 = T(g11 m(post10)) in place over the 12 x 20 tile t (g11 there,
// zero outside the image), g11's inner 10 x 18 kept in g8 for EpiG8TC;
// post10's mask lines (m: the image's [H][C][wl]) read as 8-byte vectors
// of 8 lanes, 4 channels an item
__device__ void gate_g11(bf16* __restrict__ t, bf16* __restrict__ g8,
                         const int8_t* __restrict__ m, int ir0, int col0,
                         int H, int wl) {
  constexpr int OFF = 6, NV = (OFF + L12 + 7) / 8, NQ = C / 4;
  const int l0 = col0 + 1 - OFF;
  for (int idx = threadIdx.x; idx < R12 * NV * NQ; idx += NT) {
    const int p = idx % NQ;
    const int rest = idx / NQ;
    const int v = rest % NV, r = rest / NV;
    uint2 mv[4];
    load_mask4(mv, m, ir0 + r, 4 * p, l0 + 8 * v, H, C, wl);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * v + j - OFF;
      if (col < 0 || col >= L12) continue;
      uint2* q = reinterpret_cast<uint2*>(t + (r * L12 + col) * PC + 4 * p);
      const uint2 raw = *q;
      if (r >= 1 && r <= R10 && col >= 1 && col <= L10)
        *reinterpret_cast<uint2*>(g8 + ((r - 1) * L10 + col - 1) * PC +
                                  4 * p) = raw;
      const bf16* g = reinterpret_cast<const bf16*>(&raw);
      float y[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        y[k] = to_f(g[k]) *
               gate(reinterpret_cast<const int8_t*>(&mv[k])[j]);
      uint2 w;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
      w.x = *reinterpret_cast<const uint32_t*>(&lo);
      w.y = *reinterpret_cast<const uint32_t*>(&hi);
      *q = w;
    }
  }
}

// The block's own 8 x 16 lanes of a staged output st [CH][OP] into a
// planar tensor (dst: the image's [H][CH][wl]): a line (row, channel) is
// two 16-byte stores, rows and halves fastest (conflict-free stage reads)
template <int CH>
__device__ void put_tile(const bf16* __restrict__ st, bf16* __restrict__ dst,
                         int R0, int C0, int H, int wl) {
  for (int idx = threadIdx.x; idx < 2 * TR * CH; idx += NT) {
    const int h = idx & 1;
    const int rest = idx >> 1;
    const int r = rest % TR, ch = rest / TR;
    if (R0 + r >= H) continue;
    *reinterpret_cast<uint4*>(dst + ((long long)(R0 + r) * CH + ch) * wl +
                              C0 + 8 * h) =
        *reinterpret_cast<const uint4*>(st + ch * OP + r * TL + 8 * h);
  }
}

// The block's own 8 x 16 lanes of a sign stage s [CH][SP] bytes into a
// planar int8 mask (dst: the image's [H][CH][wl]): one 16-byte store a
// line
template <int CH>
__device__ void put_signs(const unsigned char* __restrict__ s,
                          int8_t* __restrict__ dst, int R0, int C0, int H,
                          int wl) {
  for (int idx = threadIdx.x; idx < TR * CH; idx += NT) {
    const int r = idx % TR, ch = idx / TR;
    if (R0 + r >= H) continue;
    *reinterpret_cast<uint4*>(dst + ((long long)(R0 + r) * CH + ch) * wl +
                              C0) =
        *reinterpret_cast<const uint4*>(s + ch * SP + r * TL);
  }
}

// The last tile column: zero lanes C0 + 16 .. wl - 1 of the block's rows
// of a planar tensor (dst: the image's [H][CH][wl])
template <typename U>
__device__ void zero_right(U* __restrict__ dst, int CH, int R0, int C0,
                           int H, int wl) {
  if (blockIdx.x != gridDim.x - 1) return;
  zero_tail(dst + (long long)R0 * CH * wl, min(TR, H - R0) * CH, C0 + TL,
            wl, NT);
}


// One box of BC channels (landed at shared address land: [R rows][BC][BL
// lanes], box lane 0 at the image's lane l0) -> channels ch0 .. ch0 + BC - 1
// of the tile dst [pos][P] (pos = r NC + col; tile column col at box lane
// col + OFF), zero at image columns outside [0, W): 8 lanes x 8 channels a
// matrix, ldmatrix.trans then stmatrix (K4's transpose); a matrix row that
// falls outside the tile goes to the padding unit of its row's first
// position
template <int R, int NC, int OFF, int BL, int P>
__device__ __forceinline__ void land_tile(uint32_t land, bf16* dst, int ch0,
                                          int l0, int W) {
  constexpr int NV = (OFF + NC + 7) / 8;  // 8-lane groups holding the tile
  static_assert(NV * 8 <= BL && P % 8 == 0, "box geometry");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mi = lane >> 3, rr = lane & 7;
  for (int i = warp; i < R * NV; i += NT / 32) {
    const int v = i % NV, iy = i / NV;
    uint32_t x[4];
    ldsm4t(x, land + ((iy * BC + 8 * mi + rr) * BL + 8 * v) * 2);
    // this thread's values: box lane 8 v + lane / 4, image column gc
    const int gc = l0 + 8 * v + (lane >> 2) - 1;
    const bool in = gc >= 0 && gc < W;
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = in ? x[k] : 0u;
    // the row this lane addresses: matrix mi's row rr, tile column col
    const int col = 8 * v + rr - OFF;
    const bool ok = col >= 0 && col < NC;
    stsm4(wg::smem_u32(dst + (iy * NC + (ok ? col : 0)) * P +
                       (ok ? ch0 + 8 * mi : P - 8)),
          x);
  }
}

// The landing buffers' barriers at shared address b: full[2] (the box
// landed), then empty[2] (every consumer warp transposed it); initialised
// by thread 0 (a __syncthreads must follow)
__device__ __forceinline__ void init_landing(uint32_t b) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      wg::mbar_init(b + 8 * i, 1);
      wg::mbar_init(b + 16 + 8 * i, wg::CONSUMER_WARPS);
    }
    wg::fence_barrier_init();
  }
}

// The producer's part of a tile (one thread): N boxes of BOX bytes, box k
// the channels from BC k of the tensor map at (lane l, row r, image b),
// through the two landing buffers at land
template <int N, int BOX>
__device__ __forceinline__ void produce_boxes(const CUtensorMap* map,
                                              uint32_t land, uint32_t bar,
                                              int l, int r, int b) {
  for (int k = 0; k < N; ++k) {
    const int sl = k & 1;
    if (k >= 2) wg::mbar_wait(bar + 16 + 8 * sl, ((k >> 1) - 1) & 1);
    wg::mbar_expect_tx(bar + 8 * sl, BOX);
    wg::tma_load_4d(land + sl * BOX, map, l, BC * k, r, b, bar + 8 * sl);
  }
}

// The consumers' part: each box waited for, transposed into the tile
// (land_tile) and its buffer freed
template <int N, int BOX, int R, int NC, int OFF, int BL, int P>
__device__ __forceinline__ void consume_boxes(uint32_t land, uint32_t bar,
                                              bf16* dst, int l0, int W,
                                              wg::Lap& lap) {
  for (int k = 0; k < N; ++k) {
    const int sl = k & 1;
    wg::mbar_wait(bar + 8 * sl, (k >> 1) & 1);
    lap(wg::P_INPUT);
    land_tile<R, NC, OFF, BL, P>(land + sl * BOX, dst, BC * k, l0, W);
    wg::arrive(bar + 16 + 8 * sl);
    lap(wg::P_LOAD);
  }
}

// The signs (stored value > 0) of a [pos][PM] tile t of row width TW at the
// block's own 8 x 16 positions (tile offset off) into a planar int8 mask
// (dst: the image's [H][CH][wl]): a thread takes 8 positions x 4 channels
// of a row (8-byte reads) and writes 4 lines' 8 lanes (8-byte stores)
template <int CH>
__device__ void put_tile_signs(const bf16* __restrict__ t, int TW, int off,
                               int8_t* __restrict__ dst, int R0, int C0,
                               int H, int wl) {
  constexpr int NQ = CH / 4;
  for (int idx = threadIdx.x; idx < TR * 2 * NQ; idx += NT) {
    const int q = idx % NQ;
    const int rest = idx / NQ;
    const int h = rest & 1, r = rest >> 1;
    if (R0 + r >= H) continue;
    uint32_t word[4][2] = {};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint2 v = *reinterpret_cast<const uint2*>(
          t + ((r + off) * TW + off + 8 * h + i) * PM + 4 * q);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (to_f(e[c]) > 0.f) word[c][i / 4] |= 1u << (8 * (i % 4));
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<uint2*>(
          dst + ((long long)(R0 + r) * CH + 4 * q + c) * wl + C0 + 8 * h) =
          make_uint2(word[c][0], word[c][1]);
  }
}

// a or c: T(leaky(acc + b)) into out [pos][PM] of row width OW, zero
// outside the image (EpiAct's arithmetic; the signs are read back from the
// stored values, put_tile_signs)
struct EpiActTC {
  bf16* out;
  int OW;
  const float* bias;
  Org o;
  __device__ void operator()(int oy, int ox, int n, float v0,
                             float v1) const {
    const bool in = o.inside(oy, ox);
    const float y0 = in ? round_t<bf16>(leaky(v0 + bias[n])) : 0.f;
    const float y1 = in ? round_t<bf16>(leaky(v1 + bias[n + 1])) : 0.f;
    store2(out + (oy * OW + ox) * PM + n, y0, y1);
  }
};

// post7 = T(leaky(acc + b7)), its sign at the own positions into the sign
// stage sg [ch][SP] (SAVE), and y8 = T(post7 + x) into y8 [pos][PC]
// (10 x 18; x [12 x 20][PC] read at tile offset +1) (EpiPost7's
// arithmetic)
template <bool SAVE>
struct EpiPost7TC {
  bf16* y8;
  const bf16* x;
  const float* bias;
  Org o;
  unsigned char* sg;
  __device__ void operator()(int oy, int ox, int n, float v0,
                             float v1) const {
    const bool in = o.inside(oy, ox);
    const float v[2] = {v0, v1};
    const bf16* xr = x + ((oy + 1) * L12 + ox + 1) * PC + n;
    const bool mine = SAVE && oy >= 1 && oy <= TR && ox >= 1 && ox <= TL;
    float y[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float p = 0.f;
      y[c] = 0.f;
      if (in) {
        p = round_t<bf16>(leaky(v[c] + bias[n + c]));
        y[c] = round_t<bf16>(p + to_f(xr[c]));
      }
      if (mine) sg[(n + c) * SP + (oy - 1) * TL + ox - 1] = p > 0.f ? 1 : 0;
    }
    store2(y8 + (oy * L10 + ox) * PC + n, y[0], y[1]);
  }
};

// post10 = T(leaky(acc + b10)), its sign into the sign stage sg (SAVE),
// and y11 = T(post10 + y8) into the output stage [C][OP] (y8 [10 x 18][PC]
// read at tile offset +1), zero outside the image (EpiY11's arithmetic)
template <bool SAVE>
struct EpiY11TC {
  bf16* st;
  const bf16* y8;
  const float* bias;
  Org o;
  unsigned char* sg;
  __device__ void operator()(int oy, int ox, int n, float v0,
                             float v1) const {
    const bool in = o.inside(oy, ox);
    const float v[2] = {v0, v1};
    const bf16* yr = y8 + ((oy + 1) * L10 + ox + 1) * PC + n;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float p = 0.f, y = 0.f;
      if (in) {
        p = round_t<bf16>(leaky(v[c] + bias[n + c]));
        y = p + to_f(yr[c]);
      }
      if (SAVE) sg[(n + c) * SP + oy * TL + ox] = p > 0.f ? 1 : 0;
      st[(n + c) * OP + oy * TL + ox] = __float2bfloat16_rn(y);
    }
  }
};

// gp9 = T(acc m(c)) into out [pos][PM] of row width OW (gp9; gp6 with the
// gate of a), the gates' bytes staged [pos][M + 4] at the tile's positions
// (EpiGp9's and EpiGp6's arithmetic)
struct EpiGateTC {
  bf16* out;
  int OW;
  Org o;
  const unsigned char* m;
  __device__ void operator()(int oy, int ox, int n, float v0,
                             float v1) const {
    float y0 = 0.f, y1 = 0.f;
    if (o.inside(oy, ox)) {
      const unsigned char* g = m + (oy * OW + ox) * (M + 4) + n;
      y0 = v0 * gate(g[0]);
      y1 = v1 * gate(g[1]);
    }
    store2(out + (oy * OW + ox) * PM + n, y0, y1);
  }
};

// g8 = T(acc + g11) in place of g11 (g8 [10 x 18][PC]) and
// gp7 = T(g8 m(post7)) into gp7 [10 x 18][PC] (EpiG8's arithmetic)
struct EpiG8TC {
  bf16* g8;
  bf16* gp7;
  Org o;
  const unsigned char* m;  // post7's gate bytes [10 x 18][C + 4]
  __device__ void operator()(int oy, int ox, int n, float v0,
                             float v1) const {
    const int q = (oy * L10 + ox) * PC + n;
    float g[2] = {0.f, 0.f}, p[2] = {0.f, 0.f};
    if (o.inside(oy, ox)) {
      const float2 h =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g8 + q));
      const unsigned char* mg = m + (oy * L10 + ox) * (C + 4) + n;
      g[0] = round_t<bf16>(v0 + h.x);
      g[1] = round_t<bf16>(v1 + h.y);
      p[0] = g[0] * gate(mg[0]);
      p[1] = g[1] * gate(mg[1]);
    }
    store2(g8 + q, g[0], g[1]);
    store2(gp7 + q, p[0], p[1]);
  }
};

// g5 = T(acc + g8) into the output stage [C][OP] (g8 read at tile offset
// +1), zero outside the image (EpiG5's arithmetic)
struct EpiG5TC {
  bf16* st;
  const bf16* g8;
  Org o;
  __device__ void operator()(int oy, int ox, int n, float v0,
                             float v1) const {
    float y[2] = {0.f, 0.f};
    if (o.inside(oy, ox)) {
      const float2 h = __bfloat1622float2(*reinterpret_cast<
          const __nv_bfloat162*>(g8 + ((oy + 1) * L10 + ox + 1) * PC + n));
      y[0] = v0 + h.x;
      y[1] = v1 + h.y;
    }
#pragma unroll
    for (int c = 0; c < 2; ++c)
      st[(n + c) * OP + oy * TL + ox] = __float2bfloat16_rn(y[c]);
  }
};


// K6c's prologue epilogue: g11 = T(acc) into t [12 x 20][PC], zero outside
// the image. Output (oy, ox) of a parity GEMM (RowsT2) is tile position
// (oy, ox + sh): the odd-column parities' super grid starts at the gp12
// tile's first column, tile column -1 (sh = -1), the even-column ones' one
// super column later (sh = +1), so the 6 x 10 super positions of each
// parity cover the tile's 12 x 20 and nothing outside it.
struct EpiG11TC {
  bf16* t;
  Org o;
  int sh;
  __device__ void operator()(int oy, int ox, int n, float v0,
                             float v1) const {
    const int tx = ox + sh;
    const bool in = o.inside(oy, tx);
    store2(t + (oy * L12 + tx) * PC + n, in ? v0 : 0.f, in ? v1 : 0.f);
  }
};

}  // namespace tc

// K6a in bfloat16: the block's 8 x 16 lanes (rows R0 .., columns C0 - 1 ..)
// of y11 and, with SAVE, of the four masks. 288 threads: two consumer
// warpgroups and the producer warp, which streams W6, W7, W9 and W10's
// packed chunks into the ring once each.
template <bool SAVE>
__global__ void __launch_bounds__(wg::NTH, 1)
    res152_fwd_wg_kernel(const __grid_constant__ CUtensorMap tmx,
                         FwdArgs<bf16> g, tc::Packed pk, int H, int W,
                         int wl) {
  using namespace tc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* X = reinterpret_cast<bf16*>(smem_raw);  // x, then c
  bf16* A = X + N12C;                           // a, then y11's stage
  bf16* P = A + FWD_A;                          // post7, then y8
  unsigned char* sg = smem_raw + FWD_BYTES;     // SAVE: post7's, post10's
  auto ring = wg::make_ring<fwd_stages<SAVE>(), SLOT>(wg::smem_u32(
      smem_raw + FWD_BYTES + (SAVE ? SIGN_BYTES : 0)));
  const uint32_t land = wg::smem_u32(A);  // x's boxes, over a and post7
  const uint32_t lbar = ring.empty + 8 * fwd_stages<SAVE>();
  init_landing(lbar);
  __syncthreads();
  const int R0 = blockIdx.y * TR, C0 = blockIdx.x * TL, oc = C0 - 1;
  if (threadIdx.x >= wg::NC) {
    // the producer warp: lane 0 the weights, lane 1 x's boxes
    if (threadIdx.x == wg::NC) {
      wg::produce<F6>(ring, pk.w[0]);
      wg::produce<F7>(ring, pk.w[1]);
      wg::produce<F9>(ring, pk.w[2]);
      wg::produce<F10>(ring, pk.w[3]);
    } else if (threadIdx.x == wg::NC + 1) {
      produce_boxes<C / BC, XBOX>(&tmx, land, lbar, C0 - 8, R0 - 2,
                                  blockIdx.z);
    }
    return;
  }

  const long long img = (long long)blockIdx.z * H;
  const Org o12 = {R0 - 2, oc - 2, H, W};
  const Org o10 = {R0 - 1, oc - 1, H, W};
  const Org o8 = {R0, oc, H, W};

  wg::Lap lap;
  consume_boxes<C / BC, XBOX, R12, L12, 6, XBL, PC>(land, lbar, X, C0 - 8, W,
                                                    lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  // a over 12 x 20
  wg::conv<F6, PC>(ring, X, RowsConv<1, 1>{L12, L12},
                   EpiActTC{A, L12, g.b6, o12}, lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  if (SAVE) put_tile_signs<M>(A, L12, 2, g.am + img * M * wl, R0, C0, H, wl);
  lap(wg::P_MASK);
  // post7, then y8, over 10 x 18
  wg::conv<F7, PM>(ring, A, RowsConv<3, 1>{L10, L12},
                   EpiPost7TC<SAVE>{P, X, g.b7, o10, sg}, lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  if (SAVE) put_signs<C>(sg, g.p7m + img * C * wl, R0, C0, H, wl);
  lap(wg::P_MASK);
  // c over 10 x 18 into the x region (x is dead once y8 exists)
  wg::conv<F9, PC>(ring, P, RowsConv<1, 1>{L10, L10},
                   EpiActTC{X, L10, g.b9, o10}, lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  if (SAVE) put_tile_signs<M>(X, L10, 1, g.cm + img * M * wl, R0, C0, H, wl);
  lap(wg::P_MASK);
  // post10 and y11 = post10 + y8 over the own 8 x 16 into A's stage
  wg::conv<F10, PM>(ring, X, RowsConv<3, 1>{TL, L10},
                    EpiY11TC<SAVE>{A, P, g.b10, o8, sg}, lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  put_tile<C>(A, g.y11 + img * C * wl, R0, C0, H, wl);
  zero_right(g.y11 + img * C * wl, C, R0, C0, H, wl);
  lap(wg::P_STORE);
  if (SAVE) {
    put_signs<C>(sg, g.p10m + img * C * wl, R0, C0, H, wl);
    zero_right(g.am + img * M * wl, M, R0, C0, H, wl);
    zero_right(g.p7m + img * C * wl, C, R0, C0, H, wl);
    zero_right(g.cm + img * M * wl, M, R0, C0, H, wl);
    zero_right(g.p10m + img * C * wl, C, R0, C0, H, wl);
    lap(wg::P_MASK);
  }
}

// K6b (K6c with W12) in bfloat16: the block's 8 x 16 lanes of g5; the
// producer warp streams (K6c: conv12^T's four parities, then) W10^T, W9^T,
// W7^T and W6^T's packed chunks once each
template <bool W12>
__global__ void __launch_bounds__(wg::NTH, 1)
    res152_bwd_wg_kernel(const __grid_constant__ CUtensorMap tmg,
                         BwdArgs<bf16> g, tc::Packed pk, int H, int W,
                         int wl, int wl12) {
  using namespace tc;
  using U00 = U12<0, 0>;
  using U01 = U12<0, 1>;
  using U10 = U12<1, 0>;
  using U11 = U12<1, 1>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* A = reinterpret_cast<bf16*>(smem_raw);  // g11, gp10; gp7; g5's stage
  bf16* B = A + N12C;                           // gp9, then gp6
  bf16* G8 = B + N10M;                          // g11's inner 10 x 18, g8
  bf16* GP12 = B;                               // K6c: gp12, over B and G8
  unsigned char* mc = reinterpret_cast<unsigned char*>(G8 + N10C);
  unsigned char* mp7 = mc + MC;
  unsigned char* ma = mp7 + MP7;
  auto ring = wg::make_ring<BWD_STAGES, SLOT>(
      wg::smem_u32(smem_raw + BWD_BYTES));
  // the boxes land over gp10 (gp12's) or over gp9 and g8 (g11's)
  const uint32_t land = wg::smem_u32(W12 ? A : B);
  const uint32_t lbar = ring.empty + 8 * BWD_STAGES;
  init_landing(lbar);
  __syncthreads();
  const int R0 = blockIdx.y * TR, C0 = blockIdx.x * TL, oc = C0 - 1;
  if (threadIdx.x >= wg::NC) {
    // the producer warp: lane 0 the weights, lane 1 the tile's boxes
    if (threadIdx.x == wg::NC + 1) {
      if constexpr (W12)
        produce_boxes<2 * C / BC, GBOX>(&tmg, land, lbar, C0 / 2 - 8,
                                        R0 / 2 - 1, blockIdx.z);
      else
        produce_boxes<C / BC, XBOX>(&tmg, land, lbar, C0 - 8, R0 - 2,
                                    blockIdx.z);
    }
    if (threadIdx.x == wg::NC) {
      if constexpr (W12) {
        const unsigned char* u = pk.w[4];
        wg::produce<U00>(ring, u);
        wg::produce<U01>(ring, u + U00::BYTES);
        wg::produce<U10>(ring, u + U00::BYTES + U01::BYTES);
        wg::produce<U11>(ring, u + U00::BYTES + U01::BYTES + U10::BYTES);
      }
      wg::produce<B10>(ring, pk.w[3]);
      wg::produce<B9h>(ring, pk.w[2]);
      wg::produce<B9h>(ring, pk.w[2] + B9h::BYTES);
      wg::produce<B7>(ring, pk.w[1]);
      wg::produce<B6>(ring, pk.w[0]);
    }
    return;
  }

  const long long img = (long long)blockIdx.z * H;
  const Org o12 = {R0 - 2, oc - 2, H, W};
  const Org o10 = {R0 - 1, oc - 1, H, W};
  const Org o8 = {R0, oc, H, W};

  // the gates of c and post7 over 10 x 18, of a over the own 8 x 16
  wg::Lap lap;
  stage_mask<R10, L10, 7, M>(mc, g.cm + img * M * wl, R0 - 1, oc - 1, H, wl);
  stage_mask<R10, L10, 7, C>(mp7, g.p7m + img * C * wl, R0 - 1, oc - 1, H,
                             wl);
  stage_mask<TR, TL, 0, M>(ma, g.am + img * M * wl, R0, oc, H, wl);
  lap(wg::P_MASK);
  if constexpr (W12) {
    // the gp12 tile from (R0/2 - 1, C0/2 - 2); super position (a, b) of
    // parity (py, px) reads it from column b + (px ? 0 : 1), and its output
    // (2a + py, 2b + px) is tile position (2a + py, 2b + px + (px ? -1 : 1))
    consume_boxes<2 * C / BC, GBOX, NSR + 1, GW, 7, GBL, P12>(
        land, lbar, GP12, C0 / 2 - 8, W / 2, lap);
    wg::sync_consumers();
    lap(wg::P_SYNC);
    wg::conv<U00, P12>(ring, GP12 + P12, RowsT2<0, 0>{NSC, GW},
                       EpiG11TC{A, o12, 1}, lap);
    wg::conv<U01, P12>(ring, GP12, RowsT2<0, 1>{NSC, GW},
                       EpiG11TC{A, o12, -1}, lap);
    wg::conv<U10, P12>(ring, GP12 + P12, RowsT2<1, 0>{NSC, GW},
                       EpiG11TC{A, o12, 1}, lap);
    wg::conv<U11, P12>(ring, GP12, RowsT2<1, 1>{NSC, GW},
                       EpiG11TC{A, o12, -1}, lap);
  } else {
    consume_boxes<C / BC, XBOX, R12, L12, 6, XBL, PC>(land, lbar, A, C0 - 8,
                                                      W, lap);
  }
  wg::sync_consumers();
  lap(wg::P_SYNC);
  gate_g11(A, G8, g.p10m + img * C * wl, R0 - 2, oc - 2, H, wl);
  lap(wg::P_MASK);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  // gp9 over 10 x 18
  wg::conv<B10, PC>(ring, A, RowsConv<3, 1>{L10, L12},
                    EpiGateTC{B, L10, o10, mc}, lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  // g8 (in place of g11) and gp7 (into A) over 10 x 18, a half of the
  // channels at a time
  {
    const EpiG8TC epi{G8, A, o10, mp7};
    wg::conv<B9h, PM>(ring, B, RowsConv<1, 1>{L10, L10},
                      From<EpiG8TC>{epi, 0}, lap);
    wg::conv<B9h, PM>(ring, B, RowsConv<1, 1>{L10, L10},
                      From<EpiG8TC>{epi, M}, lap);
  }
  wg::sync_consumers();
  lap(wg::P_SYNC);
  // gp6 over the own 8 x 16
  wg::conv<B7, PC>(ring, A, RowsConv<3, 1>{TL, L10},
                   EpiGateTC{B, TL, o8, ma}, lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  // g5 = T(W6^T gp6 + g8) into A's stage
  wg::conv<B6, PM>(ring, B, RowsConv<1, 1>{TL, TL}, EpiG5TC{A, G8, o8}, lap);
  wg::sync_consumers();
  lap(wg::P_SYNC);
  put_tile<C>(A, g.g5 + img * C * wl, R0, C0, H, wl);
  zero_right(g.g5 + img * C * wl, C, R0, C0, H, wl);
  lap(wg::P_STORE);
}

// float32: 8 x 8 column tiles on the FMA kernels
template <bool SAVE>
int launch_fwd(const FwdArgs<float>& a, int B, int H, int W, int wl,
               cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)Smem<float>::FWD;
  cudaError_t e = cudaFuncSetAttribute(
      res152_fwd_kernel<float, SAVE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + TS - 1) / TS, (H + TS - 1) / TS, B);
  res152_fwd_kernel<float, SAVE><<<grid, NT, smem, s>>>(a, H, W, wl);
  return (int)cudaGetLastError();
}

template <bool W12>
int launch_bwd(const BwdArgs<float>& a, int B, int H, int W, int wl,
               int wl12, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)Smem<float>::BWD;
  cudaError_t e = cudaFuncSetAttribute(
      res152_bwd_kernel<float, W12>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + TS - 1) / TS, (H + TS - 1) / TS, B);
  res152_bwd_kernel<float, W12><<<grid, NT, smem, s>>>(a, H, W, wl, wl12);
  return (int)cudaGetLastError();
}

// bfloat16: 8 x 16-lane tiles over lanes 0 .. W (column -1 .. W - 1)
inline dim3 tc_grid(int B, int H, int W) {
  return dim3((W + 1 + tc::TL - 1) / tc::TL, (H + tc::TR - 1) / tc::TR, B);
}

template <bool SAVE>
int launch_fwd_wg(const FwdArgs<bf16>& a, const tc::Packed& pk, int B, int H,
                  int W, int wl, cudaStream_t s) {
  constexpr int smem = tc::fwd_smem<SAVE>();
  cudaError_t e = cudaFuncSetAttribute(
      res152_fwd_wg_kernel<SAVE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tm;
  const int err = wg::planar_map(&tm, a.x, true, B, H, C, wl, tc::XBL,
                                 tc::R12, tc::BC);
  if (err != 0) return err;
  res152_fwd_wg_kernel<SAVE><<<tc_grid(B, H, W), wg::NTH, smem, s>>>(
      tm, a, pk, H, W, wl);
  return (int)cudaGetLastError();
}

template <bool W12>
int launch_bwd_wg(const BwdArgs<bf16>& a, const tc::Packed& pk, int B, int H,
                  int W, int wl, int wl12, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      res152_bwd_wg_kernel<W12>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, tc::BWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tm;
  const int err =
      W12 ? wg::planar_map(&tm, a.gp12, true, B, H / 2, 2 * C, wl12,
                           tc::GBL, tc::NSR + 1, tc::BC)
          : wg::planar_map(&tm, a.g11, true, B, H, C, wl, tc::XBL, tc::R12,
                           tc::BC);
  if (err != 0) return err;
  res152_bwd_wg_kernel<W12><<<tc_grid(B, H, W), wg::NTH, tc::BWD_SMEM, s>>>(
      tm, a, pk, H, W, wl, wl12);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_any(const void* x, const void* const* w, const void* const* bias,
            const void* const* fr, void* y11, void* const* m, int B, int H,
            int W, int wl, cudaStream_t s) {
  const FwdArgs<T> a = {
      static_cast<const T*>(x),        static_cast<const T*>(w[0]),
      static_cast<const T*>(w[1]),     static_cast<const T*>(w[2]),
      static_cast<const T*>(w[3]),     static_cast<const float*>(bias[0]),
      static_cast<const float*>(bias[1]), static_cast<const float*>(bias[2]),
      static_cast<const float*>(bias[3]), static_cast<T*>(y11),
      static_cast<int8_t*>(m[0]),      static_cast<int8_t*>(m[1]),
      static_cast<int8_t*>(m[2]),      static_cast<int8_t*>(m[3])};
  const bool save = m[0] != nullptr;
  if constexpr (sizeof(T) == 2) {
    tc::Packed pk = {};
    for (int i = 0; i < 4; ++i)
      pk.w[i] = static_cast<const unsigned char*>(fr[i]);
    return save ? launch_fwd_wg<true>(a, pk, B, H, W, wl, s)
                : launch_fwd_wg<false>(a, pk, B, H, W, wl, s);
  } else {
    return save ? launch_fwd<true>(a, B, H, W, wl, s)
                : launch_fwd<false>(a, B, H, W, wl, s);
  }
}

template <typename T>
int bwd_any(const void* g11, const void* gp12, const void* w12t,
            const void* const* m, const void* const* wt,
            const void* const* fr, void* g5, int B, int H, int W, int wl,
            int wl12, cudaStream_t s) {
  const BwdArgs<T> a = {
      static_cast<const T*>(g11),       static_cast<const T*>(gp12),
      static_cast<const T*>(w12t),      static_cast<const int8_t*>(m[0]),
      static_cast<const int8_t*>(m[1]), static_cast<const int8_t*>(m[2]),
      static_cast<const int8_t*>(m[3]), static_cast<const T*>(wt[0]),
      static_cast<const T*>(wt[1]),     static_cast<const T*>(wt[2]),
      static_cast<const T*>(wt[3]),     static_cast<T*>(g5)};
  const bool w12 = gp12 != nullptr;
  if constexpr (sizeof(T) == 2) {
    tc::Packed pk;
    for (int i = 0; i < 5; ++i)
      pk.w[i] = static_cast<const unsigned char*>(fr[i]);
    return w12 ? launch_bwd_wg<true>(a, pk, B, H, W, wl, wl12, s)
               : launch_bwd_wg<false>(a, pk, B, H, W, wl, wl12, s);
  } else {
    return w12 ? launch_bwd<true>(a, B, H, W, wl, wl12, s)
               : launch_bwd<false>(a, B, H, W, wl, wl12, s);
  }
}

}  // namespace

// K6a. dtype: 0 = float32, 1 = bfloat16 (x, weights, y11); biases float32.
// Weights HWIO, contiguous: w6 and w9 [1][1][128][64], w7 and w10
// [3][3][64][128]; f6 .. f10 the same packed for wgmma (bfloat16:
// ops/res_fused.py stage_packed; null in float32). am, p7m, cm, p10m: the int8 masks [B, H,
// 64 | 128 | 64 | 128, wl], all null for the forward alone (which then runs
// the kernel instantiated without mask code). Returns cudaGetLastError().
extern "C" int apfp_res152_fused(const void* x, const void* w6,
                                 const void* w7, const void* w9,
                                 const void* w10, const void* b6,
                                 const void* b7, const void* b9,
                                 const void* b10, const void* f6,
                                 const void* f7, const void* f9,
                                 const void* f10, void* y11, void* am,
                                 void* p7m, void* cm, void* p10m, int dtype,
                                 int B, int H, int W, int wl, void* stream) {
  const void* w[4] = {w6, w7, w9, w10};
  const void* bias[4] = {b6, b7, b9, b10};
  const void* fr[4] = {f6, f7, f9, f10};
  void* m[4] = {am, p7m, cm, p10m};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return fwd_any<bf16>(x, w, bias, fr, y11, m, B, H, W, wl, s);
  return fwd_any<float>(x, w, bias, fr, y11, m, B, H, W, wl, s);
}

// K6b. g11 and g5 planar [B, H, 128, wl] in the compute dtype; the masks
// of K6a; the flipped, channel-swapped weights, contiguous HWIO:
// w6t and w9t [1][1][64][128], w7t and w10t [3][3][128][64]; f6t .. f10t
// the same packed for wgmma (bfloat16; null in float32).
extern "C" int apfp_res152_fused_grad(const void* g11, const void* am,
                                      const void* p7m, const void* cm,
                                      const void* p10m, const void* w6t,
                                      const void* w7t, const void* w9t,
                                      const void* w10t, const void* f6t,
                                      const void* f7t, const void* f9t,
                                      const void* f10t, void* g5, int dtype,
                                      int B, int H, int W, int wl,
                                      void* stream) {
  const void* m[4] = {am, p7m, cm, p10m};
  const void* wt[4] = {w6t, w7t, w9t, w10t};
  const void* fr[5] = {f6t, f7t, f9t, f10t, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return bwd_any<bf16>(g11, nullptr, nullptr, m, wt, fr, g5, B, H, W, wl,
                         0, s);
  return bwd_any<float>(g11, nullptr, nullptr, m, wt, fr, g5, B, H, W, wl, 0,
                        s);
}

// K6c. gp12 the pre-gated conv12 cotangent, planar [B, H/2, 256, wl12]
// (H and W even); w12t conv12's HWIO weight with its channel axes swapped,
// contiguous [3][3][256][128], f12t the same packed for wgmma by output
// parity (bfloat16: ops/res_fused.py conv12_packed; null in float32); the
// rest as K6b's. g5 [B, H, 128, wl].
extern "C" int apfp_res152_fused_grad12(
    const void* gp12, const void* am, const void* p7m, const void* cm,
    const void* p10m, const void* w12t, const void* w6t, const void* w7t,
    const void* w9t, const void* w10t, const void* f12t, const void* f6t,
    const void* f7t, const void* f9t, const void* f10t, void* g5, int dtype,
    int B, int H, int W, int wl, int wl12, void* stream) {
  const void* m[4] = {am, p7m, cm, p10m};
  const void* wt[4] = {w6t, w7t, w9t, w10t};
  const void* fr[5] = {f6t, f7t, f9t, f10t, f12t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return bwd_any<bf16>(nullptr, gp12, w12t, m, wt, fr, g5, B, H, W, wl,
                         wl12, s);
  return bwd_any<float>(nullptr, gp12, w12t, m, wt, fr, g5, B, H, W, wl, wl12,
                        s);
}

// The kernel instantiation of (dtype, save) as the card sees it: info[0]
// registers a thread, info[1] the dynamic shared memory bytes of a launch,
// info[2] the blocks one multiprocessor holds. Returns the CUDA error.
extern "C" int apfp_res152_fused_info(int dtype, int save, int* info) {
  if (dtype == 1)
    return save ? info_of(res152_fwd_wg_kernel<true>, tc::fwd_smem<true>(),
                          info, wg::NTH)
                : info_of(res152_fwd_wg_kernel<false>, tc::fwd_smem<false>(),
                          info, wg::NTH);
  const size_t smem = sizeof(float) * (size_t)Smem<float>::FWD;
  return save ? info_of(res152_fwd_kernel<float, true>, smem, info)
              : info_of(res152_fwd_kernel<float, false>, smem, info);
}

// The same for K6b (w12 = 0) and K6c (w12 = 1)
extern "C" int apfp_res152_fused_grad_info(int dtype, int w12, int* info) {
  if (dtype == 1)
    return w12 ? info_of(res152_bwd_wg_kernel<true>, tc::BWD_SMEM, info,
                         wg::NTH)
               : info_of(res152_bwd_wg_kernel<false>, tc::BWD_SMEM, info,
                         wg::NTH);
  const size_t smem = sizeof(float) * (size_t)Smem<float>::BWD;
  return w12 ? info_of(res152_bwd_kernel<float, true>, smem, info)
             : info_of(res152_bwd_kernel<float, false>, smem, info);
}
