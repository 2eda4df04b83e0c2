// The 152^2 residual stage (YOLOv3 layers 6-11) in one kernel each way:
// K6a forward, K6b saved-mask input backward, and K6c, K6b widened by
// conv12's input cotangent.
//
// Replaces the JAX package's Pallas kernels ops/res_fused.py res152_fused
// (body _fwd_kernel, with and without save), res152_fused_grad (body
// _bwd_kernel, then _stage_chain) and res152_fused_grad12 (body
// _bwd12_kernel, then _stage_chain). With T the rounding to the compute
// dtype, leaky(v) = max(v, 0.1 v) and m(v) = 1 if v > 0 else 0.1, K6a
// computes, in _fwd_kernel's order and at its rounding points,
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
// over the tile's 12^2 in a prologue (conv12_adjoint, per 2x2 super
// position by parity, as K2's stride-2 adjoints), then runs the same chain;
// g11 never touches device memory. Every value at a row or
// column outside the image is zero (conv padding). All convs accumulate
// in float32. Planar tensors are [B, H, C, Wl], column c at lane c + 1;
// each block writes its own 8 x 8 positions of every output, and the
// blocks of the first and last tile columns the border and padding lanes,
// so nothing needs a memset.
//
// What bounds it on the H100: at b24 608^2 bfloat16 the forward moves
// ~0.74 GB with SAVE (x read, y11 and four masks written) against
// 1.82e11 FLOP: bytes and operations are about equal (0.22 and 0.18 ms).
// What this first design does about it: the Pallas kernels' row stripes
// do not fit (a 152-wide stripe of 8 rows is ~470 KB of bfloat16 x alone,
// against 227 KB a block), so each block owns an 8 x 8 tile of positions
// for all 128 channels and works over its receptive field in shared
// memory (forward: x 12^2 -> a 12^2 -> post7/y8 10^2 -> c 10^2 -> y11 8^2;
// backward: gp10 12^2 -> gp9 10^2 -> g8, gp7 10^2 -> gp6 8^2 -> g5), so no
// intermediate touches device memory; the halo recompute costs ~1.34x
// the FLOPs. Tiles are [position][channel] with the channel stride padded
// by one 32-bit word so the threads of a warp, which read different
// positions, hit different banks. The convs are CUDA-core FMAs with
// float32 accumulation, each thread holding a PT-position x 8-channel
// register tile; each tap's weights ([cin][cout], 16 KB in bfloat16) are
// staged in shared memory before use. Masks go to device memory as bytes
// from the epilogues, and K6b reads them as bytes. Tensor cores are later
// work.
//
// Shared memory, bfloat16 / float32: K6a 98,832 / 196,112 bytes, K6b and
// K6c 93,024 / 184,672 bytes (two blocks a multiprocessor in bfloat16):
// K6c's gp12 tile (7^2 x 256) lies over gp9's and g8's regions, dead until
// conv10^T's epilogue, g11 in gp10's (computed in place), its inner 10^2
// kept in g8's. Its prologue adds 9 taps x 256 x 128 multiply-adds at 36
// super positions a block: 2.25x conv12's dgrad (3.41 GFLOP a 608^2
// image) for the 12^2 halo; conv12's weights (590 KB in bfloat16) are
// staged tap by tap, 64 input channels at a time.

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

template <typename T, bool SAVE>
int launch_fwd(const FwdArgs<T>& a, int B, int H, int W, int wl,
               cudaStream_t s) {
  const size_t smem = sizeof(T) * (size_t)Smem<T>::FWD;
  cudaError_t e = cudaFuncSetAttribute(
      res152_fwd_kernel<T, SAVE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + TS - 1) / TS, (H + TS - 1) / TS, B);
  res152_fwd_kernel<T, SAVE><<<grid, NT, smem, s>>>(a, H, W, wl);
  return (int)cudaGetLastError();
}

template <typename T, bool W12>
int launch_bwd(const BwdArgs<T>& a, int B, int H, int W, int wl, int wl12,
               cudaStream_t s) {
  const size_t smem = sizeof(T) * (size_t)Smem<T>::BWD;
  cudaError_t e = cudaFuncSetAttribute(
      res152_bwd_kernel<T, W12>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + TS - 1) / TS, (H + TS - 1) / TS, B);
  res152_bwd_kernel<T, W12><<<grid, NT, smem, s>>>(a, H, W, wl, wl12);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_any(const void* x, const void* const* w, const void* const* bias,
            void* y11, void* const* m, int B, int H, int W, int wl,
            cudaStream_t s) {
  const FwdArgs<T> a = {
      static_cast<const T*>(x),        static_cast<const T*>(w[0]),
      static_cast<const T*>(w[1]),     static_cast<const T*>(w[2]),
      static_cast<const T*>(w[3]),     static_cast<const float*>(bias[0]),
      static_cast<const float*>(bias[1]), static_cast<const float*>(bias[2]),
      static_cast<const float*>(bias[3]), static_cast<T*>(y11),
      static_cast<int8_t*>(m[0]),      static_cast<int8_t*>(m[1]),
      static_cast<int8_t*>(m[2]),      static_cast<int8_t*>(m[3])};
  if (m[0] != nullptr) return launch_fwd<T, true>(a, B, H, W, wl, s);
  return launch_fwd<T, false>(a, B, H, W, wl, s);
}

template <typename T>
int bwd_any(const void* g11, const void* gp12, const void* w12t,
            const void* const* m, const void* const* wt, void* g5, int B,
            int H, int W, int wl, int wl12, cudaStream_t s) {
  const BwdArgs<T> a = {
      static_cast<const T*>(g11),       static_cast<const T*>(gp12),
      static_cast<const T*>(w12t),      static_cast<const int8_t*>(m[0]),
      static_cast<const int8_t*>(m[1]), static_cast<const int8_t*>(m[2]),
      static_cast<const int8_t*>(m[3]), static_cast<const T*>(wt[0]),
      static_cast<const T*>(wt[1]),     static_cast<const T*>(wt[2]),
      static_cast<const T*>(wt[3]),     static_cast<T*>(g5)};
  if (gp12 != nullptr) return launch_bwd<T, true>(a, B, H, W, wl, wl12, s);
  return launch_bwd<T, false>(a, B, H, W, wl, wl12, s);
}

}  // namespace

// K6a. dtype: 0 = float32, 1 = bfloat16 (x, weights, y11); biases float32.
// Weights HWIO, contiguous: w6 and w9 [1][1][128][64], w7 and w10
// [3][3][64][128]. am, p7m, cm, p10m: the int8 masks [B, H, 64 | 128 |
// 64 | 128, wl], all null for the forward alone (which then runs the
// kernel instantiated without mask code). Returns cudaGetLastError().
extern "C" int apfp_res152_fused(const void* x, const void* w6,
                                 const void* w7, const void* w9,
                                 const void* w10, const void* b6,
                                 const void* b7, const void* b9,
                                 const void* b10, void* y11, void* am,
                                 void* p7m, void* cm, void* p10m, int dtype,
                                 int B, int H, int W, int wl, void* stream) {
  const void* w[4] = {w6, w7, w9, w10};
  const void* bias[4] = {b6, b7, b9, b10};
  void* m[4] = {am, p7m, cm, p10m};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return fwd_any<__nv_bfloat16>(x, w, bias, y11, m, B, H, W, wl, s);
  return fwd_any<float>(x, w, bias, y11, m, B, H, W, wl, s);
}

// K6b. g11 and g5 planar [B, H, 128, wl] in the compute dtype; the masks
// of K6a; the flipped, channel-swapped weights, contiguous HWIO:
// w6t and w9t [1][1][64][128], w7t and w10t [3][3][128][64].
extern "C" int apfp_res152_fused_grad(const void* g11, const void* am,
                                      const void* p7m, const void* cm,
                                      const void* p10m, const void* w6t,
                                      const void* w7t, const void* w9t,
                                      const void* w10t, void* g5, int dtype,
                                      int B, int H, int W, int wl,
                                      void* stream) {
  const void* m[4] = {am, p7m, cm, p10m};
  const void* wt[4] = {w6t, w7t, w9t, w10t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return bwd_any<__nv_bfloat16>(g11, nullptr, nullptr, m, wt, g5, B, H, W,
                                  wl, 0, s);
  return bwd_any<float>(g11, nullptr, nullptr, m, wt, g5, B, H, W, wl, 0, s);
}

// K6c. gp12 the pre-gated conv12 cotangent, planar [B, H/2, 256, wl12]
// (H and W even); w12t conv12's HWIO weight with its channel axes swapped,
// contiguous [3][3][256][128]; the rest as K6b's. g5 [B, H, 128, wl].
extern "C" int apfp_res152_fused_grad12(const void* gp12, const void* am,
                                        const void* p7m, const void* cm,
                                        const void* p10m, const void* w12t,
                                        const void* w6t, const void* w7t,
                                        const void* w9t, const void* w10t,
                                        void* g5, int dtype, int B, int H,
                                        int W, int wl, int wl12,
                                        void* stream) {
  const void* m[4] = {am, p7m, cm, p10m};
  const void* wt[4] = {w6t, w7t, w9t, w10t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return bwd_any<__nv_bfloat16>(nullptr, gp12, w12t, m, wt, g5, B, H, W,
                                  wl, wl12, s);
  return bwd_any<float>(nullptr, gp12, w12t, m, wt, g5, B, H, W, wl, wl12, s);
}
