// Generic planar conv (K4): one conv layer on planar activations, and its
// stride-2 adjoint on the unexpanded cotangent (the k3t2 variant).
//
// Replaces the JAX package's Pallas kernel ops/planar_conv.py planar_conv
// (bodies _k3_kernel for 3x3 stride 1 or 2 and _k1_kernel for 1x1). It
// computes, for output row r, column c and channel co,
//   y = sum_{ky, kx, ci} x[S r + ky - P][ci][S c + kx - P] w[ky][kx][ci][co]
//   y = y + bias[co]                        (float32)
//   y = max(y, slope y)                     (if has_slope)
//   y = T(y)                                (stride 2 only: the Pallas
//                                            kernel rounds before its
//                                            even-index decimation)
//   y = y + res[r][co][c]                   (if res: the darknet shortcut,
//                                            after the activation)
//   y = gate > 0 ? y : gate_slope y         (if gate: the fused leaky
//                                            backward mask, applied last)
//   out = T(y)
// with float32 accumulation, P = (k - 1) / 2, x zero outside the image.
// Planar tensors are [B, H, C, Wl], column c at lane c + 1; every border
// and padding lane of the output is written as zero (the tiles cover every
// lane of the output rows), so the output needs no memset.
//
// The k3t2 variant is the JAX package's stride-2 adjoint
// planar_conv(expand2_planar(g), flip_t(w), 0, k=3, slope=None, gate) (its
// ops/planar_conv.py:202 zero interleave, then the :533 kernel) without the
// interleave: the expanded input e holds g[a][b] at (2a, 2b) and zeros
// elsewhere, so output (2a + py, 2b + px) of the stride-1 conv with the
// flipped kernel wt meets data only at the taps of its parity: dy = 1 at
// row a for py = 0, dy = 0 at row a and dy = 2 at row a + 1 for py = 1
// (columns alike). The four output parities take 1, 2, 2 and 4 taps, 9 tap
// products per 4 outputs where the expanded form takes 36; tap (dy, dx)
// belongs to parity (dy != 1, dx != 1).
//
// What bounds it on the H100: bytes at the stem's widths (the 3x3 convs
// at 608^2 and 304^2 read and write ~0.3-0.6 GB at b24 for 4-16 GFLOP),
// operations at the 152^2 stage's 3x3 convs (64 x 128 channels).
//
// bfloat16 runs on Hopper's units (stem_common.cuh: wg), an implicit GEMM
// D[position][cout] = sum over taps and cin of A[position][cin]
// B[cin][cout] per block of 288 threads: two consumer warpgroups and a
// producer warp. A block owns a tile of TR output rows x the 32 lanes
// [32 x, 32 x + 32) of those rows (TR = 4, a warpgroup two rows; 8, two
// 64-row blocks a warpgroup, where N <= 32 at 1x1 and at 3x3 s1 with
// chunks up to 32 channels; the adjoint 8, whose four parities hold 64
// super positions each, warpgroup 0 computing parities (0, 0) and (1, 1),
// warpgroup 1 (0, 1) and (1, 0)) and the N output channels of its
// channel block (N = 8-64, the wgmma width; the adjoint 8-32). A thread
// then keeps at most 32 accumulators, and two blocks fit a multiprocessor
// (96 registers a thread; a block of 128 channels ran one an SM and lost
// more than its input's second read from L2 costs); the channel blocks of
// a tile are neighbours in the grid.
//  - Input: the producer's lane 0 loads each channel chunk (KC = 16 NS
//    channels, NS 16-deep steps: 1 at stride 2 or for a depth up to 16, 2
//    up to 32, else 4) as one TMA box of the planar input (IH rows x KC
//    channels x BL lanes, rows, lanes and channels outside the tensor
//    arriving as zeros) into a landing buffer under a full / empty
//    mbarrier pair. The consumers transpose it into the staged tile
//    [position][KC] (ldmatrix.trans then stmatrix, 8 x 8 at a time: what
//    is left of the transposition, a shared-memory pass of 2 bytes read
//    and written an element), zeroing the columns outside the image, and
//    free the landing buffer: the next chunk's box is in flight under this
//    chunk's MMAs (two more landing buffers at stride 2 and in the adjoint
//    measured no faster). There every tap is a row offset for ldmatrix (a
//    stride-2 conv reads every second position), as in wg::conv. The 1x1
//    conv needs no transposition: its A comes by ldmatrix.trans from the
//    landing buffers (two, so both chunks of a 128-channel input load at
//    once).
//  - Weights: packed on the host (ops/planar_conv.py: k4_weights) per
//    channel chunk as wg_weights' 64-deep K-major chunks with the 128-byte
//    swizzle, taps in row-major order; the producer's lane 1 streams them
//    into a ring of N x 128-byte slots by bulk copies (full: landed;
//    empty: every consumer warp's wgmmas on it completed).
//  - MMAs: per 64-deep weight chunk each warpgroup issues its (up to) four
//    wgmma.m64nNk16 steps, A from registers (ldmatrix from the staged tile,
//    the next chunk's fragments loaded under this chunk's wgmmas where a
//    step feeds one 64-row block), one commit group, waits for it and
//    frees the slot. The sum runs over channel chunks, then taps, then
//    16-deep steps from a
//    zero float32 accumulator: at stride 1 with 64-channel chunks the
//    order of the mma.sync kernel it replaced (a wgmma k16 step rounds as
//    an mma.sync one), so bf16 K6a still equals the planar stage route bit
//    for bit. Stride 2 takes 16-channel chunks.
//  - Epilogue: 8-32 channels at a time, the accumulators + bias, leaky and
//    the stride-2 rounding are staged float32 channel-major in shared
//    memory (the landing buffers and staged tile; the block's biases staged
//    once), the piece's res and gate loads in flight meanwhile; then a thread takes 8 lanes (16 bytes) of
//    a line, adds res, applies the gate, rounds once and writes whole
//    aligned 64-byte runs, zero outside [0, Wo). A tile entirely past the
//    image only writes zeros.
//  - One tile a block, two or more blocks a multiprocessor: a persistent
//    form (blocks walking tiles, the next tile's box loading under this
//    one's MMAs and epilogue) measured slower at every variant.
// Every wait is an asm loop and every arrival predicated: ptxas serializes
// wgmmas around a branch of the program's own inside their pipeline.
//
// float32 keeps the CUDA-core FMA kernels (TF32 tensor cores would not
// hold the float32 goldens): planar_conv_kernel below, and for the adjoint
// planar_convt2_f32_kernel over the same parities. Their design: each
// block owns an 8 x 32 tile of output positions for CB = 8, 16 or 32
// output channels and walks the input channels in chunks of 16 staged in
// shared memory; each thread accumulates CB/8 positions x 8 channels.
//
// res, gate and has_slope are runtime flags, uniform over the launch and
// read only in the epilogue, so one template per geometry, dtype and
// channel block serves every combination.

#include "stem_common.cuh"

namespace {

using namespace stem;

constexpr int TR = 8;   // output rows per tile
constexpr int TC = 32;  // output columns per tile
constexpr int KC = 16;  // input channels per shared-memory chunk

struct EpiArgs {
  const void* res;
  const void* gate;
  int has_slope;
  float slope;
  float gate_slope;
};

template <int KS, int S>
struct ConvGeom {
  static constexpr int IH = (TR - 1) * S + KS;  // input tile rows
  static constexpr int IW = (TC - 1) * S + KS;  // input tile columns
  static constexpr int XS = (KC * IH * IW + 7) / 8 * 8;
};

// Zero the border and padding lanes of the output rows [r0, r0 + nrows) and
// channels [cob, cob + nco) of one image (ob its first element): lane 0 for
// the first tile column, lanes Wo + 1 .. wl_out - 1 for the last
template <typename T>
__device__ void zero_lanes(T* __restrict__ out, long long ob, int r0,
                           int nrows, int cob, int nco, int cout, int Ho,
                           int Wo, int wl_out, bool first, bool last) {
  if (!first && !last) return;
  const int nr = last ? wl_out - Wo - 1 : 0;
  const int n = nr + (first ? 1 : 0);
  for (int idx = threadIdx.x; idx < nrows * nco * n; idx += blockDim.x) {
    const int k = idx % n;
    const int rest = idx / n;
    const int co = cob + rest % nco, r = r0 + rest / nco;
    const int lane = k < nr ? Wo + 1 + k : 0;
    if (r < Ho && co < cout)
      out[ob + ((long long)r * cout + co) * wl_out + lane] = from_f<T>(0.f);
  }
}

template <typename T, int KS, int S, int NCG>
__global__ void __launch_bounds__(NT)
    planar_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ bias, EpiArgs ea,
                       T* __restrict__ out, int H, int cin, int wl_in,
                       int w_img, int cout, int cout_pad, int Ho, int Wo,
                       int wl_out) {
  using G = ConvGeom<KS, S>;
  constexpr int CB = NCG * CT;      // output channels of this block
  constexpr int NPG = NT / NCG;     // position groups (>= 64: cg is
                                    // uniform over a warp)
  constexpr int PT = TR * TC / NPG; // positions per thread
  constexpr int PAD = (KS - 1) / 2;
  static_assert(PT * NPG == TR * TC && NPG % 32 == 0, "thread mapping");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // [KC][IH][IW]
  T* ws = xs + G::XS;                      // [KS*KS][KC][CB]

  const int n_cb = cout_pad / CB;
  const int cb = blockIdx.z % n_cb;
  const int b = blockIdx.z / n_cb;
  const int r0 = blockIdx.y * TR, c0 = blockIdx.x * TC;
  const int cg = threadIdx.x / NPG;
  const int pg = threadIdx.x % NPG;
  const int cob = cb * CB;  // first output channel of the block
  const int ir0 = r0 * S - PAD, ic0 = c0 * S - PAD;  // input tile origin
  const T* xb = x + (long long)b * H * cin * wl_in;

  float acc[PT][CT];
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[i][c] = 0.f;

  for (int ch0 = 0; ch0 < cin; ch0 += KC) {
    const int kc = min(KC, cin - ch0);
    __syncthreads();  // the previous chunk has been read
    for (int idx = threadIdx.x; idx < KC * G::IH * G::IW; idx += NT) {
      const int j = idx % G::IW;
      const int rest = idx / G::IW;
      const int i = rest % G::IH, ci = rest / G::IH;
      const int gr = ir0 + i, gc = ic0 + j;
      T v = from_f<T>(0.f);
      if (ci < kc && gr >= 0 && gr < H && gc >= 0 && gc < w_img)
        v = xb[((long long)gr * cin + ch0 + ci) * wl_in + gc + 1];
      xs[idx] = v;
    }
    for (int idx = threadIdx.x; idx < KS * KS * KC * CB; idx += NT) {
      const int co = idx % CB;
      const int rest = idx / CB;
      const int ci = rest % KC, tap = rest / KC;
      T v = from_f<T>(0.f);
      if (ci < kc)
        v = w[((long long)tap * cin + ch0 + ci) * cout_pad + cob + co];
      ws[idx] = v;
    }
    __syncthreads();
    for (int ci = 0; ci < kc; ++ci) {
      const T* xc = xs + ci * G::IH * G::IW;
#pragma unroll
      for (int ky = 0; ky < KS; ++ky) {
#pragma unroll
        for (int kx = 0; kx < KS; ++kx) {
          float wv[CT];
          load8s(ws + ((ky * KS + kx) * KC + ci) * CB + cg * CT, wv);
#pragma unroll
          for (int i = 0; i < PT; ++i) {
            const int p = pg + i * NPG;
            const int oy = p / TC, ox = p % TC;
            const float a = to_f(xc[(oy * S + ky) * G::IW + ox * S + kx]);
#pragma unroll
            for (int c = 0; c < CT; ++c) acc[i][c] = fmaf(a, wv[c], acc[i][c]);
          }
        }
      }
    }
  }

  // epilogue: a warp stores 32 neighbouring lanes of one channel
  const T* res = static_cast<const T*>(ea.res);
  const T* gate = static_cast<const T*>(ea.gate);
  const long long ob = (long long)b * Ho * cout * wl_out;
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int p = pg + i * NPG;
    const int r = r0 + p / TC, c = c0 + p % TC;
    if (r >= Ho || c >= Wo) continue;
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) {
      const int co = cob + cg * CT + cc;
      if (co >= cout) break;
      float y = acc[i][cc] + bias[co];
      if (ea.has_slope) y = fmaxf(y, y * ea.slope);
      if (S == 2) y = round_t<T>(y);
      const long long o = ob + ((long long)r * cout + co) * wl_out + c + 1;
      if (res != nullptr) y += to_f(res[o]);
      if (gate != nullptr) y = to_f(gate[o]) > 0.f ? y : y * ea.gate_slope;
      out[o] = from_f<T>(y);
    }
  }
  zero_lanes(out, ob, r0, TR, cob, CB, cout, Ho, Wo, wl_out,
             blockIdx.x == 0, blockIdx.x == gridDim.x - 1);
}

template <typename T, int KS, int S, int NCG>
int launch(const void* x, const void* w, const float* bias, EpiArgs ea,
           void* out, int B, int H, int cin, int wl_in, int w_img, int cout,
           int cout_pad, cudaStream_t s) {
  using G = ConvGeom<KS, S>;
  constexpr int CB = NCG * CT;
  const size_t smem = sizeof(T) * ((size_t)G::XS + KS * KS * KC * CB);
  cudaError_t e = cudaFuncSetAttribute(
      planar_conv_kernel<T, KS, S, NCG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int Ho = H / S, Wo = w_img / S;
  const int wl_out = (Wo + 2 + 127) / 128 * 128;
  dim3 grid((Wo + TC - 1) / TC, (Ho + TR - 1) / TR, B * (cout_pad / CB));
  planar_conv_kernel<T, KS, S, NCG><<<grid, NT, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, ea,
      static_cast<T*>(out), H, cin, wl_in, w_img, cout, cout_pad, Ho, Wo,
      wl_out);
  return (int)cudaGetLastError();
}

// the channel block: 32 output channels where cout_pad allows it, else 16
// or 8 (cout_pad is a multiple of 8)
template <typename T, int KS, int S>
int launch_cb(const void* x, const void* w, const float* bias, EpiArgs ea,
              void* out, int B, int H, int cin, int wl_in, int w_img,
              int cout, int cout_pad, cudaStream_t s) {
  if (cout_pad % 32 == 0)
    return launch<T, KS, S, 4>(x, w, bias, ea, out, B, H, cin, wl_in, w_img,
                               cout, cout_pad, s);
  if (cout_pad % 16 == 0)
    return launch<T, KS, S, 2>(x, w, bias, ea, out, B, H, cin, wl_in, w_img,
                               cout, cout_pad, s);
  return launch<T, KS, S, 1>(x, w, bias, ea, out, B, H, cin, wl_in, w_img,
                             cout, cout_pad, s);
}


// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs
// ---------------------------------------------------------------------------

int launch_f32(const void* x, const void* w, const float* bias, EpiArgs ea,
               void* out, int B, int H, int cin, int wl_in, int w_img,
               int cout, int cout_pad, int k, int stride, cudaStream_t s) {
  if (k == 1)
    return launch_cb<float, 1, 1>(x, w, bias, ea, out, B, H, cin, wl_in,
                                  w_img, cout, cout_pad, s);
  if (stride == 2)
    return launch_cb<float, 3, 2>(x, w, bias, ea, out, B, H, cin, wl_in,
                                  w_img, cout, cout_pad, s);
  return launch_cb<float, 3, 1>(x, w, bias, ea, out, B, H, cin, wl_in, w_img,
                                cout, cout_pad, s);
}

// The adjoint variant in float32: one thread per super position (a, b) and
// 8 output channels (blockIdx.z runs over batch and 8-channel blocks), its
// four outputs (2a + py, 2b + px) from g at (a, b), (a, b + 1), (a + 1, b)
// and (a + 1, b + 1); a block covers 8 x 32 super positions. w is the
// flipped kernel, HWIO [3][3][cin][cout_pad] float32.
__global__ void __launch_bounds__(NT)
    planar_convt2_f32_kernel(const float* __restrict__ g,
                             const float* __restrict__ w,
                             const float* __restrict__ bias, EpiArgs ea,
                             float* __restrict__ out, int Hg, int cin,
                             int wl_in, int w_g, int cout, int cout_pad,
                             int wl_out) {
  const int n_cb = cout_pad / 8;
  const int cb = blockIdx.z % n_cb, b = blockIdx.z / n_cb;
  const int sa = blockIdx.y * 8 + (threadIdx.x >> 5);
  const int sb = blockIdx.x * 32 + (threadIdx.x & 31);
  const int Ho = 2 * Hg, Wo = 2 * w_g;
  const int cob = cb * 8;
  const long long ob = (long long)b * Ho * cout * wl_out;
  if (sa < Hg && sb < w_g) {
    const float* gb = g + (long long)b * Hg * cin * wl_in;
    const bool right = sb + 1 < w_g, down = sa + 1 < Hg;
    const long long TS = (long long)cin * cout_pad;  // one tap's weights
    float acc[4][CT];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[q][c] = 0.f;
    for (int ci = 0; ci < cin; ++ci) {
      const float* r0p = gb + ((long long)sa * cin + ci) * wl_in + sb + 1;
      const float v00 = r0p[0], v01 = right ? r0p[1] : 0.f;
      const float* r1p = r0p + (long long)cin * wl_in;
      const float v10 = down ? r1p[0] : 0.f;
      const float v11 = down && right ? r1p[1] : 0.f;
      const float* wc = w + (long long)ci * cout_pad + cob;
      float wv[CT];
      // (even, even): tap (1, 1) at (a, b)
      load8(wc + 4 * TS, wv);
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[0][c] = fmaf(v00, wv[c], acc[0][c]);
      // (even, odd): (1, 0) at (a, b), (1, 2) at (a, b + 1)
      load8(wc + 3 * TS, wv);
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[1][c] = fmaf(v00, wv[c], acc[1][c]);
      load8(wc + 5 * TS, wv);
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[1][c] = fmaf(v01, wv[c], acc[1][c]);
      // (odd, even): (0, 1) at (a, b), (2, 1) at (a + 1, b)
      load8(wc + 1 * TS, wv);
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[2][c] = fmaf(v00, wv[c], acc[2][c]);
      load8(wc + 7 * TS, wv);
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[2][c] = fmaf(v10, wv[c], acc[2][c]);
      // (odd, odd): (0, 0), (0, 2), (2, 0), (2, 2)
      load8(wc + 0 * TS, wv);
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[3][c] = fmaf(v00, wv[c], acc[3][c]);
      load8(wc + 2 * TS, wv);
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[3][c] = fmaf(v01, wv[c], acc[3][c]);
      load8(wc + 6 * TS, wv);
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[3][c] = fmaf(v10, wv[c], acc[3][c]);
      load8(wc + 8 * TS, wv);
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[3][c] = fmaf(v11, wv[c], acc[3][c]);
    }
    const float* gate = static_cast<const float*>(ea.gate);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 2 * sa + (q >> 1), c = 2 * sb + (q & 1);
#pragma unroll
      for (int cc = 0; cc < CT; ++cc) {
        const int co = cob + cc;
        if (co >= cout) break;
        float y = acc[q][cc] + bias[co];
        const long long o = ob + ((long long)r * cout + co) * wl_out + c + 1;
        if (gate != nullptr) y = gate[o] > 0.f ? y : y * ea.gate_slope;
        out[o] = y;
      }
    }
  }
  zero_lanes(out, ob, blockIdx.y * 16, 16, cob, 8, cout, Ho, Wo, wl_out,
             blockIdx.x == 0, blockIdx.x == gridDim.x - 1);
}


// ---------------------------------------------------------------------------
// bfloat16: Hopper's units (wgmma, TMA, bulk copies)
// ---------------------------------------------------------------------------

namespace wgk {

using wg::NC;
using wg::NTH;
constexpr int TC = 32;  // output lanes a tile

// the variants (apfp_planar_conv_info's numbering)
enum { V1X1 = 0, V3S1 = 1, V3S2 = 2, VT2 = 3 };

// A variant's tile and stages at NS 16-deep steps a channel chunk and MT
// 64-row blocks a warpgroup
template <int V, int NS, int MT>
struct Geo {
  static constexpr int KC = 16 * NS;                 // channels a chunk
  static constexpr int S = V == V3S2 ? 2 : 1;
  static constexpr int TR = V == VT2 ? 8 : 4 * MT;   // output rows a tile
  static constexpr int M = TR * TC;                  // outputs a tile
  static constexpr int NI = V == VT2 ? 2 : MT;       // accumulator sets
  static constexpr int T = V == V1X1 ? 1 : 9;        // taps
  static constexpr int WPC = (T * NS + 3) / 4;  // weight chunks a chunk
  // the box: IH rows x KC channels x BL lanes (an odd multiple of 8, so
  // the eight channel rows a transposing ldmatrix reads fall in distinct
  // bank groups), from lane 8 below the tile's first input lane (1x1: at
  // it), row P below its first input row (adjoint: super row r0 / 2)
  static constexpr int IH = V == V1X1 ? TR : V == V3S1 ? TR + 2
                                      : V == V3S2 ? 2 * TR + 1 : 5;
  static constexpr int BL = V == V1X1 ? 40 : V == V3S1 ? 56 : V == V3S2 ? 72
                                                                      : 40;
  static constexpr int LB = V == V1X1 ? 2 : 1;  // landing buffers
  static constexpr int LAND = IH * KC * BL * 2;
  // the staged tile: IH rows x PL box lanes, a position PB bytes (64
  // channels: 128, its 16-byte units XOR-swizzled by the position's low
  // bits; else padded by 16 bytes); a tap is a position offset: output
  // (oy, ox) of a forward conv reads (S oy + ky, S ox + kx + OFF)
  static constexpr int PL = V == V1X1 ? 0 : V == V3S1 ? 48 : V == V3S2 ? 72
                                                                      : 32;
  static constexpr int PB = KC == 64 ? 128 : 2 * KC + 16;
  static constexpr int POS = IH * PL * PB;
  static constexpr int OFF = V == V3S1 ? 7 : 6;
  static_assert(LAND % 128 == 0, "box alignment");
};

// the weight ring: a 64-deep chunk of N channels a slot
template <int N>
struct RingOf {
  static constexpr int SLOT = N * 128;
  static constexpr int ST = N == 64 ? 4 : 6;
};

// the channels an epilogue piece stages: the most of 32, 16 and 8 (at
// most N) whose float32 stage [PC][M + 4] fits the landing buffers and
// staged tile, and whose lines (32 lanes of a row and channel) a consumer
// thread's quarter takes two at most
__host__ __device__ constexpr int piece(int n, int m, int room) {
  return n >= 32 && m <= 128 && 32 * (m + 4) * 4 <= room ? 32
         : n >= 16 && m <= 256 && 16 * (m + 4) * 4 <= room ? 16
                                                            : 8;
}

// 64-row blocks a warpgroup: two (tiles of 8 rows, halving the weights and
// the box rows streamed an output) where N <= 32 keeps them in 32
// accumulators and the stages in two blocks' shared memory
template <int V, int NS, int N>
__host__ __device__ constexpr int mt_of() {
  return (V == V1X1 || (V == V3S1 && NS <= 2)) && N <= 32 ? 2 : 1;
}

// shared memory from a 1024-aligned base: the ring, the landing buffers,
// the staged tile, the barriers, the block's N biases; the epilogue's
// stage [PC][OP] float32 reuses the landing buffers and staged tile
template <int V, int NS, int N>
struct Lay {
  using G = Geo<V, NS, mt_of<V, NS, N>()>;
  using R = RingOf<N>;
  static constexpr int PC = piece(N, G::M, G::LB * G::LAND + G::POS);
  static constexpr int OP = G::M + 4;  // the stage's pitch (floats)
  static constexpr int LAND_AT = R::ST * R::SLOT;
  static constexpr int POS_AT = LAND_AT + G::LB * G::LAND;
  static constexpr int BAR_AT = POS_AT + G::POS;
  static constexpr int NBAR = 2 * R::ST + 2 * G::LB;
  static constexpr int BIAS_AT = BAR_AT + 8 * NBAR;
  static constexpr int SMEM = 1024 + BIAS_AT + 4 * N;
  static_assert(PC * OP * 4 <= G::LB * G::LAND + G::POS, "epilogue stage");
  static_assert(SMEM <= 232448, "shared memory");
};

// the launches this kernel takes: at most 64 channels a block (the
// adjoint, with two accumulator sets, 32), so a thread keeps at most 32
// accumulators and two blocks fit a multiprocessor's registers (96 a
// thread); stride 2 walks 16-channel chunks
template <int V, int NS, int N>
__host__ __device__ constexpr bool valid() {
  return N <= (V == VT2 ? 32 : 64) && (V == V3S2 ? NS == 1 : true);
}

// The block's channel width (the wgmma N) and 16-deep steps a chunk for a
// variant, the GEMM depth K (cin rounded up to 16) and cout
// (ops/planar_conv.py: k4_plan)
inline void plan(int variant, int K, int cout, int* n, int* ns) {
  const int cap = variant == VT2 ? 32 : 64;
  *n = 8;
  while (*n < cout && *n < cap) *n *= 2;
  *ns = variant == V3S2 || K <= 16 ? 1 : K <= 32 ? 2 : 4;
}

struct Args {
  const unsigned char* w;  // packed weights [n_cb][nck WPC][N][64]
  const float* bias;       // [cout]
  EpiArgs ea;
  bf16* out;
  int w_in, Ho, Wo, wl_out, cout, n_cb, nck;
};

// the first lane (a multiple of 8) and row of the box of the tile at
// output lane l0 and row r0
template <int V>
__device__ __forceinline__ int box_lane(int l0) {
  return V == V1X1 ? l0 : V == V3S1 ? l0 - 8 : V == V3S2 ? 2 * l0 - 8
                                                         : l0 / 2 - 8;
}
template <int V>
__device__ __forceinline__ int box_row(int r0) {
  return V == V1X1 ? r0 : V == V3S1 ? r0 - 1 : V == V3S2 ? 2 * r0 - 1
                                                         : r0 / 2;
}

// ldmatrix / stmatrix on shared addresses
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm2t(uint32_t (&r)[2], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}
__device__ __forceinline__ void stsm2(uint32_t a, const uint32_t (&r)[2]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x2.shared.b16 [%0], {%1, %2};\n" ::"r"(a),
      "r"(r[0]), "r"(r[1])
      : "memory");
}

// byte offset of 16-byte unit u of staged position p
template <class G>
__device__ __forceinline__ uint32_t pos_off(int p, int u) {
  return G::KC == 64 ? p * 128 + ((u ^ (p & 7)) << 4) : p * G::PB + (u << 4);
}

// The landing buffer (IH rows x KC channels x BL lanes) -> the staged tile
// [IH x PL][KC], 8 lanes x 8 channels a matrix (ldmatrix.trans, stmatrix);
// positions whose image column (box lane lx + i is column lx + i - 1) lies
// outside [0, w_in) are zero
template <class G>
__device__ __forceinline__ void transpose(uint32_t land, uint32_t pos, int lx,
                                          int w_in) {
  constexpr int NV = G::PL / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = lane & 7;
  const int col = lx + (lane >> 2) - 1;  // + 8 v: this thread's column
  if constexpr (G::KC >= 32) {
    constexpr int UQ = G::KC / 32;  // four 8-channel units an instruction
    const int mi = lane >> 3;
    for (int i = warp; i < G::IH * NV * UQ; i += NC / 32) {
      const int uq = i % UQ, rest = i / UQ;
      const int v = rest % NV, iy = rest / NV;
      uint32_t x[4];
      ldsm4t(x, land + ((iy * G::KC + 8 * (4 * uq + mi) + r) * G::BL +
                        8 * v) * 2);
      const bool in = col + 8 * v >= 0 && col + 8 * v < w_in;
#pragma unroll
      for (int k = 0; k < 4; ++k) x[k] = in ? x[k] : 0u;
      stsm4(pos + pos_off<G>(iy * G::PL + 8 * v + r, 4 * uq + mi), x);
    }
  } else {
    const int mi = (lane >> 3) & 1;
    for (int i = warp; i < G::IH * NV; i += NC / 32) {
      const int v = i % NV, iy = i / NV;
      uint32_t x[2];
      ldsm2t(x, land + ((iy * G::KC + 8 * mi + r) * G::BL + 8 * v) * 2);
      const bool in = col + 8 * v >= 0 && col + 8 * v < w_in;
      x[0] = in ? x[0] : 0u;
      x[1] = in ? x[1] : 0u;
      stsm2(pos + pos_off<G>(iy * G::PL + 8 * v + r, mi), x);
    }
  }
}

// The adjoint's output parities (py, px) = (q >> 1, q & 1): tap (dy, dx)
// belongs to q = 2 (dy != 1) + (dx != 1), reading g at (a + [dy == 2],
// b + [dx == 2]); warpgroup 0 computes parities 0 and 3 (1 + 4 taps),
// warpgroup 1 parities 1 and 2 (2 + 2), its accumulator set i parity
// par(wgi, i) (set q >> 1 of the parity's warpgroup)
__host__ __device__ constexpr int par(int wgi, int i) {
  return wgi == 0 ? 3 * i : 1 + i;
}

// The A side of a consumer thread: its rows' staged positions (1x1:
// landing offsets) at tap 0 for each accumulator set (a forward conv's
// set i is the warpgroup's 64-row block i: output rows 2 (MT wgi + i) and
// the next), and step g of a chunk (tap g / NS, channels 16 (g % NS) ...):
// whether its warpgroup computes it (the adjoint's: warpgroup WGI's
// parities), into which sets, and its A fragments
template <class G, int V, int WGI>
struct ARows {
  static constexpr int NS = G::KC / 16;
  static constexpr int NA = V == VT2 ? 1 : G::NI;  // sets a step feeds
  int p0[G::NI];
  __device__ ARows() {
    const int t = threadIdx.x, lane = t & 31, w4 = (t >> 5) & 3;
    const int wgi = t >> 7;
#pragma unroll
    for (int i = 0; i < G::NI; ++i) {
      const int oy = 2 * (G::NI * wgi + i) + (w4 >> 1);
      if constexpr (V == V1X1) {
        // ldmatrix.trans from [row][channel][lane]: matrix lane >> 3 is
        // channels 8 (lane >> 4) + (lane & 7) at lanes 8 ((lane >> 3) & 1)
        // of the warp's 16 positions
        p0[i] = (oy * G::KC + (lane & 7) + 8 * (lane >> 4)) * G::BL +
                16 * (w4 & 1) + 8 * ((lane >> 3) & 1);
      } else if constexpr (V == VT2) {
        // super position (w4, lane & 15) of the set's parity, staged at
        // lane j + 9 - px
        p0[i] = w4 * G::PL + (lane & 15) + 9 - (par(WGI, i) & 1);
      } else {
        const int ox = 16 * (w4 & 1) + (lane & 15);
        p0[i] = G::S * oy * G::PL + G::S * ox + G::OFF;
      }
    }
  }
  __host__ __device__ static constexpr int tap(int g) { return g / NS; }
  __host__ __device__ static constexpr int parity(int g) {
    return 2 * (tap(g) / 3 != 1) + (tap(g) % 3 != 1);
  }
  __host__ __device__ static constexpr bool mine(int g) {
    return g < G::T * NS &&
           (V != VT2 || (parity(g) == 0 || parity(g) == 3) == (WGI == 0));
  }
  // the accumulator set of step g's k-th A fragment
  __host__ __device__ static constexpr int set(int g, int k) {
    return V == VT2 ? parity(g) >> 1 : k;
  }
  __host__ __device__ static constexpr int delta(int g) {
    return V == VT2 ? (tap(g) / 3 == 2) * G::PL + (tap(g) % 3 == 2)
                    : (tap(g) / 3) * G::PL + tap(g) % 3;
  }
  __device__ __forceinline__ void load(uint32_t (&a)[NA][4], uint32_t src,
                                       int g) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < NA; ++k) {
      if constexpr (V == V1X1)
        ldsm4t(a[k], src + (p0[k] + 16 * (g % NS) * G::BL) * 2);
      else
        ldsm4(a[k], src + pos_off<G>(p0[set(g, k)] + delta(g),
                                     2 * (g % NS) + (lane >> 4)));
    }
  }
};

// Channel chunk c's products into acc: its WPC weight chunks in turn, each
// waited for, the warpgroup's steps of it issued as one wgmma group on the
// slot's descriptor, completed, and the slot freed (by every consumer
// warp, whether its warpgroup used it or not); the next weight chunk's A
// fragments loaded under this one's wgmmas (one set of registers where a
// step feeds two blocks)
template <class G, int V, int N, int WGI>
__device__ __forceinline__ void chunk_mma(float (&acc)[G::NI][N / 2],
                                          uint32_t src, uint32_t ring,
                                          uint32_t wfull, uint32_t wempty,
                                          int c, wg::Lap& lap) {
  using R = RingOf<N>;
  using A = ARows<G, V, WGI>;
  constexpr int DB = A::NA == 1 ? 2 : 1;
  const A rows;
  uint32_t a[DB][4][A::NA][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (A::mine(j)) rows.load(a[0][j], src, j);
#pragma unroll
  for (int w = 0; w < G::WPC; ++w) {
    const int gw = c * G::WPC + w;
    const int sl = gw % R::ST;
    lap(wg::P_MMA);
    wg::mbar_wait(wfull + 8 * sl, (gw / R::ST) & 1);
    lap(wg::P_WAIT);
    const uint64_t desc = wg::desc_sw128(ring + sl * R::SLOT);
    wg::fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (A::mine(4 * w + j))
#pragma unroll
        for (int k = 0; k < A::NA; ++k)
          wg::mma_async<N>(acc[A::set(4 * w + j, k)], a[w % DB][j][k],
                           desc + 2 * j);
    wg::commit();
    if (DB == 2 && w + 1 < G::WPC)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (A::mine(4 * (w + 1) + j))
          rows.load(a[(w + 1) % DB][j], src, 4 * (w + 1) + j);
    wg::wait<0>();
    wg::arrive(wempty + 8 * sl);
    if (DB == 1 && w + 1 < G::WPC)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (A::mine(4 * (w + 1) + j))
          rows.load(a[0][j], src, 4 * (w + 1) + j);
  }
  lap(wg::P_MMA);
}

// 8 bfloat16 <-> float
__device__ __forceinline__ void unpack8(uint4 u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// The output offset of lanes [l, l + 8) of row r, channel co of image b
__device__ __forceinline__ long long out_at(const Args& a, int b, int r,
                                            int co, int l) {
  return ((long long)(b * a.Ho + r) * a.cout + co) * a.wl_out + l;
}

// A tile entirely past the image: its TR rows x N channels of the lanes
// [l0, l0 + 32) written as zeros, 16 bytes a thread, by the whole block
template <int TR, int N>
__device__ void zero_tile(const Args& a, int b, int r0, int l0, int cob) {
  const int nco = min(N, a.cout - cob);
  for (int i = threadIdx.x; i < TR * nco * 4; i += NTH) {
    const int line = i >> 2, oy = line / nco, cl = line - oy * nco;
    if (r0 + oy < a.Ho)
      *reinterpret_cast<uint4*>(
          a.out + out_at(a, b, r0 + oy, cob + cl, l0 + 8 * (i & 3))) =
          make_uint4(0, 0, 0, 0);
  }
}

// The epilogue, PC channels at a time: the piece's res and gate vectors
// loaded first (in flight under the staging), + bias (the block's, staged
// in shared memory, zero past cout), leaky and the
// stride-2 rounding into the stage os [PC][OP] (tile position oy * 32 +
// ox), then the planar write-back: a thread takes 8 lanes (16 bytes) of a
// line (a row and a channel), + res, the gate, one rounding at the store,
// zero at columns outside [0, Wo)
template <class G, int V, int N, int PC, int OP>
__device__ __forceinline__ void epilogue(const float (&acc)[G::NI][N / 2],
                                         float* __restrict__ os,
                                         const float* __restrict__ bias,
                                         const Args& a, int b, int r0, int l0,
                                         int cob, wg::Lap& lap) {
  constexpr int U = (G::TR * PC + NC / 4 - 1) / (NC / 4);  // lines a thread
  const int t = threadIdx.x, lane = t & 31, w4 = (t >> 5) & 3, wgi = t >> 7;
  const int g8 = lane >> 2, q4 = lane & 3;
  const bf16* res = static_cast<const bf16*>(a.ea.res);
  const bf16* gate = static_cast<const bf16*>(a.ea.gate);
  const int q = t & 3;
  const int c0 = l0 + 8 * q - 1;  // the image column of this thread's lane 0
  const bool any = c0 + 7 >= 0 && c0 < a.Wo;
  const bool all = c0 >= 0 && c0 + 7 < a.Wo;
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += PC) {
    long long o[U];
    uint4 rv[U], gv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int line = (t >> 2) + u * (NC / 4);
      const int oy = line / PC, cl = line - oy * PC;
      const int r = r0 + oy, co = cob + n0 + cl;
      o[u] = line < G::TR * PC && r < a.Ho && co < a.cout
                 ? out_at(a, b, r, co, l0 + 8 * q)
                 : -1;
      if (o[u] >= 0 && any && res != nullptr)
        rv[u] = __ldg(reinterpret_cast<const uint4*>(res + o[u]));
      if (o[u] >= 0 && any && gate != nullptr)
        gv[u] = __ldg(reinterpret_cast<const uint4*>(gate + o[u]));
    }
#pragma unroll
    for (int s = 0; s < G::NI; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int pos;  // the tile position of row 16 w4 + g8 + 8 h of set s
        if constexpr (V == VT2) {
          const int q = par(wgi, s), j = g8 + 8 * h;
          pos = (2 * w4 + (q >> 1)) * TC + 2 * j + 1 - (q & 1);
        } else {
          pos = 64 * (G::NI * wgi + s) + 16 * w4 + g8 + 8 * h;
        }
#pragma unroll
        for (int jj = 0; jj < PC / 8; ++jj)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int n = n0 + 8 * jj + 2 * q4 + cc;
            float y = acc[s][4 * (n0 / 8 + jj) + 2 * h + cc] + bias[n];
            if (a.ea.has_slope) y = fmaxf(y, y * a.ea.slope);
            if (G::S == 2) y = round_t<bf16>(y);
            os[(n - n0) * OP + pos] = y;
          }
      }
    lap(wg::P_EPI);
    wg::sync_consumers();
    lap(wg::P_SYNC);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (o[u] < 0) continue;
      const int line = (t >> 2) + u * (NC / 4);
      const int oy = line / PC, cl = line - oy * PC;
      float y[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (any) {
        const float4* sp =
            reinterpret_cast<const float4*>(os + cl * OP + oy * TC + 8 * q);
        const float4 f0 = sp[0], f1 = sp[1];
        y[0] = f0.x; y[1] = f0.y; y[2] = f0.z; y[3] = f0.w;
        y[4] = f1.x; y[5] = f1.y; y[6] = f1.z; y[7] = f1.w;
        float rf[8], gf[8];
        if (res != nullptr) unpack8(rv[u], rf);
        if (gate != nullptr) unpack8(gv[u], gf);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float v = y[k];
          if (res != nullptr) v += rf[k];
          if (gate != nullptr) v = gf[k] > 0.f ? v : v * a.ea.gate_slope;
          if (!all && (c0 + k < 0 || c0 + k >= a.Wo)) v = 0.f;
          y[k] = v;
        }
      }
      *reinterpret_cast<uint4*>(a.out + o[u]) = pack8(y);
    }
    lap(wg::P_STORE);
    wg::sync_consumers();
    lap(wg::P_SYNC);
  }
}

// One tile of variant V: TR output rows from r0 (blockIdx.y), the lanes
// [l0, l0 + 32) and the N output channels from cob (blockIdx.x: lane tile
// and channel block, the channel blocks of a tile neighbours, so they
// share its input in L2) of image blockIdx.z
template <int V, int NS, int N>
__global__ void __launch_bounds__(NTH, 2)
    planar_conv_wg_kernel(const __grid_constant__ CUtensorMap tmx,
                          const Args a) {
  using L = Lay<V, NS, N>;
  using G = typename L::G;
  using R = RingOf<N>;
  static_assert(valid<V, NS, N>(), "instantiation");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t s0 = wg::smem_u32(sm);
  const uint32_t wfull = s0 + L::BAR_AT, wempty = wfull + 8 * R::ST;
  const uint32_t lfull = wempty + 8 * R::ST, lempty = lfull + 8 * G::LB;
  const int cb = blockIdx.x % a.n_cb, b = blockIdx.z;
  const int l0 = blockIdx.x / a.n_cb * TC, r0 = blockIdx.y * G::TR;
  const int cob = cb * N;
  if (l0 > a.Wo) {  // every column of the tile is past the image
    zero_tile<G::TR, N>(a, b, r0, l0, cob);
    return;
  }
  const int lx = box_lane<V>(l0), ly = box_row<V>(r0);
  float* bs = reinterpret_cast<float*>(sm + L::BIAS_AT);
  if (threadIdx.x < N)
    bs[threadIdx.x] = cob + threadIdx.x < a.cout ? a.bias[cob + threadIdx.x]
                                                 : 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < R::ST; ++i) {
      wg::mbar_init(wfull + 8 * i, 1);
      wg::mbar_init(wempty + 8 * i, wg::CONSUMER_WARPS);
    }
    for (int i = 0; i < G::LB; ++i) {
      wg::mbar_init(lfull + 8 * i, 1);
      wg::mbar_init(lempty + 8 * i, wg::CONSUMER_WARPS);
    }
    wg::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= NC) {
    // the producer warp: lane 0 the input boxes, lane 1 the weights
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      for (int c = 0; c < a.nck; ++c) {
        const int sl = c % G::LB;
        wg::mbar_wait(lempty + 8 * sl, ((c / G::LB) & 1) ^ 1);
        wg::mbar_expect_tx(lfull + 8 * sl, G::LAND);
        wg::tma_load_4d(s0 + L::LAND_AT + sl * G::LAND, &tmx, lx, c * G::KC,
                        ly, b, lfull + 8 * sl);
      }
    } else if (lane == 1) {
      const unsigned char* wp =
          a.w + (size_t)cb * a.nck * G::WPC * R::SLOT;
      for (int gw = 0; gw < a.nck * G::WPC; ++gw) {
        const int sl = gw % R::ST;
        wg::mbar_wait(wempty + 8 * sl, ((gw / R::ST) & 1) ^ 1);
        wg::mbar_expect_tx(wfull + 8 * sl, R::SLOT);
        wg::bulk_load(s0 + sl * R::SLOT, wp + (size_t)gw * R::SLOT, R::SLOT,
                      wfull + 8 * sl);
      }
    }
    return;
  }

  wg::Lap lap;
  float acc[G::NI][N / 2];
#pragma unroll
  for (int s = 0; s < G::NI; ++s)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[s][e] = 0.f;
  for (int c = 0; c < a.nck; ++c) {
    const int sl = c % G::LB;
    const uint32_t land = s0 + L::LAND_AT + sl * G::LAND;
    wg::mbar_wait(lfull + 8 * sl, (c / G::LB) & 1);
    lap(wg::P_INPUT);
    uint32_t src = land;
    if constexpr (V != V1X1) {
      src = s0 + L::POS_AT;
      transpose<G>(land, src, lx, a.w_in);
      lap(wg::P_LOAD);
      wg::arrive(lempty + 8 * sl);
      wg::sync_consumers();
      lap(wg::P_SYNC);
    }
    // the warpgroups' steps differ only in the adjoint (their parities)
    if (V != VT2 || threadIdx.x < 128)
      chunk_mma<G, V, N, 0>(acc, src, s0, wfull, wempty, c, lap);
    else
      chunk_mma<G, V, N, 1>(acc, src, s0, wfull, wempty, c, lap);
    if constexpr (V == V1X1) wg::arrive(lempty + 8 * sl);
    wg::sync_consumers();  // the staged tile (or landing buffer) is free
    lap(wg::P_SYNC);
  }
  epilogue<G, V, N, L::PC, L::OP>(
      acc, reinterpret_cast<float*>(sm + L::LAND_AT), bs, a, b, r0, l0, cob,
      lap);
}

template <int V, int NS, int N>
int launch(const void* x, const void* w, const float* bias, EpiArgs ea,
           void* out, int B, int H, int cin, int wl_in, int w_in, int cout,
           int n_cb, int K, cudaStream_t s) {
  if constexpr (!valid<V, NS, N>()) {
    return (int)cudaErrorInvalidValue;
  } else {
    using L = Lay<V, NS, N>;
    using G = typename L::G;
    auto kern = planar_conv_wg_kernel<V, NS, N>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return (int)e;
    CUtensorMap tm;
    const int err = wg::planar_map(&tm, x, true, B, H, cin, wl_in, G::BL,
                                   G::IH, G::KC);
    if (err != 0) return err;
    Args a;
    a.w = static_cast<const unsigned char*>(w);
    a.bias = bias;
    a.ea = ea;
    a.out = static_cast<bf16*>(out);
    a.w_in = w_in;
    a.Ho = V == VT2 ? 2 * H : H / G::S;
    a.Wo = V == VT2 ? 2 * w_in : w_in / G::S;
    a.wl_out = (a.Wo + 2 + 127) / 128 * 128;
    a.cout = cout;
    a.n_cb = n_cb;
    a.nck = (K + G::KC - 1) / G::KC;
    dim3 grid(a.wl_out / TC * n_cb, (a.Ho + G::TR - 1) / G::TR, B);
    kern<<<grid, NTH, L::SMEM, s>>>(tm, a);
    return (int)cudaGetLastError();
  }
}

template <int V, int NS>
int launch_n(int n, const void* x, const void* w, const float* bias,
             EpiArgs ea, void* out, int B, int H, int cin, int wl_in,
             int w_in, int cout, int n_cb, int K, cudaStream_t s) {
  switch (n) {
    case 8:
      return launch<V, NS, 8>(x, w, bias, ea, out, B, H, cin, wl_in, w_in,
                              cout, n_cb, K, s);
    case 16:
      return launch<V, NS, 16>(x, w, bias, ea, out, B, H, cin, wl_in, w_in,
                               cout, n_cb, K, s);
    case 32:
      return launch<V, NS, 32>(x, w, bias, ea, out, B, H, cin, wl_in, w_in,
                               cout, n_cb, K, s);
    default:
      return launch<V, NS, 64>(x, w, bias, ea, out, B, H, cin, wl_in, w_in,
                               cout, n_cb, K, s);
  }
}

// A launch of variant v: the plan's channel width and steps a chunk, the
// channel blocks from cout_pad
template <int V>
int launch_v(const void* x, const void* w, const float* bias, EpiArgs ea,
             void* out, int B, int H, int cin, int wl_in, int w_in, int cout,
             int cout_pad, int K, cudaStream_t s) {
  int n, ns;
  plan(V, K, cout, &n, &ns);
  if (K % 16 != 0 || K <= 0 || cout_pad % n != 0)
    return (int)cudaErrorInvalidValue;
  const int n_cb = cout_pad / n;
  if (ns == 1)
    return launch_n<V, 1>(n, x, w, bias, ea, out, B, H, cin, wl_in, w_in,
                          cout, n_cb, K, s);
  if (ns == 2)
    return launch_n<V, 2>(n, x, w, bias, ea, out, B, H, cin, wl_in, w_in,
                          cout, n_cb, K, s);
  return launch_n<V, 4>(n, x, w, bias, ea, out, B, H, cin, wl_in, w_in, cout,
                        n_cb, K, s);
}

template <int V, int NS, int N>
int info_of_wg(int* info) {
  if constexpr (!valid<V, NS, N>())
    return (int)cudaErrorInvalidValue;
  else
    return info_of(planar_conv_wg_kernel<V, NS, N>, Lay<V, NS, N>::SMEM,
                   info, NTH);
}

template <int V, int NS>
int info_n(int n, int* info) {
  switch (n) {
    case 8: return info_of_wg<V, NS, 8>(info);
    case 16: return info_of_wg<V, NS, 16>(info);
    case 32: return info_of_wg<V, NS, 32>(info);
    default: return info_of_wg<V, NS, 64>(info);
  }
}

template <int V>
int info_v(int ns, int n, int* info) {
  if (ns == 1) return info_n<V, 1>(n, info);
  if (ns == 2) return info_n<V, 2>(n, info);
  return info_n<V, 4>(n, info);
}

}  // namespace wgk

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, res, gate, out); bias float32
// [cout] (float32: [cout_pad]). k = 1 (stride 1) or 3 (stride 1 or 2;
// stride 2 needs even H and w_img). res and gate are null or planar
// [B, H/stride, cout, wl_out]. float32: w HWIO [k][k][cin][cout_pad]
// (cout_pad a multiple of 8); bfloat16: w packed for wgmma
// (ops/planar_conv.py: k4_weights) for the plan's channel width n and
// steps a chunk (wgk::plan), [cout_pad / n][chunks][n][64], K the weights'
// cin rounded up to 16 and cout_pad a multiple of n; x 16-byte aligned.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a geometry the
// kernel does not take (bfloat16: a tensor-map error past 999).
extern "C" int apfp_planar_conv(const void* x, const void* w,
                                const void* bias, const void* res,
                                const void* gate, void* out, int dtype, int B,
                                int H, int cin, int wl_in, int w_img,
                                int cout, int cout_pad, int K, int k,
                                int stride, int has_slope, float slope,
                                float gate_slope, void* stream) {
  if (!((k == 1 && stride == 1) || (k == 3 && (stride == 1 || stride == 2)))
      || cout > cout_pad)
    return (int)cudaErrorInvalidValue;
  const EpiArgs ea = {res, gate, has_slope, slope, gate_slope};
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (k == 1)
      return wgk::launch_v<wgk::V1X1>(x, w, bf, ea, out, B, H, cin, wl_in,
                                      w_img, cout, cout_pad, K, s);
    if (stride == 2)
      return wgk::launch_v<wgk::V3S2>(x, w, bf, ea, out, B, H, cin, wl_in,
                                      w_img, cout, cout_pad, K, s);
    return wgk::launch_v<wgk::V3S1>(x, w, bf, ea, out, B, H, cin, wl_in,
                                    w_img, cout, cout_pad, K, s);
  }
  if (cout_pad % 8 != 0) return (int)cudaErrorInvalidValue;
  return launch_f32(x, w, bf, ea, out, B, H, cin, wl_in, w_img, cout,
                    cout_pad, k, stride, s);
}

// The stride-2 adjoint (k3t2): g planar [B, Hg, cin, wl_in] at image width
// w_g -> out planar [B, 2 Hg, cout, wl_out] at width 2 w_g, with the
// flipped kernel w (float32: HWIO [3][3][cin][cout_pad], cout_pad a
// multiple of 8; bfloat16: packed as apfp_planar_conv's), bias, no leaky,
// and gate (null or planar like out) applied last. Returns
// cudaGetLastError(), or cudaErrorInvalidValue.
extern "C" int apfp_planar_conv_t2(const void* g, const void* w,
                                   const void* bias, const void* gate,
                                   void* out, int dtype, int B, int Hg,
                                   int cin, int wl_in, int w_g, int cout,
                                   int cout_pad, int K, float gate_slope,
                                   void* stream) {
  if (cout > cout_pad) return (int)cudaErrorInvalidValue;
  const EpiArgs ea = {nullptr, gate, 0, 0.f, gate_slope};
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return wgk::launch_v<wgk::VT2>(g, w, bf, ea, out, B, Hg, cin, wl_in, w_g,
                                   cout, cout_pad, K, s);
  if (cout_pad % 8 != 0) return (int)cudaErrorInvalidValue;
  const int wl_out = (2 * w_g + 2 + 127) / 128 * 128;
  dim3 grid((w_g + 31) / 32, (Hg + 7) / 8, B * (cout_pad / 8));
  planar_convt2_f32_kernel<<<grid, NT, 0, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(w), bf, ea,
      static_cast<float*>(out), Hg, cin, wl_in, w_g, cout, cout_pad, wl_out);
  return (int)cudaGetLastError();
}

// A bfloat16 instantiation as the card sees it: variant 0 = 1x1, 1 = 3x3
// stride 1, 2 = 3x3 stride 2, 3 = the stride-2 adjoint; ns 16-deep steps a
// channel chunk (1, 2 or 4; stride 2: 1), n output channels a block (8,
// 16, 32 or 64; the adjoint up to 32). info[0] registers a thread,
// info[1] the dynamic shared memory bytes of a launch, info[2] the blocks
// one multiprocessor holds. Returns the CUDA error (cudaErrorInvalidValue
// for an instantiation that does not exist).
extern "C" int apfp_planar_conv_info(int variant, int ns, int n, int* info) {
  switch (variant) {
    case 0: return wgk::info_v<wgk::V1X1>(ns, n, info);
    case 1: return wgk::info_v<wgk::V3S1>(ns, n, info);
    case 2: return wgk::info_v<wgk::V3S2>(ns, n, info);
    default: return wgk::info_v<wgk::VT2>(ns, n, info);
  }
}
