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
// and padding lane of the output is written as zero (the blocks of the
// first tile column write lane 0, those of the last the lanes past the
// image), so the output needs no memset.
//
// The k3t2 variant is the JAX package's stride-2 adjoint
// planar_conv(expand2_planar(g), flip_t(w), 0, k=3, slope=None, gate) (its
// ops/planar_conv.py:202 zero interleave, then the :533 kernel) without the
// interleave: the expanded input e holds g[a][b] at (2a, 2b) and zeros
// elsewhere, so output (2a + py, 2b + px) of the stride-1 conv with the
// flipped kernel wt meets data only at the taps of its parity: dy = 1 at
// row a for py = 0, dy = 0 at row a and dy = 2 at row a + 1 for py = 1
// (columns alike). The four output parities take 1, 2, 2 and 4 taps, 9 tap
// products per 4 outputs where the expanded form takes 36.
//
// What bounds it on the H100: operations at the stem's widths (a 3x3 conv
// does 9 cin multiply-adds per output value against a few bytes of input
// and output), bytes for the 1x1 convs at small cin.
//
// bfloat16 runs on the tensor cores, an implicit GEMM on mma.sync.m16n8k16
// (stem_common.cuh's ldmatrix / mma helpers) with D[position][cout] = sum
// over taps and cin of A[position][cin] B[cin][cout]. Each block owns an
// 8 x 32 tile of output positions (M = 256: each of the 8 warps owns two
// 16-row blocks for all CB = 8 NW output channels of the block, NW = 1, 2,
// 4 or 8 by cout; grid.z runs over batch and channel blocks). The tile is
// 32 lanes of the planar rows, not 32 columns (tc::TC below), and the grid
// covers every lane, so each block writes whole aligned 64-byte runs and
// no border or padding lane needs a pass of its own. cin is zero-padded to
// a multiple of 16 and walked in chunks of KC = 64 (32 at stride 2): the
// chunk's input halo is staged position-major ([pos][KC + 8], 16-byte
// reads along W transposed four channels at a time into 8-byte stores that
// fill whole bank rows), the 16-byte pitch pad putting the eight
// rows of a stride-1 ldmatrix phase in distinct bank groups (two-way at
// stride 2). The accumulators stay in registers across the chunks, which
// is why the warps own fixed rows instead of taking mma_conv's items in
// turn: any cin runs in a fixed shared-memory budget (69.1 KB stride 1,
// 97.9 KB stride 2). The taps are row maps of the staged tile (a stride-2
// conv and the adjoint's parities need no im2col), and the weights come
// in mma.sync's fragment order ([tap][K/16][Npad/8][lane] uint2,
// ops/planar_conv.py: k4_weights, built once per weight tensor), one
// 8-byte __ldg per lane and 8 channels, L1/L2-resident. The epilogue
// stages the block's float32 results channel-major in shared memory
// (+ bias, leaky and the stride-2 rounding there) and writes them back
// planar, a warp a line, adding res and applying gate on the way: the
// rounding points are the plain version's. The adjoint variant runs the
// same tile (4 x 16 super positions a parity, 8 x 32 outputs); warp w < 4
// owns row block w of parities (1, 1) and (0, 0), warp w >= 4 row block
// w - 4 of (0, 1) and (1, 0), 5 and 4 tap products a warp.
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
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

// A block's output tile is TR rows x the TC lanes [TC x, TC x + TC) of its
// rows, i.e. columns TC x - 1 .. TC x + TC - 2 (column c is lane c + 1):
// every block writes whole, aligned 64-byte runs of each output line, and
// the grid covers every lane (borders and padding written as zero; a block
// entirely past the image only writes zeros). A tile that owned columns
// instead would share a 32-byte sector with its neighbour at each end, and
// the card would then merge partial sector writes in device memory.
constexpr int TR = 8, TC = 32;          // output tile
constexpr int M = TR * TC;              // GEMM rows of a block
constexpr int NWARP = NT / 32;
constexpr int MT = M / NWARP / 16;      // 16-row blocks a warp owns
constexpr int OP = M + 4;               // output stage pitch (floats)
static_assert(MT * 16 * NWARP == M, "tile rows");

// the output channels of a block by cout (8 NW; ops/planar_conv.py: _k4_nw)
__host__ __device__ inline int nw_of(int cout) {
  return cout <= 8 ? 1 : cout <= 16 ? 2 : cout <= 32 ? 4 : 8;
}

// The staged input window of a geometry: IH rows x IW lanes (a multiple of
// 8, from the 8-aligned lane L0) x KC channels of pitch PI. A forward conv
// reads, for output (oy, ox) of the tile at lane l0 = TC x and tap (ky,
// kx), input lane S (l0 - 1 + ox) + kx - P + 1, staged position
// (S oy + ky, S ox + kx + OFF) with L0 = S l0 - LB.
template <int KS, int S>
struct Geom {
  static constexpr int LB = KS == 1 ? 0 : 8;
  static constexpr int OFF = LB - S - (KS - 1) / 2 + 1;
  static constexpr int IH = S * (TR - 1) + KS;
  static constexpr int IW = (S * (TC - 1) + KS + OFF + 7) / 8 * 8;
  static constexpr int KC = S == 2 ? 32 : 64;
  static constexpr int PI = KC + 8;
  static constexpr int IN_BYTES = IH * IW * PI * 2;
};
// the adjoint: 4 x 16 super positions a parity, rows a0 .. a0 + 4 and lanes
// from L0 = l0 / 2 - 8. The tile's even columns l0 .. l0 + 30 are super
// columns b = l0 / 2 + j, its odd ones l0 - 1 .. l0 + 29 are b = l0 / 2 - 1
// + j (j < 16), output column 2 b + px at tile position ox = 2 j + 1 - px;
// g's column b is lane b + 1, staged position j + 9 - px
struct GeomT2 {
  static constexpr int SR = TR / 2, SC = TC / 2;
  static constexpr int IH = SR + 1;
  static constexpr int IW = (SC + 10 + 7) / 8 * 8;
  static constexpr int KC = 64;
  static constexpr int PI = KC + 8;
  static constexpr int IN_BYTES = IH * IW * PI * 2;
};

template <int NW>
constexpr int out_bytes() {
  return 8 * NW * OP * 4;
}

// Stage channels [ch0, ch0 + 4 NQ) of IH input rows from image row ir0 and
// IW lanes from lane L0 into xs [pos][PI], zero for rows, columns and
// channels outside the input. Four channels x 8 lanes an item: four
// 16-byte loads along W, eight 8-byte stores (channel quads fastest, so a
// warp's stores fill whole bank rows); the column test runs only for the
// vectors at the image's edges. A thread loads U items before it stores
// any, so U x 4 loads are in flight at once.
template <int IH, int IW, int PI, int NQ>
__device__ __forceinline__ void stage_q(bf16* __restrict__ xs,
                                        const bf16* __restrict__ xb, int ir0,
                                        int H, int cin, int wl_in, int L0,
                                        int w_img, int ch0) {
  constexpr int NV = IW / 8;
  constexpr int TOTAL = IH * NV * NQ;
  constexpr int U = 2;
  static_assert(PI % 4 == 0, "8-byte stores");
  for (int i0 = threadIdx.x; i0 < TOTAL; i0 += U * NT) {
    uint4 e[U][4];
    int dst[U], lv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = i0 + u * NT;
      dst[u] = -1;
#pragma unroll
      for (int t = 0; t < 4; ++t) e[u][t] = make_uint4(0, 0, 0, 0);
      if (idx < TOTAL) {
        const int p = idx % NQ;
        const int rest = idx / NQ;
        const int v = rest % NV, iy = rest / NV;
        const int gr = ir0 + iy, ci = ch0 + 4 * p, l = L0 + 8 * v;
        dst[u] = (iy * IW + 8 * v) * PI + 4 * p;
        lv[u] = l;
        // lanes l .. l + 7 hold columns l - 1 .. l + 6
        if (gr >= 0 && gr < H && l + 7 >= 1 && l <= w_img) {
          const bf16* src = xb + ((long long)gr * cin + ci) * wl_in + l;
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (ci + t < cin)
              e[u][t] = __ldg(reinterpret_cast<const uint4*>(
                  src + (long long)t * wl_in));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (dst[u] < 0) continue;
      const bf16* e0 = reinterpret_cast<const bf16*>(&e[u][0]);
      const bf16* e1 = reinterpret_cast<const bf16*>(&e[u][1]);
      const bf16* e2 = reinterpret_cast<const bf16*>(&e[u][2]);
      const bf16* e3 = reinterpret_cast<const bf16*>(&e[u][3]);
      const bool edge = lv[u] < 1 || lv[u] + 7 > w_img;
      bf16* d = xs + dst[u];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        __nv_bfloat162 lo, hi;
        lo.x = e0[j];
        lo.y = e1[j];
        hi.x = e2[j];
        hi.y = e3[j];
        uint2 w;
        w.x = *reinterpret_cast<const uint32_t*>(&lo);
        w.y = *reinterpret_cast<const uint32_t*>(&hi);
        const int col = lv[u] + j - 1;
        if (edge && (col < 0 || col >= w_img)) w = make_uint2(0, 0);
        *reinterpret_cast<uint2*>(d + j * PI) = w;
      }
    }
  }
}

// stage_q for a chunk of nch channels (a multiple of 16, at most KC)
template <int IH, int IW, int PI, int KC>
__device__ __forceinline__ void stage(bf16* __restrict__ xs,
                                      const bf16* __restrict__ xb, int ir0,
                                      int H, int cin, int wl_in, int L0,
                                      int w_img, int ch0, int nch) {
  static_assert(KC == 32 || KC == 64, "chunk widths");
  if (nch == 16) {
    stage_q<IH, IW, PI, 4>(xs, xb, ir0, H, cin, wl_in, L0, w_img, ch0);
  } else if constexpr (KC == 32) {
    stage_q<IH, IW, PI, 8>(xs, xb, ir0, H, cin, wl_in, L0, w_img, ch0);
  } else if (nch == 32) {
    stage_q<IH, IW, PI, 8>(xs, xb, ir0, H, cin, wl_in, L0, w_img, ch0);
  } else if (nch == 48) {
    stage_q<IH, IW, PI, 12>(xs, xb, ir0, H, cin, wl_in, L0, w_img, ch0);
  } else {
    stage_q<IH, IW, PI, 16>(xs, xb, ir0, H, cin, wl_in, L0, w_img, ch0);
  }
}

// One tap's products of a warp's row blocks: B from the fragment-ordered
// weights wt (this tap, the chunk's first 16-deep step, the block's first
// 8-channel block), A by ldmatrix from a[t] (the tap's staged rows)
template <int MTI, int NW, int KSMAX>
__device__ __forceinline__ void tap_mma(float (&acc)[MTI][NW][4],
                                        const bf16* const (&a)[MTI],
                                        const uint2* __restrict__ wt,
                                        int nt8, int nks) {
#pragma unroll
  for (int s = 0; s < KSMAX; ++s) {
    if (s < nks) {
      uint2 bfr[NW];
#pragma unroll
      for (int j = 0; j < NW; ++j) bfr[j] = __ldg(wt + (s * nt8 + j) * 32);
      uint32_t af[MTI][4];
#pragma unroll
      for (int t = 0; t < MTI; ++t) ldsm_x4(af[t], a[t] + s * 16);
#pragma unroll
      for (int t = 0; t < MTI; ++t)
#pragma unroll
        for (int j = 0; j < NW; ++j) mma_bf16(acc[t][j], af[t], bfr[j]);
    }
  }
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

// The planar write-back of a block's staged results os [CB][OP] (float32,
// bias and leaky applied; position oy * TC + ox, ox the lane's offset in
// the tile): + res, the gate, one rounding at the store; zero at columns
// outside [0, Wo) (with os null, everywhere: a block past the image). A
// thread takes 8 lanes (16 bytes: one load of res, of gate and of the
// output each) of a line (a row and a real channel of the block), four
// threads a line; two lines a thread at a time, their loads issued before
// their stores.
template <int CB>
__device__ __forceinline__ void write_tile(const float* __restrict__ os,
                                           EpiArgs ea, bf16* __restrict__ out,
                                           int b, int r0, int l0, int cob,
                                           int cout, int Ho, int Wo,
                                           int wl_out) {
  static_assert(TC == 32 && OP % 4 == 0, "a line is four 8-lane quarters");
  constexpr int U = 2, LPP = NT / 4;  // lines a pass
  const bf16* res = static_cast<const bf16*>(ea.res);
  const bf16* gate = static_cast<const bf16*>(ea.gate);
  const long long ob = (long long)b * Ho * cout * wl_out;
  const int nco = min(CB, cout - cob);
  const int q = threadIdx.x & 3;
  const int c0 = l0 + 8 * q - 1;  // the image column of this thread's lane 0
  const bool any = os != nullptr && c0 + 7 >= 0 && c0 < Wo;
  const bool all = os != nullptr && c0 >= 0 && c0 + 7 < Wo;
  const int nlines = TR * nco;
  for (int i0 = threadIdx.x >> 2; i0 < nlines; i0 += U * LPP) {
    float y[U][8];
    uint4 rv[U], gv[U];
    long long o[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int line = i0 + u * LPP;
      const int oy = line / nco, cl = line - oy * nco;
      const int r = r0 + oy;
      o[u] = -1;
#pragma unroll
      for (int j = 0; j < 8; ++j) y[u][j] = 0.f;
      if (line < nlines && r < Ho) {
        o[u] = ob + ((long long)r * cout + cob + cl) * wl_out + l0 + 8 * q;
        if (any) {
          const float4* sp =
              reinterpret_cast<const float4*>(os + cl * OP + oy * TC + 8 * q);
          const float4 f0 = sp[0], f1 = sp[1];
          y[u][0] = f0.x; y[u][1] = f0.y; y[u][2] = f0.z; y[u][3] = f0.w;
          y[u][4] = f1.x; y[u][5] = f1.y; y[u][6] = f1.z; y[u][7] = f1.w;
          if (res != nullptr)
            rv[u] = __ldg(reinterpret_cast<const uint4*>(res + o[u]));
          if (gate != nullptr)
            gv[u] = __ldg(reinterpret_cast<const uint4*>(gate + o[u]));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (o[u] < 0) continue;
      if (any) {
        float rf[8], gf[8];
        if (res != nullptr) unpack8(rv[u], rf);
        if (gate != nullptr) unpack8(gv[u], gf);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v = y[u][j];
          if (res != nullptr) v += rf[j];
          if (gate != nullptr) v = gf[j] > 0.f ? v : v * ea.gate_slope;
          if (!all && (c0 + j < 0 || c0 + j >= Wo)) v = 0.f;
          y[u][j] = v;
        }
      }
      *reinterpret_cast<uint4*>(out + o[u]) = pack8(y[u]);
    }
  }
}

// A forward conv (KS x KS, stride S) on the tensor cores. wf: the weights
// in fragment order with K (cin rounded up to 16) deep steps and
// n_cb * 8 NW output channels; bias float32 [cout].
template <int KS, int S, int NW>
__global__ void __launch_bounds__(NT)
    planar_conv_tc_kernel(const bf16* __restrict__ x,
                          const uint2* __restrict__ wf,
                          const float* __restrict__ bias, EpiArgs ea,
                          bf16* __restrict__ out, int H, int cin, int K,
                          int wl_in, int w_img, int cout, int n_cb, int Ho,
                          int Wo, int wl_out) {
  using G = Geom<KS, S>;
  constexpr int CB = 8 * NW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);   // [IH * IW][PI]
  float* os = reinterpret_cast<float*>(smem_raw);  // [CB][OP], at the end
  const int cb = blockIdx.z % n_cb, b = blockIdx.z / n_cb;
  const int r0 = blockIdx.y * TR, l0 = blockIdx.x * TC;
  const int ir0 = r0 * S - (KS - 1) / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* xb = x + (long long)b * H * cin * wl_in;
  const int nt8 = n_cb * NW, k16 = K / 16;
  const int cob = cb * CB;
  if (l0 > Wo) {  // every column of the tile is past the image
    write_tile<CB>(nullptr, ea, out, b, r0, l0, cob, cout, Ho, Wo, wl_out);
    return;
  }

  // this lane's A row in each of the warp's row blocks, at tap (0, 0)
  int arow[MT];
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    const int m = (warp * MT + t) * 16 + (lane & 15);
    const int oy = m / TC, ox = m - oy * TC;
    arow[t] = ((S * oy) * G::IW + S * ox + G::OFF) * G::PI + (lane >> 4) * 8;
  }
  float acc[MT][NW][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;

  for (int ch0 = 0; ch0 < K; ch0 += G::KC) {
    const int nch = min(G::KC, K - ch0);
    __syncthreads();  // the previous chunk has been read
    stage<G::IH, G::IW, G::PI, G::KC>(xs, xb, ir0, H, cin, wl_in,
                                      S * l0 - G::LB, w_img, ch0, nch);
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < KS * KS; ++tap) {
      const int ky = tap / KS, kx = tap - ky * KS;
      const bf16* a[MT];
#pragma unroll
      for (int t = 0; t < MT; ++t)
        a[t] = xs + arow[t] + (ky * G::IW + kx) * G::PI;
      tap_mma<MT, NW, G::KC / 16>(
          acc, a,
          wf + ((long long)(tap * k16 + ch0 / 16) * nt8 + cb * NW) * 32 +
              lane,
          nt8, nch / 16);
    }
  }
  __syncthreads();  // the staged input has been read: os reuses it
  // + bias, leaky, the stride-2 rounding; channel-major into os
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (warp * MT + t) * 16 + g + 8 * h;
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = 8 * j + 2 * q + c;
          float y = acc[t][j][2 * h + c];
          if (cob + n < cout) y += bias[cob + n];
          if (ea.has_slope) y = fmaxf(y, y * ea.slope);
          if (S == 2) y = round_t<bf16>(y);
          os[n * OP + m] = y;
        }
    }
  __syncthreads();
  write_tile<CB>(os, ea, out, b, r0, l0, cob, cout, Ho, Wo, wl_out);
}

// The stride-2 adjoint on the tensor cores, from the unexpanded g
// [B, Hg, cin, wl_in] at width w_g to [B, 2 Hg, cout, wl_out]; wf the
// flipped kernel in fragment order (as planar_conv_tc_kernel's)
template <int NW>
__global__ void __launch_bounds__(NT)
    planar_convt2_tc_kernel(const bf16* __restrict__ g,
                            const uint2* __restrict__ wf,
                            const float* __restrict__ bias, EpiArgs ea,
                            bf16* __restrict__ out, int Hg, int cin, int K,
                            int wl_in, int w_g, int cout, int n_cb,
                            int wl_out) {
  using G = GeomT2;
  constexpr int CB = 8 * NW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  float* os = reinterpret_cast<float*>(smem_raw);
  const int cb = blockIdx.z % n_cb, b = blockIdx.z / n_cb;
  const int r0 = blockIdx.y * TR, l0 = blockIdx.x * TC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* gb = g + (long long)b * Hg * cin * wl_in;
  const int nt8 = n_cb * NW, k16 = K / 16;
  const int cob = cb * CB;
  if (l0 > 2 * w_g) {  // every column of the tile is past the image
    write_tile<CB>(nullptr, ea, out, b, r0, l0, cob, cout, 2 * Hg, 2 * w_g,
                   wl_out);
    return;
  }
  // the warp's two items: (parity, 16-row block of the parity's 4 x 16
  // super positions)
  // super positions: warps 0-3 parities (1, 1) and (0, 0), warps 4-7
  // (0, 1) and (1, 0)
  const int rb = warp & 3;
  const int pys[2] = {warp < 4 ? 1 : 0, warp < 4 ? 0 : 1};
  const int pxs[2] = {1, 0};
  const int m = rb * 16 + (lane & 15);
  int arow[2];
#pragma unroll
  for (int it = 0; it < 2; ++it)
    arow[it] = ((m / G::SC) * G::IW + m % G::SC + 9 - pxs[it]) * G::PI +
               (lane >> 4) * 8;
  float acc[2][1][NW][4];
#pragma unroll
  for (int it = 0; it < 2; ++it)
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[it][0][j][e] = 0.f;

  for (int ch0 = 0; ch0 < K; ch0 += G::KC) {
    const int nch = min(G::KC, K - ch0);
    __syncthreads();
    stage<G::IH, G::IW, G::PI, G::KC>(xs, gb, r0 / 2, Hg, cin, wl_in,
                                      l0 / 2 - 8, w_g, ch0, nch);
    __syncthreads();
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int py = pys[it], px = pxs[it];
      const int ntap = (py + 1) * (px + 1);
#pragma unroll 1
      for (int i = 0; i < ntap; ++i) {
        const int iy = i / (px + 1), ix = i - iy * (px + 1);
        const int dy = py ? 2 * iy : 1, ey = py ? iy : 0;
        const int dx = px ? 2 * ix : 1, ex = px ? ix : 0;
        const bf16* const a[1] = {xs + arow[it] +
                                  (ey * G::IW + ex) * G::PI};
        tap_mma<1, NW, G::KC / 16>(
            acc[it], a,
            wf + ((long long)((dy * 3 + dx) * k16 + ch0 / 16) * nt8 +
                  cb * NW) * 32 + lane,
            nt8, nch / 16);
      }
    }
  }
  __syncthreads();
  const int gq = lane >> 2, q = lane & 3;
#pragma unroll
  for (int it = 0; it < 2; ++it)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mm = rb * 16 + gq + 8 * h;
      const int oy = 2 * (mm / G::SC) + pys[it];
      const int ox = 2 * (mm % G::SC) + 1 - pxs[it];
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = 8 * j + 2 * q + c;
          float y = acc[it][0][j][2 * h + c];
          if (cob + n < cout) y += bias[cob + n];
          os[n * OP + oy * TC + ox] = y;
        }
    }
  __syncthreads();
  write_tile<CB>(os, ea, out, b, r0, l0, cob, cout, 2 * Hg, 2 * w_g,
                 wl_out);
}

template <int KS, int S, int NW>
size_t smem_of() {
  return (size_t)max(Geom<KS, S>::IN_BYTES, out_bytes<NW>());
}
template <int NW>
size_t smem_t2() {
  return (size_t)max(GeomT2::IN_BYTES, out_bytes<NW>());
}

template <int KS, int S, int NW>
int launch(const void* x, const void* wf, const float* bias, EpiArgs ea,
           void* out, int B, int H, int cin, int K, int wl_in, int w_img,
           int cout, int cout_pad, cudaStream_t s) {
  const size_t smem = smem_of<KS, S, NW>();
  auto kern = planar_conv_tc_kernel<KS, S, NW>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int Ho = H / S, Wo = w_img / S;
  const int wl_out = (Wo + 2 + 127) / 128 * 128;
  const int n_cb = cout_pad / (8 * NW);
  dim3 grid(wl_out / TC, (Ho + TR - 1) / TR, B * n_cb);
  kern<<<grid, NT, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const uint2*>(wf), bias, ea,
      static_cast<bf16*>(out), H, cin, K, wl_in, w_img, cout, n_cb, Ho, Wo,
      wl_out);
  return (int)cudaGetLastError();
}

template <int KS, int S>
int launch_nw(const void* x, const void* wf, const float* bias, EpiArgs ea,
              void* out, int B, int H, int cin, int K, int wl_in, int w_img,
              int cout, int cout_pad, cudaStream_t s) {
  switch (nw_of(cout)) {
    case 1:
      return launch<KS, S, 1>(x, wf, bias, ea, out, B, H, cin, K, wl_in,
                              w_img, cout, cout_pad, s);
    case 2:
      return launch<KS, S, 2>(x, wf, bias, ea, out, B, H, cin, K, wl_in,
                              w_img, cout, cout_pad, s);
    case 4:
      return launch<KS, S, 4>(x, wf, bias, ea, out, B, H, cin, K, wl_in,
                              w_img, cout, cout_pad, s);
    default:
      return launch<KS, S, 8>(x, wf, bias, ea, out, B, H, cin, K, wl_in,
                              w_img, cout, cout_pad, s);
  }
}

template <int NW>
int launch_t2(const void* g, const void* wf, const float* bias, EpiArgs ea,
              void* out, int B, int Hg, int cin, int K, int wl_in, int w_g,
              int cout, int cout_pad, cudaStream_t s) {
  const size_t smem = smem_t2<NW>();
  auto kern = planar_convt2_tc_kernel<NW>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int Ho = 2 * Hg, Wo = 2 * w_g;
  const int wl_out = (Wo + 2 + 127) / 128 * 128;
  const int n_cb = cout_pad / (8 * NW);
  dim3 grid(wl_out / TC, (Ho + TR - 1) / TR, B * n_cb);
  kern<<<grid, NT, smem, s>>>(
      static_cast<const bf16*>(g), static_cast<const uint2*>(wf), bias, ea,
      static_cast<bf16*>(out), Hg, cin, K, wl_in, w_g, cout, n_cb, wl_out);
  return (int)cudaGetLastError();
}

template <int NW>
int info_nw(int variant, int* info) {
  switch (variant) {
    case 0:
      return info_of(planar_conv_tc_kernel<1, 1, NW>, smem_of<1, 1, NW>(),
                     info);
    case 1:
      return info_of(planar_conv_tc_kernel<3, 1, NW>, smem_of<3, 1, NW>(),
                     info);
    case 2:
      return info_of(planar_conv_tc_kernel<3, 2, NW>, smem_of<3, 2, NW>(),
                     info);
    default:
      return info_of(planar_convt2_tc_kernel<NW>, smem_t2<NW>(), info);
  }
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, res, gate, out); bias float32
// [cout] (float32: [cout_pad]). k = 1 (stride 1) or 3 (stride 1 or 2;
// stride 2 needs even H and w_img). res and gate are null or planar
// [B, H/stride, cout, wl_out]. float32: w HWIO [k][k][cin][cout_pad]
// (cout_pad a multiple of 8); bfloat16: w in mma.sync's fragment order,
// [k*k][K/16][cout_pad/8][32] uint2 with K the weights' cin rounded up to
// 16 and cout_pad a multiple of the block's 8 NW (tc::nw_of). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a geometry the kernel
// does not take.
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
    if (K % 16 != 0 || K <= 0 || cout_pad % (8 * tc::nw_of(cout)) != 0)
      return (int)cudaErrorInvalidValue;
    if (k == 1)
      return tc::launch_nw<1, 1>(x, w, bf, ea, out, B, H, cin, K, wl_in,
                                 w_img, cout, cout_pad, s);
    if (stride == 2)
      return tc::launch_nw<3, 2>(x, w, bf, ea, out, B, H, cin, K, wl_in,
                                 w_img, cout, cout_pad, s);
    return tc::launch_nw<3, 1>(x, w, bf, ea, out, B, H, cin, K, wl_in, w_img,
                               cout, cout_pad, s);
  }
  if (cout_pad % 8 != 0) return (int)cudaErrorInvalidValue;
  return launch_f32(x, w, bf, ea, out, B, H, cin, wl_in, w_img, cout,
                    cout_pad, k, stride, s);
}

// The stride-2 adjoint (k3t2): g planar [B, Hg, cin, wl_in] at image width
// w_g -> out planar [B, 2 Hg, cout, wl_out] at width 2 w_g, with the
// flipped kernel w (float32: HWIO [3][3][cin][cout_pad], cout_pad a
// multiple of 8; bfloat16: fragment order as apfp_planar_conv's), bias,
// no leaky, and gate (null or planar like out) applied last. Returns
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
  const int wl_out = (2 * w_g + 2 + 127) / 128 * 128;
  if (dtype == 1) {
    const int nw = tc::nw_of(cout);
    if (K % 16 != 0 || K <= 0 || cout_pad % (8 * nw) != 0)
      return (int)cudaErrorInvalidValue;
    switch (nw) {
      case 1:
        return tc::launch_t2<1>(g, w, bf, ea, out, B, Hg, cin, K, wl_in, w_g,
                                cout, cout_pad, s);
      case 2:
        return tc::launch_t2<2>(g, w, bf, ea, out, B, Hg, cin, K, wl_in, w_g,
                                cout, cout_pad, s);
      case 4:
        return tc::launch_t2<4>(g, w, bf, ea, out, B, Hg, cin, K, wl_in, w_g,
                                cout, cout_pad, s);
      default:
        return tc::launch_t2<8>(g, w, bf, ea, out, B, Hg, cin, K, wl_in, w_g,
                                cout, cout_pad, s);
    }
  }
  if (cout_pad % 8 != 0) return (int)cudaErrorInvalidValue;
  dim3 grid((w_g + 31) / 32, (Hg + 7) / 8, B * (cout_pad / 8));
  planar_convt2_f32_kernel<<<grid, NT, 0, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(w), bf, ea,
      static_cast<float*>(out), Hg, cin, wl_in, w_g, cout, cout_pad, wl_out);
  return (int)cudaGetLastError();
}

// A bfloat16 tensor-core instantiation as the card sees it: variant 0 =
// 1x1, 1 = 3x3 stride 1, 2 = 3x3 stride 2, 3 = the stride-2 adjoint; nw =
// 1, 2, 4 or 8 (8 nw output channels a block). info[0] registers a thread,
// info[1] the dynamic shared memory bytes of a launch, info[2] the blocks
// one multiprocessor holds. Returns the CUDA error.
extern "C" int apfp_planar_conv_info(int variant, int nw, int* info) {
  switch (nw) {
    case 1: return tc::info_nw<1>(variant, info);
    case 2: return tc::info_nw<2>(variant, info);
    case 4: return tc::info_nw<4>(variant, info);
    default: return tc::info_nw<8>(variant, info);
  }
}
