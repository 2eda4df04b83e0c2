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
// bfloat16 (TILE 8) runs the five convs on the tensor cores, each as an
// implicit GEMM (stem_common.cuh: mma_conv; M the tile's positions, N
// COUT, K CIN x taps) with float32 accumulation, its epilogue
// (stem_common.cuh: EpiConv) doing what conv_stage's does per element
// (bias, leaky, round, the sign byte, the shortcut sum, zero outside the
// image). Conv0's 3 channels are padded to 8, and two taps of a row share
// one 16-deep step (RowsConv0: 6 steps, K 96 for 27 real; conv0 is 6% of
// the FLOPs). The weights come in
// mma.sync's B fragment order (230 KB, read through L1/L2; the next tap's
// are loaded while a tap's MMAs run). The tiles' row pitches are padded by
// 16 bytes (P32/P64/P128) so that the eight rows of an ldmatrix phase fall
// in distinct bank groups at stride 1 (two-way at stride 2). float32
// (TILE 4) runs every conv on conv_stage's FMAs: TF32 tensor cores would
// not hold the float32 gradient checks.
//
// Conv padding applies to each layer's input, so every halo position of
// y0, y1, y2 and s4 that lies outside the image is stored as zero (not
// leaky(bias)), as the Pallas kernel's in-range scale does.
//
// Shared memory at peak: bfloat16 TILE 8 = 173,664 bytes (y0, y1; x sits
// in y1's region until conv1; y2, s4 and, with save_acts, y3's sign bytes
// reuse y0's region once conv1 has read it, y5 reuses y1's); float32 TILE
// 4 = 106,208 bytes (x in a region of its own). The shared-memory
// carve-out then leaves the L1 cache ~60 KB (bfloat16) for the weights.

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

template <typename T, int TILE, bool SAVE>
__global__ void __launch_bounds__(NT, 1)
    fused_stem_fwd_kernel(const T* __restrict__ xe, const T* __restrict__ xo,
                          const T* __restrict__ w0, const T* __restrict__ w1,
                          const T* __restrict__ w2, const T* __restrict__ w3,
                          const T* __restrict__ w5,
                          const float* __restrict__ b0,
                          const float* __restrict__ b1,
                          const float* __restrict__ b2,
                          const float* __restrict__ b3,
                          const float* __restrict__ b5, Frags fr,
                          T* __restrict__ y5, Masks mk, int H, int wlh,
                          int wl5) {
  constexpr bool MMA = sizeof(T) == 2;
  constexpr bool PF = true;  // one block a multiprocessor: registers to spare
  using G = Geom<TILE, sizeof(T) == 2 ? 8 : 0>;
  static_assert(sizeof(T) * (G::B - G::SIGN_AT) >= G::SIGN_BYTES,
                "y3 signs past s4");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* y0 = reinterpret_cast<T*>(smem_raw) + G::A;  // [Y0N][Y0N][P32]
  T* y2 = y0;                              // [Y1N][Y1N][P32], after conv1
  T* s4 = y0 + G::Y2;                      // [S4N][S4N][P64]
  T* y1 = y0 + G::B;                       // [Y1N][Y1N][P64]
  T* ys = y1;                              // [TILE][TILE][P128], after conv3
  // [XP][XC], before conv1 writes y1
  T* xs = MMA ? y1 : reinterpret_cast<T*>(smem_raw);
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
    T v = from_f<T>(0.f);
    if (ci < 3 && gr >= 0 && gr < H && gc >= 0 && gc < H) {
      const T* src = (gc & 1) ? xo : xe;
      v = src[(((long long)b * H + gr) * 8 + ci) * wlh + (gc >> 1) + 1];
    }
    xs[(r * G::XN + col) * G::XC + ci] = v;
  }
  if (G::XP > G::XN * G::XN && threadIdx.x < G::XC)
    xs[G::XN * G::XN * G::XC + threadIdx.x] = from_f<T>(0.f);
  __syncthreads();
  if constexpr (MMA)
    mma_conv<16, 8, 32, 4, 4, PF>(
        xs, G::Y0N * G::Y0N, fr.w0, RowsConv0{G::Y0N, G::XN},
        EpiConv<G::P32, false, false>{y0, G::Y0N, b0, 4 * R5 - 5, 4 * C5 - 5,
                                      H, nullptr, 0, nullptr});
  else
    conv_stage<T, 3, 32, 3, 1, 4>(xs, G::XN, y0, G::Y0N, G::Y0N, w0, b0,
                                  4 * R5 - 5, 4 * C5 - 5, H, nullptr, 0);
  __syncthreads();
  // the own region of each layer: y0 rows/cols [4 R5, 4 R5 + 4 TILE) at
  // tile offset 5, y1 and y2 [2 R5, 2 R5 + 2 TILE) at offset 2, y3 at
  // offset 1; the tiles of all blocks partition the image
  if (SAVE)
    save_mask<T, 32, G::P32, 4 * TILE, true>(y0, G::Y0N, 5, 4 * R5, 4 * C5,
                                             mk.y0e, mk.y0o, H, wlh, b, last);
  if constexpr (MMA)
    mma_conv<32, G::P32, 64, 4, 3, PF>(
        y0, G::Y1N * G::Y1N, fr.w1, RowsConv<3, 2>{G::Y1N, G::Y0N},
        EpiConv<G::P64, false, false>{y1, G::Y1N, b1, 2 * R5 - 2, 2 * C5 - 2,
                                      H1, nullptr, 0, nullptr});
  else
    conv_stage<T, 32, 64, 3, 2, 4>(y0, G::Y0N, y1, G::Y1N, G::Y1N, w1, b1,
                                   2 * R5 - 2, 2 * C5 - 2, H1, nullptr, 0);
  __syncthreads();
  if (SAVE)
    save_mask<T, 64, G::P64, 2 * TILE, false>(y1, G::Y1N, 2, 2 * R5, 2 * C5,
                                              mk.y1, nullptr, H1, wlh, b,
                                              last);
  if constexpr (MMA)
    mma_conv<64, G::P64, 32, 4, 3, PF>(
        y1, G::Y1N * G::Y1N, fr.w2, RowsConv<1, 1>{G::Y1N, G::Y1N},
        EpiConv<G::P32, false, false>{y2, G::Y1N, b2, 2 * R5 - 2, 2 * C5 - 2,
                                      H1, nullptr, 0, nullptr});
  else
    conv_stage<T, 64, 32, 1, 1, 4>(y1, G::Y1N, y2, G::Y1N, G::Y1N, w2, b2,
                                   2 * R5 - 2, 2 * C5 - 2, H1, nullptr, 0);
  __syncthreads();
  if (SAVE)
    save_mask<T, 32, G::P32, 2 * TILE, false>(y2, G::Y1N, 2, 2 * R5, 2 * C5,
                                              mk.y2, nullptr, H1, wlh, b,
                                              last);
  if constexpr (MMA)
    mma_conv<32, G::P32, 64, 4, 3, PF>(
        y2, G::S4N * G::S4N, fr.w3, RowsConv<3, 1>{G::S4N, G::Y1N},
        EpiConv<G::P64, SAVE, true, G::P64>{s4, G::S4N, b3, 2 * R5 - 1,
                                            2 * C5 - 1, H1, y1, G::Y1N, y3s});
  else
    conv_stage<T, 32, 64, 3, 1, 4, SAVE>(y2, G::Y1N, s4, G::S4N, G::S4N, w3,
                                         b3, 2 * R5 - 1, 2 * C5 - 1, H1, y1,
                                         G::Y1N, y3s);
  __syncthreads();
  if (SAVE)
    save_mask<unsigned char, 64, 64, 2 * TILE, false>(
        y3s, G::S4N, 1, 2 * R5, 2 * C5, mk.y3, nullptr, H1, wlh, b, last);
  if constexpr (MMA)
    mma_conv<64, G::P64, 128, 4, 2, PF>(
        s4, TILE * TILE, fr.w5, RowsConv<3, 2>{TILE, G::S4N},
        EpiConv<G::P128, false, false>{ys, TILE, b5, 0, 0, 0x7fffffff,
                                       nullptr, 0, nullptr});
  else
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
      y5r[(long long)line * wl5] = from_f<T>(0.f);
  if (last) zero_tail(y5r, n5, H5 + 1, wl5);
}

template <typename T, int TILE, bool SAVE>
size_t smem_bytes() {
  return sizeof(T) * (size_t)Geom<TILE, sizeof(T) == 2 ? 8 : 0>::ELEMS;
}

template <typename T, int TILE, bool SAVE>
int launch(const void* xe, const void* xo, const void* const* w,
           const float* const* bias, Frags fr, void* y5, Masks mk, int B,
           int H, int wlh, int wl5, cudaStream_t s) {
  const size_t smem = smem_bytes<T, TILE, SAVE>();
  cudaError_t e = cudaFuncSetAttribute(
      fused_stem_fwd_kernel<T, TILE, SAVE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nt = (H / 4 + TILE - 1) / TILE;
  dim3 grid(nt, nt, B);
  fused_stem_fwd_kernel<T, TILE, SAVE><<<grid, NT, smem, s>>>(
      static_cast<const T*>(xe), static_cast<const T*>(xo),
      static_cast<const T*>(w[0]), static_cast<const T*>(w[1]),
      static_cast<const T*>(w[2]), static_cast<const T*>(w[3]),
      static_cast<const T*>(w[4]), bias[0], bias[1], bias[2], bias[3],
      bias[4], fr, static_cast<T*>(y5), mk, H, wlh, wl5);
  return (int)cudaGetLastError();
}

template <typename T, int TILE>
int launch_any(const void* xe, const void* xo, const void* const* w,
               const float* const* bias, Frags fr, void* y5, Masks mk, int B,
               int H, int wlh, int wl5, cudaStream_t s) {
  if (mk.y0e != nullptr)
    return launch<T, TILE, true>(xe, xo, w, bias, fr, y5, mk, B, H, wlh, wl5,
                                 s);
  return launch<T, TILE, false>(xe, xo, w, bias, fr, y5, mk, B, H, wlh, wl5,
                                s);
}

// info: registers a thread, dynamic shared memory bytes, blocks a
// multiprocessor holds
template <typename T, int TILE, bool SAVE>
int info_of(int* info) {
  const size_t smem = smem_bytes<T, TILE, SAVE>();
  cudaError_t e = cudaFuncSetAttribute(
      fused_stem_fwd_kernel<T, TILE, SAVE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, fused_stem_fwd_kernel<T, TILE, SAVE>);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fused_stem_fwd_kernel<T, TILE, SAVE>, NT, smem);
  info[0] = a.numRegs;
  info[1] = (int)smem;
  info[2] = blocks;
  return (int)e;
}

}  // namespace

// dtype: 0 = float32 (TILE 4), 1 = bfloat16 (TILE 8). Weights are HWIO in
// the compute dtype, biases float32; f0 .. f5 the bfloat16 convs 0, 1, 2,
// 3, 5 in mma.sync's fragment order (null in float32). m0e .. m3 are the
// save_acts sign masks (int8, planar), all null for the forward alone
// (serving), which then runs the kernel instantiated without any mask
// code. Returns cudaGetLastError().
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
  const Frags fr = {static_cast<const uint2*>(f0),
                    static_cast<const uint2*>(f1),
                    static_cast<const uint2*>(f2),
                    static_cast<const uint2*>(f3),
                    static_cast<const uint2*>(f5)};
  const Masks mk = {static_cast<int8_t*>(m0e), static_cast<int8_t*>(m0o),
                    static_cast<int8_t*>(m1), static_cast<int8_t*>(m2),
                    static_cast<int8_t*>(m3)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_any<__nv_bfloat16, 8>(xe, xo, w, bias, fr, y5, mk, B, H,
                                        wlh, wl5, s);
  return launch_any<float, 4>(xe, xo, w, bias, fr, y5, mk, B, H, wlh, wl5,
                              s);
}

// The kernel instantiation of (dtype, save) as the card sees it: info[0]
// registers a thread, info[1] the dynamic shared memory bytes of a launch,
// info[2] the blocks one multiprocessor holds. Returns the CUDA error.
extern "C" int apfp_fused_stem_fwd_info(int dtype, int save, int* info) {
  if (dtype == 1)
    return save ? info_of<__nv_bfloat16, 8, true>(info)
                : info_of<__nv_bfloat16, 8, false>(info);
  return save ? info_of<float, 4, true>(info) : info_of<float, 4, false>(info);
}
