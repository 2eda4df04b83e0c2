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
// ~295 FLOP/byte ridge. What this first design does about it: nothing
// clever yet. Each block owns a TILE x TILE tile of y5 for all 128
// channels and computes backwards over its receptive field entirely in
// shared memory (x 41^2 -> y0 39^2x32 -> y1 19^2x64 -> y2 19^2x32 ->
// s4 17^2x64 -> y5 8^2x128 at TILE 8), so no intermediate touches device
// memory; the halo recompute costs ~1.35x the FLOPs. The convs are
// CUDA-core FMAs with float32 accumulation, each thread holding a
// PT-position x 8-channel register tile; weights (HWIO) are read through
// the read-only cache. Tensor cores (wgmma) and TMA are later work.
//
// Conv padding applies to each layer's input, so every halo position of
// y0, y1, y2 and s4 that lies outside the image is stored as zero (not
// leaky(bias)), as the Pallas kernel's in-range scale does.
//
// Shared memory at peak: bfloat16 TILE 8 = 153,648 bytes (x, y0, y1; y2
// and s4 reuse y0's region once conv1 has read it, y5 reuses y1's);
// float32 runs TILE 4 = 106,208 bytes.

#include "stem_common.cuh"

namespace {

using namespace stem;

// Sign masks of one own (non-halo) n x n region of a [pos][C] tile of
// side TW, whose first own position is (off, off) in the tile and
// (r0, c0) in the image, into a planar int8 tensor [B, rows, C, wl]:
// 1 where the value is > 0, else 0. PHASE splits the columns into the
// even (d0) and odd (d1) column phases, value j at lane j + 1, as the
// y0 masks are; otherwise column c goes to lane c + 1 of d0. Lanes run
// fastest so that a warp writes neighbouring bytes. The block of the
// first tile column also zeroes lane 0 of its rows, the block of the last
// tile column the lanes past the image (wq + 1 .. wl - 1).
template <typename V, int C, bool PHASE>
__device__ void save_mask(const V* __restrict__ tile, int TW, int off, int n,
                          int r0, int c0, int8_t* __restrict__ d0,
                          int8_t* __restrict__ d1, int rows, int wl, int wq,
                          int b, bool first, bool last) {
  const int half = PHASE ? n / 2 : n;
  for (int idx = threadIdx.x; idx < n * C * n; idx += NT) {
    const int k = idx % n;
    const int rest = idx / n;
    const int ch = rest % C, rr = rest / C;
    const int ph = k / half, j = k - ph * half;
    const int col = PHASE ? 2 * j + ph : k;
    // square images: the last tile row / column may reach past the image
    if (r0 + rr >= rows || c0 + col >= rows) continue;
    const int lane = PHASE ? c0 / 2 + j + 1 : c0 + k + 1;
    int8_t* d = ph ? d1 : d0;
    const float v = to_f(tile[((rr + off) * TW + col + off) * C + ch]);
    d[(((long long)b * rows + r0 + rr) * C + ch) * wl + lane] =
        v > 0.f ? 1 : 0;
  }
  if (first || last) {
    const int nr = last ? wl - wq - 1 : 0;
    const int nz = nr + (first ? 1 : 0);
    const int nd = PHASE ? 2 : 1;
    for (int idx = threadIdx.x; idx < n * C * nz * nd; idx += NT) {
      const int k = idx % nz;
      int rest = idx / nz;
      const int ch = rest % C;
      rest /= C;
      const int rr = rest % n, ph = rest / n;
      const int lane = k < nr ? wq + 1 + k : 0;
      if (r0 + rr < rows)
        (ph ? d1 : d0)[(((long long)b * rows + r0 + rr) * C + ch) * wl +
                       lane] = 0;
    }
  }
}

template <int TILE>
struct Geom {
  static constexpr int S4N = 2 * TILE + 1;  // s4 / y3 tile side
  static constexpr int Y1N = S4N + 2;       // y1 / y2 tile side
  static constexpr int Y0N = 2 * Y1N + 1;   // y0 tile side
  static constexpr int XN = Y0N + 2;        // x tile side
  static constexpr int A = (XN * XN * 3 + 7) / 8 * 8;
  static constexpr int Y2 = Y1N * Y1N * 32;
  static constexpr int B0 = Y0N * Y0N * 32;
  static constexpr int B1 = Y2 + S4N * S4N * 64;
  static constexpr int B = B0 > B1 ? B0 : B1;
  static constexpr int C0 = Y1N * Y1N * 64;
  static constexpr int C1 = TILE * TILE * 128;
  static constexpr int C = C0 > C1 ? C0 : C1;
  static constexpr int ELEMS = A + B + C;
  static constexpr int SIGN_BYTES = S4N * S4N * 64;  // y3 signs (SAVE)
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
                          const float* __restrict__ b5, T* __restrict__ y5,
                          Masks mk, int H, int wlh, int wl5) {
  using G = Geom<TILE>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // [XN][XN][3]
  T* y0 = xs + G::A;                       // [Y0N][Y0N][32]
  T* y2 = y0;                              // [Y1N][Y1N][32], after conv1
  T* s4 = y0 + G::Y2;                      // [S4N][S4N][64]
  T* y1 = y0 + G::B;                       // [Y1N][Y1N][64]
  T* ys = y1;                              // [TILE][TILE][128], after conv3
  // [S4N][S4N][64] signs of y3 (SAVE only)
  unsigned char* y3s = smem_raw + sizeof(T) * G::ELEMS;

  const int b = blockIdx.z;
  const int R5 = blockIdx.y * TILE, C5 = blockIdx.x * TILE;
  const int H1 = H / 2, H5 = H / 4;
  const bool first = blockIdx.x == 0, last = blockIdx.x == gridDim.x - 1;

  // x tile, image rows/cols from 4*R5 - 6; column c of x is lane c/2 + 1
  // of the even (c even) or odd phase
  const int xr0 = 4 * R5 - 6, xc0 = 4 * C5 - 6;
  for (int idx = threadIdx.x; idx < G::XN * G::XN * 3; idx += NT) {
    const int ci = idx % 3;
    const int p = idx / 3;
    const int gr = xr0 + p / G::XN, gc = xc0 + p % G::XN;
    T v = from_f<T>(0.f);
    if (gr >= 0 && gr < H && gc >= 0 && gc < H) {
      const T* src = (gc & 1) ? xo : xe;
      v = src[(((long long)b * H + gr) * 8 + ci) * wlh + (gc >> 1) + 1];
    }
    xs[idx] = v;
  }
  __syncthreads();
  conv_stage<T, 3, 32, 3, 1, 4>(xs, G::XN, y0, G::Y0N, G::Y0N, w0, b0,
                                4 * R5 - 5, 4 * C5 - 5, H, nullptr, 0);
  __syncthreads();
  // the own region of each layer: y0 rows/cols [4 R5, 4 R5 + 4 TILE) at
  // tile offset 5, y1 and y2 [2 R5, 2 R5 + 2 TILE) at offset 2, y3 at
  // offset 1; the tiles of all blocks partition the image
  if (SAVE)
    save_mask<T, 32, true>(y0, G::Y0N, 5, 4 * TILE, 4 * R5, 4 * C5, mk.y0e,
                           mk.y0o, H, wlh, H1, b, first, last);
  conv_stage<T, 32, 64, 3, 2, 4>(y0, G::Y0N, y1, G::Y1N, G::Y1N, w1, b1,
                                 2 * R5 - 2, 2 * C5 - 2, H1, nullptr, 0);
  __syncthreads();
  if (SAVE)
    save_mask<T, 64, false>(y1, G::Y1N, 2, 2 * TILE, 2 * R5, 2 * C5, mk.y1,
                            nullptr, H1, wlh, H1, b, first, last);
  conv_stage<T, 64, 32, 1, 1, 4>(y1, G::Y1N, y2, G::Y1N, G::Y1N, w2, b2,
                                 2 * R5 - 2, 2 * C5 - 2, H1, nullptr, 0);
  __syncthreads();
  if (SAVE)
    save_mask<T, 32, false>(y2, G::Y1N, 2, 2 * TILE, 2 * R5, 2 * C5, mk.y2,
                            nullptr, H1, wlh, H1, b, first, last);
  conv_stage<T, 32, 64, 3, 1, 4, SAVE>(y2, G::Y1N, s4, G::S4N, G::S4N, w3,
                                       b3, 2 * R5 - 1, 2 * C5 - 1, H1, y1,
                                       G::Y1N, y3s);
  __syncthreads();
  if (SAVE)
    save_mask<unsigned char, 64, false>(y3s, G::S4N, 1, 2 * TILE, 2 * R5,
                                        2 * C5, mk.y3, nullptr, H1, wlh, H1,
                                        b, first, last);
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
          ys[(rr * TILE + cc) * 128 + co];
  }
  // zero border and padding lanes of this tile row: lane 0 (first tile
  // column) and lanes H5+1 .. wl5-1 (last tile column)
  if (first || last) {
    const int nr = last ? wl5 - H5 - 1 : 0;  // right padding lanes
    const int n = nr + (first ? 1 : 0);
    for (int idx = threadIdx.x; idx < TILE * 128 * n; idx += NT) {
      const int k = idx % n;
      const int rest = idx / n;
      const int co = rest % 128, gr = R5 + rest / 128;
      const int lane = k < nr ? H5 + 1 + k : 0;
      if (gr < H5)
        y5[(((long long)b * H5 + gr) * 128 + co) * wl5 + lane] =
            from_f<T>(0.f);
    }
  }
}

template <typename T, int TILE, bool SAVE>
int launch(const void* xe, const void* xo, const void* const* w,
           const float* const* bias, void* y5, Masks mk, int B, int H,
           int wlh, int wl5, cudaStream_t s) {
  const size_t smem = sizeof(T) * (size_t)Geom<TILE>::ELEMS +
                      (SAVE ? (size_t)Geom<TILE>::SIGN_BYTES : 0);
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
      bias[4], static_cast<T*>(y5), mk, H, wlh, wl5);
  return (int)cudaGetLastError();
}

template <typename T, int TILE>
int launch_any(const void* xe, const void* xo, const void* const* w,
               const float* const* bias, void* y5, Masks mk, int B, int H,
               int wlh, int wl5, cudaStream_t s) {
  if (mk.y0e != nullptr)
    return launch<T, TILE, true>(xe, xo, w, bias, y5, mk, B, H, wlh, wl5, s);
  return launch<T, TILE, false>(xe, xo, w, bias, y5, mk, B, H, wlh, wl5, s);
}

}  // namespace

// dtype: 0 = float32 (TILE 4), 1 = bfloat16 (TILE 8). Weights are HWIO in
// the compute dtype, biases float32. m0e .. m3 are the save_acts sign
// masks (int8, planar), all null for the forward alone (serving), which
// then runs the kernel instantiated without any mask code. Returns
// cudaGetLastError().
extern "C" int apfp_fused_stem_fwd(const void* xe, const void* xo,
                                   const void* w0, const void* w1,
                                   const void* w2, const void* w3,
                                   const void* w5, const void* b0,
                                   const void* b1, const void* b2,
                                   const void* b3, const void* b5, void* y5,
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
  if (dtype == 1)
    return launch_any<__nv_bfloat16, 8>(xe, xo, w, bias, y5, mk, B, H, wlh,
                                        wl5, s);
  return launch_any<float, 4>(xe, xo, w, bias, y5, mk, B, H, wlh, wl5, s);
}
