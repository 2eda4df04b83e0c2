// NHWC <-> planar layout kernels (K3a to_planar, K3b from_planar).
//
// Replace the JAX package's Pallas kernels ops/planar_conv.py
// to_planar_mxu and from_planar_mxu, which did the transpose as a one-hot
// matmul on the TPU's matrix unit. Here they are plain data movement:
// each output element is one input element or zero, so a kernel is bound
// by bytes (each input read once, each output written once) and does no
// arithmetic. The planar row of image row h is [C', Wl]: value (h, w, c)
// at lane w + 1 of channel row c, lane 0 and lanes past the image zero,
// channels past C zero. step/offset fold a column decimation into
// to_planar (step 2, offset 0/1 = the even/odd column phases the fused
// stem reads).
//
// Every kernel moves raw bits (uint16_t for bfloat16, uint32_t for
// float32), so it is exact for either dtype, and moves them in 16-byte
// vectors (V = 8 or 4 elements) wherever the addresses allow: a thread's
// global load or store is one vector, and the blocks walk image rows
// with a grid-stride loop (no cap on B * H). Two designs, by the width
// of the NHWC side:
//
// - narrow (C < 32; the stem's 3-channel input and the planar stem's
//   3-channel input cotangent): the NHWC row (or a chunk of its columns)
//   is one contiguous run of a few KB. It goes through a shared-memory
//   stage with 16-byte vectors (scalar elements only for the run's
//   unaligned head and tail, so any base pointer and row pitch work).
//   to_planar then builds each output vector (V lanes of one channel row
//   of one phase) by a strided gather from the stage and stores it with
//   one 16-byte store; padding channel rows, lane 0 and lanes past the
//   image are zero vectors that read nothing. One launch writes both
//   column phases of split_phases from one read of x. from_planar
//   scatters the planar vectors' image lanes into the stage in NHWC
//   order and writes the NHWC run back with 16-byte stores.
// - tiled (C >= 32; g5, the 152^2 stage's input and cotangent, y5, y11):
//   a thread owns a V x V tile: V lanes x V channels. It loads V 16-byte
//   vectors from one side (to_planar: V channels of each of V image
//   columns; from_planar: V lanes of each of V channel rows), transposes
//   the tile in registers (byte permutes; no shared memory and no
//   barrier), and stores V 16-byte vectors on the other side. The
//   one-lane shift costs nothing: it only changes which column a lane's
//   vector comes from (to_planar) or goes to (from_planar), and those
//   vectors run along channels. A warp owns a 4 x 8 or 8 x 4 block of
//   tiles (warp_tile), so each of its vector instructions covers runs of
//   64 or 128 bytes, whole 32-byte sectors, on both sides. Vectors of padding channels or of
//   lanes past the image are zero and read nothing; a channel block past
//   C, or a row pitch or base that is no multiple of 16 bytes, takes
//   scalar elements inside the same kernel.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;              // threads a block
constexpr int STAGE_BYTES = 16384;   // a narrow kernel's shared stage
constexpr long long MAX_GRID = 1 << 20;

template <typename U>
struct Vec {
  static constexpr int V = 16 / (int)sizeof(U);  // elements a vector
};

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set_word(uint4& v, int i, uint32_t x) {
  if (i == 0) v.x = x;
  else if (i == 1) v.y = x;
  else if (i == 2) v.z = x;
  else v.w = x;
}

// V elements <-> one vector, element 0 in the low half of word 0
__device__ __forceinline__ uint4 pack(const uint16_t (&e)[8]) {
  uint4 r;
#pragma unroll
  for (int w = 0; w < 4; ++w)
    set_word(r, w, (uint32_t)e[2 * w] | ((uint32_t)e[2 * w + 1] << 16));
  return r;
}
__device__ __forceinline__ uint4 pack(const uint32_t (&e)[4]) {
  return make_uint4(e[0], e[1], e[2], e[3]);
}
__device__ __forceinline__ void unpack(const uint4& v, uint16_t (&e)[8]) {
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    e[2 * w] = (uint16_t)(word(v, w) & 0xffffu);
    e[2 * w + 1] = (uint16_t)(word(v, w) >> 16);
  }
}
__device__ __forceinline__ void unpack(const uint4& v, uint32_t (&e)[4]) {
  e[0] = v.x; e[1] = v.y; e[2] = v.z; e[3] = v.w;
}

// b[e] = element e of every a[k] (k-th element of b[e] from a[k]): the
// V x V tile transposed in registers
__device__ __forceinline__ void transpose(const uint4 (&a)[8],
                                          uint4 (&b)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e)
#pragma unroll
    for (int w = 0; w < 4; ++w)
      set_word(b[e], w, __byte_perm(word(a[2 * w], e / 2),
                                    word(a[2 * w + 1], e / 2),
                                    (e & 1) ? 0x7632 : 0x5410));
}
__device__ __forceinline__ void transpose(const uint4 (&a)[4],
                                          uint4 (&b)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int k = 0; k < 4; ++k) set_word(b[e], k, word(a[k], e));
}

// the first n (<= V) elements at p as one vector, the rest zero: one
// 16-byte load when the vector is whole and vec says p is aligned
template <typename U>
__device__ __forceinline__ uint4 load_v(const U* p, int n, bool vec) {
  constexpr int V = Vec<U>::V;
  if (vec && n == V) return *reinterpret_cast<const uint4*>(p);
  U e[V];
#pragma unroll
  for (int i = 0; i < V; ++i) e[i] = i < n ? p[i] : U(0);
  return pack(e);
}

// the first n (<= V) elements of v to p
template <typename U>
__device__ __forceinline__ void store_v(U* p, const uint4& v, int n,
                                        bool vec) {
  constexpr int V = Vec<U>::V;
  if (vec && n == V) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  U e[V];
  unpack(v, e);
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (i < n) p[i] = e[i];
}

// the stage index of global element 0 of a run at g: the run is staged
// at the same address modulo 16, so both sides of its body are aligned
template <typename U>
__device__ __forceinline__ int stage_shift(const U* g) {
  return (int)((reinterpret_cast<uintptr_t>(g) & 15) / sizeof(U));
}

// g[0, n) -> stage[s, s + n), s = stage_shift(g): 16-byte vectors for the
// aligned body, elements for the head and tail. The block's threads share
// the copy; the caller synchronises.
template <typename U>
__device__ __forceinline__ void stage_in(U* stage, const U* g, int s,
                                         int n) {
  constexpr int V = Vec<U>::V;
  const int head = min((V - s) % V, n);
  const int nv = (n - head) / V, tail = head + nv * V;
  for (int i = threadIdx.x; i < nv; i += NT)
    *reinterpret_cast<uint4*>(stage + s + head + i * V) =
        *reinterpret_cast<const uint4*>(g + head + i * V);
  for (int i = threadIdx.x; i < head; i += NT) stage[s + i] = g[i];
  for (int i = tail + threadIdx.x; i < n; i += NT) stage[s + i] = g[i];
}

// stage[s, s + n) -> g[0, n), s = stage_shift(g): the mirror of stage_in
template <typename U>
__device__ __forceinline__ void stage_out(U* g, const U* stage, int s,
                                          int n) {
  constexpr int V = Vec<U>::V;
  const int head = min((V - s) % V, n);
  const int nv = (n - head) / V, tail = head + nv * V;
  for (int i = threadIdx.x; i < nv; i += NT)
    *reinterpret_cast<uint4*>(g + head + i * V) =
        *reinterpret_cast<const uint4*>(stage + s + head + i * V);
  for (int i = threadIdx.x; i < head; i += NT) g[i] = stage[s + i];
  for (int i = tail + threadIdx.x; i < n; i += NT) g[i] = stage[s + i];
}

// the outputs of one narrow to_planar launch: one phase, or split_phases'
// two (offsets 0 and 1 of step 2); each [rows, cp, wl[p]], lane l of
// channel row c = x column step * (l - 1) + off[p] for 1 <= l <= w_out[p]
template <typename U>
struct Phases {
  U* out[2];
  int wl[2], w_out[2], off[2];
};

// unit u = (image row, chunk of lc lanes of every phase): stage the input
// columns the chunk reads, then write its output vectors
template <typename U>
__global__ void __launch_bounds__(NT)
to_planar_narrow_kernel(const U* __restrict__ x, Phases<U> ph, int nph,
                        int W, int C, int cp, int step, long long rows,
                        int lc, int nchunk) {
  constexpr int V = Vec<U>::V;
  __shared__ __align__(16) U stage[STAGE_BYTES / sizeof(U)];
  const long long units = rows * nchunk;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long row = u / nchunk;
    const int l0 = (int)(u - row * nchunk) * lc;
    // the input columns [c_lo, c_hi) of lanes [l0, l0 + lc), all phases
    // (the phases' fields are picked with p ? [1] : [0]: an indexed
    // kernel parameter would be copied to a local-memory stack frame)
    int c_lo = INT_MAX, c_hi = 0;
    for (int p = 0; p < nph; ++p) {
      const int off = p ? ph.off[1] : ph.off[0];
      const int j_lo = max(l0 - 1, 0);
      const int j_hi = min(l0 + lc - 1, p ? ph.w_out[1] : ph.w_out[0]);
      if (j_lo < j_hi) {
        c_lo = min(c_lo, step * j_lo + off);
        c_hi = max(c_hi, step * (j_hi - 1) + off + 1);
      }
    }
    int s = 0;
    if (c_lo < c_hi) {
      const U* g = x + (row * W + c_lo) * C;
      s = stage_shift(g);
      stage_in(stage, g, s, (c_hi - c_lo) * C);
    }
    __syncthreads();
    for (int p = 0; p < nph; ++p) {
      const int wl = p ? ph.wl[1] : ph.wl[0];
      const int w_out = p ? ph.w_out[1] : ph.w_out[0];
      const int nv = max(0, min(lc, wl - l0)) / V;
      // stage index of channel 0 of lane j + 1: base + step * j * C
      const int base = s + ((p ? ph.off[1] : ph.off[0]) - c_lo) * C;
      U* orow = (p ? ph.out[1] : ph.out[0]) + row * cp * wl + l0;
      for (int i = threadIdx.x; i < cp * nv; i += NT) {
        const int c = i / nv, v = i - c * nv;
        uint4 r = make_uint4(0, 0, 0, 0);
        const int j0 = l0 + v * V - 1;   // the vector's first column
        if (c < C && j0 < w_out) {
          U e[V];
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const int j = j0 + k;
            e[k] = (j >= 0 && j < w_out) ? stage[base + step * j * C + c]
                                         : U(0);
          }
          r = pack(e);
        }
        *reinterpret_cast<uint4*>(orow + (long long)c * wl + v * V) = r;
      }
    }
    __syncthreads();   // the stage is rewritten by the next unit
  }
}

// A warp of a tiled kernel owns WCB channel blocks x 32 / WCB lane
// blocks of one image row; lane t of the warp takes the tile (cb, m) =
// (t % WCB, t / WCB) of them. Each vector instruction of the warp then
// reads or writes 32 / WCB runs of WCB * 16 bytes on the channel side and
// WCB runs of 16 * 32 / WCB bytes on the lane side, whatever the row's
// channel count (a warp spread over 32 channel blocks would write 32
// channel rows 16 bytes each: half sectors). warp_tile gives the tile
// (cb, m) of warp tile wt, or false past the row's ncb x nlb tiles.
template <int WCB>
__device__ __forceinline__ bool warp_tile(int wt, int ncb, int nlb,
                                          int& cb, int& m) {
  const int gcb = (ncb + WCB - 1) / WCB, lane = threadIdx.x & 31;
  const int mg = wt / gcb;
  cb = (wt - mg * gcb) * WCB + lane % WCB;
  m = mg * (32 / WCB) + lane / WCB;
  return cb < ncb && m < nlb;
}

template <int WCB>
__device__ __forceinline__ int warp_tiles(int ncb, int nlb) {
  return (ncb + WCB - 1) / WCB * ((nlb + 32 / WCB - 1) / (32 / WCB));
}

// to_planar's warps: 4 channel blocks (its loads, 64-byte runs of a column)
// x 8 lane blocks (its stores, 128-byte runs of a channel row)
constexpr int TO_WCB = 4;
// from_planar's: 8 channel blocks (its stores, 128-byte runs of a column)
// x 4 lane blocks (its loads, 64-byte runs of a channel row)
constexpr int FROM_WCB = 8;

// one block walks image rows; a thread owns the tile of channels
// [cb V, cb V + V) x lanes [m V, m V + V). vec: x's base is 16-byte
// aligned and C * sizeof(U) a multiple of 16
template <typename U>
__global__ void __launch_bounds__(NT)
to_planar_tiled_kernel(const U* __restrict__ x, U* __restrict__ out, int W,
                       int C, int cp, int wl, int step, int offset,
                       int w_out, long long rows, bool vec) {
  constexpr int V = Vec<U>::V;
  const int ncb = (cp + V - 1) / V, nlb = wl / V;
  const int tiles = warp_tiles<TO_WCB>(ncb, nlb);
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const U* xr = x + row * W * C;
    U* orow = out + row * cp * wl;
    for (int wt = threadIdx.x / 32; wt < tiles; wt += NT / 32) {
      int cb, m;
      if (!warp_tile<TO_WCB>(wt, ncb, nlb, cb, m)) continue;
      const int c0 = cb * V;
      const int n = min(V, C - c0);   // real channels of the block
      uint4 a[V], t[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int j = m * V + k - 1;   // lane m V + k holds column j
        a[k] = make_uint4(0, 0, 0, 0);
        if (n > 0 && j >= 0 && j < w_out)
          a[k] = load_v(xr + (long long)(step * j + offset) * C + c0, n,
                        vec);
      }
      transpose(a, t);
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (c0 + e < cp)
          *reinterpret_cast<uint4*>(orow + (long long)(c0 + e) * wl +
                                    m * V) = t[e];
    }
  }
}

// a thread owns channels [cb V, cb V + V) x lanes [m V, m V + V) of the
// planar row: lane l goes to column l - 1. vec_in: xp's base and row
// pitch are 16-byte multiples; vec_out: c * sizeof(U) is one
template <typename U>
__global__ void __launch_bounds__(NT)
from_planar_tiled_kernel(const U* __restrict__ xp, U* __restrict__ out,
                         int cp, int wl, int w_img, int c, long long rows,
                         bool vec_in, bool vec_out) {
  constexpr int V = Vec<U>::V;
  const int ncb = (c + V - 1) / V, nlb = w_img / V + 1;
  const int tiles = warp_tiles<FROM_WCB>(ncb, nlb);
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const U* xr = xp + row * cp * wl;
    U* orow = out + row * w_img * c;
    for (int wt = threadIdx.x / 32; wt < tiles; wt += NT / 32) {
      int cb, m;
      if (!warp_tile<FROM_WCB>(wt, ncb, nlb, cb, m)) continue;
      const int c0 = cb * V;
      const int n = min(V, c - c0);
      const int nl = min(V, wl - m * V);   // lanes inside the row
      uint4 a[V], t[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        a[e] = make_uint4(0, 0, 0, 0);
        if (e < n) a[e] = load_v(xr + (long long)(c0 + e) * wl + m * V, nl,
                                 vec_in);
      }
      transpose(a, t);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int w = m * V + k - 1;
        if (w >= 0 && w < w_img)
          store_v(orow + (long long)w * c + c0, t[k], n, vec_out);
      }
    }
  }
}

// unit u = (image row, chunk of cw columns): scatter the planar vectors'
// image lanes into the stage in NHWC order, then write the chunk's NHWC
// run [w0 c, w1 c) back
template <typename U>
__global__ void __launch_bounds__(NT)
from_planar_narrow_kernel(const U* __restrict__ xp, U* __restrict__ out,
                          int cp, int wl, int w_img, int c, long long rows,
                          int cw, int nchunk, bool vec_in) {
  constexpr int V = Vec<U>::V;
  __shared__ __align__(16) U stage[STAGE_BYTES / sizeof(U)];
  const long long units = rows * nchunk;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long row = u / nchunk;
    const int w0 = (int)(u - row * nchunk) * cw;
    const int w1 = min(w0 + cw, w_img);
    U* dst = out + (row * w_img + w0) * c;
    const int s = stage_shift(dst);
    // lanes w0 + 1 .. w1 lie in the vectors vb0 .. vb1
    const int vb0 = (w0 + 1) / V, nvb = w1 / V - vb0 + 1;
    const U* xr = xp + row * cp * wl;
    for (int i = threadIdx.x; i < c * nvb; i += NT) {
      const int ch = i / nvb, vb = vb0 + (i - ch * nvb);
      U e[V];
      unpack(load_v(xr + (long long)ch * wl + vb * V, min(V, wl - vb * V),
                    vec_in), e);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int w = vb * V + k - 1;
        if (w >= w0 && w < w1) stage[s + (w - w0) * c + ch] = e[k];
      }
    }
    __syncthreads();
    stage_out(dst, stage, s, (w1 - w0) * c);
    __syncthreads();   // the stage is rewritten by the next unit
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

unsigned grid_of(long long units) {
  return (unsigned)(units < MAX_GRID ? units : MAX_GRID);
}

template <typename U>
int launch_to_planar_narrow(const void* x, Phases<U> ph, int nph, int B,
                            int H, int W, int C, int cp, int step,
                            cudaStream_t s) {
  constexpr int V = Vec<U>::V;
  // lanes a unit covers: its input columns (at most step * lc of them,
  // C elements each) fit the stage beside the alignment shift
  const int cap = STAGE_BYTES / (int)sizeof(U) - V;
  const int wl_max = nph == 2 ? max(ph.wl[0], ph.wl[1]) : ph.wl[0];
  int lc = cap / (step * C) / V * V;
  if (lc > wl_max) lc = wl_max;
  if (lc < V) return (int)cudaErrorInvalidValue;
  const int nchunk = (wl_max + lc - 1) / lc;
  const long long units = (long long)B * H * nchunk;
  if (units == 0) return (int)cudaGetLastError();
  to_planar_narrow_kernel<U><<<grid_of(units), NT, 0, s>>>(
      static_cast<const U*>(x), ph, nph, W, C, cp, step, (long long)B * H,
      lc, nchunk);
  return (int)cudaGetLastError();
}

template <typename U>
int launch_to_planar_tiled(const void* x, void* out, int B, int H, int W,
                           int C, int cp, int wl, int step, int offset,
                           int w_out, cudaStream_t s) {
  if (C < 1 || step < 1 || offset < 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H;
  if (rows == 0) return (int)cudaGetLastError();
  const bool vec = aligned16(x) && (C * sizeof(U)) % 16 == 0;
  to_planar_tiled_kernel<U><<<grid_of(rows), NT, 0, s>>>(
      static_cast<const U*>(x), static_cast<U*>(out), W, C, cp, wl, step,
      offset, w_out, rows, vec);
  return (int)cudaGetLastError();
}

template <typename U>
int launch_from_planar(const void* xp, void* out, int B, int H, int cp,
                       int wl, int w_img, int c, bool narrow,
                       cudaStream_t s) {
  constexpr int V = Vec<U>::V;
  const long long rows = (long long)B * H;
  if (rows == 0 || w_img == 0) return (int)cudaGetLastError();
  const bool vec_in = aligned16(xp) && (wl * sizeof(U)) % 16 == 0;
  if (!narrow) {
    from_planar_tiled_kernel<U><<<grid_of(rows), NT, 0, s>>>(
        static_cast<const U*>(xp), static_cast<U*>(out), cp, wl, w_img, c,
        rows, vec_in, (c * sizeof(U)) % 16 == 0);
    return (int)cudaGetLastError();
  }
  const int cap = STAGE_BYTES / (int)sizeof(U) - V;
  const int cw = min(cap / c, w_img);
  const int nchunk = (w_img + cw - 1) / cw;
  from_planar_narrow_kernel<U><<<grid_of(rows * nchunk), NT, 0, s>>>(
      static_cast<const U*>(xp), static_cast<U*>(out), cp, wl, w_img, c,
      rows, cw, nchunk, vec_in);
  return (int)cudaGetLastError();
}

template <typename U>
int to_planar_entry(const void* x, void* out0, void* out1, int B, int H,
                    int W, int C, int cp, int step, int wl0, int wl1,
                    int w_out0, int w_out1, int off0, int off1,
                    cudaStream_t s) {
  if (C < 1 || step < 1 || off0 < 0) return (int)cudaErrorInvalidValue;
  Phases<U> ph;
  ph.out[0] = static_cast<U*>(out0);
  ph.out[1] = static_cast<U*>(out1);
  ph.wl[0] = wl0; ph.wl[1] = wl1;
  ph.w_out[0] = w_out0; ph.w_out[1] = w_out1;
  ph.off[0] = off0; ph.off[1] = off1;
  return launch_to_planar_narrow<U>(x, ph, out1 ? 2 : 1, B, H, W, C, cp,
                                    step, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError(), or
// cudaErrorInvalidValue for a geometry the kernel does not take.

// K3a, narrow form (C < 32): one phase [B, H, cp, wl] of columns
// offset, offset + step, ...
extern "C" int apfp_to_planar(const void* x, void* out, int dtype, int B,
                              int H, int W, int C, int cp, int wl, int step,
                              int offset, int w_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return to_planar_entry<uint16_t>(x, out, nullptr, B, H, W, C, cp, step,
                                     wl, wl, w_out, w_out, offset, offset,
                                     s);
  return to_planar_entry<uint32_t>(x, out, nullptr, B, H, W, C, cp, step,
                                   wl, wl, w_out, w_out, offset, offset, s);
}

// K3a, narrow form, both column phases of step 2 (split_phases) from one
// read of x: out0 holds columns 0, 2, ... ([B, H, cp, wl0], w_out0 of
// them), out1 columns 1, 3, ... ([B, H, cp, wl1], w_out1)
extern "C" int apfp_to_planar_phases(const void* x, void* out0, void* out1,
                                     int dtype, int B, int H, int W, int C,
                                     int cp, int wl0, int wl1, int w_out0,
                                     int w_out1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return to_planar_entry<uint16_t>(x, out0, out1, B, H, W, C, cp, 2, wl0,
                                     wl1, w_out0, w_out1, 0, 1, s);
  return to_planar_entry<uint32_t>(x, out0, out1, B, H, W, C, cp, 2, wl0,
                                   wl1, w_out0, w_out1, 0, 1, s);
}

// K3a, tiled form (C >= 32): the same contract as apfp_to_planar
extern "C" int apfp_to_planar_tiled(const void* x, void* out, int dtype,
                                    int B, int H, int W, int C, int cp,
                                    int wl, int step, int offset, int w_out,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_to_planar_tiled<uint16_t>(x, out, B, H, W, C, cp, wl, step,
                                            offset, w_out, s);
  return launch_to_planar_tiled<uint32_t>(x, out, B, H, W, C, cp, wl, step,
                                          offset, w_out, s);
}

// K3b, tiled form (c >= 32): [B, H, cp, wl] -> [B, H, w_img, c]
extern "C" int apfp_from_planar(const void* xp, void* out, int dtype, int B,
                                int H, int cp, int wl, int w_img, int c,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_from_planar<uint16_t>(xp, out, B, H, cp, wl, w_img, c,
                                        false, s);
  return launch_from_planar<uint32_t>(xp, out, B, H, cp, wl, w_img, c,
                                      false, s);
}

// K3b, narrow form (c < 32): the same contract
extern "C" int apfp_from_planar_narrow(const void* xp, void* out, int dtype,
                                       int B, int H, int cp, int wl,
                                       int w_img, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_from_planar<uint16_t>(xp, out, B, H, cp, wl, w_img, c,
                                        true, s);
  return launch_from_planar<uint32_t>(xp, out, B, H, cp, wl, w_img, c, true,
                                      s);
}

// which: 0 narrow to_planar, 1 tiled to_planar, 2 narrow from_planar,
// 3 tiled from_planar. info[3] = registers, static shared bytes, blocks a
// multiprocessor at NT threads, for the dtype's instantiation
extern "C" int apfp_planar_info(int which, int dtype, int* info) {
  const void* fn = nullptr;
  if (dtype == 1) {
    const void* fns[4] = {
        (const void*)to_planar_narrow_kernel<uint16_t>,
        (const void*)to_planar_tiled_kernel<uint16_t>,
        (const void*)from_planar_narrow_kernel<uint16_t>,
        (const void*)from_planar_tiled_kernel<uint16_t>};
    fn = fns[which & 3];
  } else {
    const void* fns[4] = {
        (const void*)to_planar_narrow_kernel<uint32_t>,
        (const void*)to_planar_tiled_kernel<uint32_t>,
        (const void*)from_planar_narrow_kernel<uint32_t>,
        (const void*)from_planar_tiled_kernel<uint32_t>};
    fn = fns[which & 3];
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], fn,
                                                            NT, 0);
}
