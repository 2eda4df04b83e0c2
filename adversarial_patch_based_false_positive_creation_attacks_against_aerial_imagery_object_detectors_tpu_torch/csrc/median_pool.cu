// k x k median filter (K7): a selection network held in registers for
// k <= 8, rank counting for k >= 9.
//
// Replaces the JAX package's Pallas kernel experimental/median_pallas.py
// median_pool_2d_pallas (body _median_kernel). For x [C, H, W] (any leading
// dims flattened into C) and each output pixel, the window is the k x k
// block of x under "same" reflect padding (pt rows on top, pl columns on the
// left), and the output is the window element whose rank satisfies
// count_less <= (n-1)/2 < count_less + count_eq, n = k^2: the lower median,
// ties included, in float32. Where no element qualifies (only with NaNs in
// the window) the output is -inf. Of several qualifying elements (equal
// values, +0 and -0 among them) the last in window order wins, as in the
// Pallas kernel, so the result equals it bit for bit: it is one of the
// inputs, cast back to x's dtype.
//
// What bounds it on the H100: operations. The bound counts this network's
// work (median_net.cuh), not the least work of the function, which a
// network sharing sorted columns between neighbouring windows would cut:
// at k = 7, 319 live comparators an output, of which the median reads both
// halves of 271 and one of 48, so 590 FP32-pipe min/max instructions; at
// the EOT smoother's [3, 224, 224] that is 8.9e7 lane instructions, ~2.65
// us at one instruction a lane a cycle (132 SMs x 128 lanes x ~1.98 GHz,
// the 67 TFLOP/s f32 rate over 2), against 0.36 us for the bytes (1.2 MB
// read and written once). Rank counting, the Pallas kernel's algorithm,
// does 2 n^2 = 4,802 compares an output instead, 8.1 times the network.
//
// Network form (k = 1..8, a template on K), what it does about that bound:
// only the network's min/max instructions run per window value beyond one
// shared-memory load. A block of 128 threads owns a 4-row x 32-column
// output tile of one channel, so a warp reads and writes one row of 32
// consecutive pixels: conflict-free shared loads, 128-byte stores. The block
// stages the (4 + K - 1) x (32 + K - 1) input tile in shared memory as
// float32, reflecting the indices at load time (no padded copy in device
// memory), each NaN stored as +inf and flagged in a byte beside it. Each
// thread reads its n window values into a register array once and runs
// median_net<K>::run on it: every index is a literal, so the array never
// goes to local memory, and a comparator computes only the halves that
// the median reads. The staged tile settles two rare cases afterwards, so
// that the result is the rank counter's bit for bit:
// - the network gives +inf. With m NaNs in the window (each +inf in the
//   network), the rank counter ranks the n - m others and finds no element
//   when m >= n - (n - 1) / 2: then the output is -inf, else a real +inf.
//   (Fewer NaNs sit above rank (n - 1) / 2 and leave the value as it is;
//   more make it +inf, so m is counted only then.)
// - the network gives 0. The rank counter keeps the last of the equal
//   elements in window order, so one pass over the window keeps the last
//   u == 0 and tells -0 from +0. Equal floats other than zeros have equal
//   bits, so the pass runs only for a zero.
// k = 1 is the copy with NaN -> -inf; for an even k, n is a power of two.
//
// The tile: 4 x 32 outputs, so that a warp's loads and stores cover whole
// rows of 32 pixels, and a block of 128 threads small enough that several
// fit an SM beside the ~72 registers a thread of k = 7 holds (chip_smoke.py
// phase 1 prints each instantiation's registers, spills and blocks an SM,
// and the FMNMX count of its SASS beside the table's minmax).
//
// Rank-counting form (k >= 9, k a runtime argument): one thread per pixel
// of a 16 x 16 tile staged the same way (NaNs kept), each of the n
// candidates ranked against the whole window in shared memory, the last
// qualifying one kept; -inf where none qualifies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "median_net.cuh"

namespace {

constexpr int NR = 4, NC = 32;  // network form: output tile rows, columns
constexpr int NT = NR * NC;     // its threads a block
constexpr int TS = 16;          // rank form: output tile side, TS^2 threads

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);  // exact: v is one of the bf16 inputs
}

// reflect padding's index into [0, n) (valid for -n < i < 2n - 1); clamped
// for the halo of tiles past the image, whose outputs are not written
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * (n - 1) - i : i;
  return min(max(i, 0), n - 1);
}

template <typename T, int K>
__global__ void __launch_bounds__(NT)
    median_net_kernel(const T* __restrict__ x, T* __restrict__ out, int C,
                      int H, int W, int pt, int pl) {
  using Net = median_net<K>;
  constexpr int SH = NR + K - 1, SW = NC + K - 1;
  __shared__ float tile[SH * SW];
  __shared__ unsigned char nan_at[SH * SW];
  const int r0 = blockIdx.y * NR, c0 = blockIdx.x * NC;
  const int ty = threadIdx.x / NC, tx = threadIdx.x % NC;
  for (int c = blockIdx.z; c < C; c += gridDim.z) {
    const T* xc = x + (long long)c * H * W;
    for (int idx = threadIdx.x; idx < SH * SW; idx += NT) {
      const int gr = reflect(r0 - pt + idx / SW, H);
      const int gc = reflect(c0 - pl + idx % SW, W);
      const float u = to_f(xc[(long long)gr * W + gc]);
      const bool is_nan = u != u;
      tile[idx] = is_nan ? INFINITY : u;
      nan_at[idx] = is_nan;
    }
    __syncthreads();
    const int oy = r0 + ty, ox = c0 + tx;
    if (oy < H && ox < W) {
      const int at = ty * SW + tx;
      float v[Net::n];
#pragma unroll
      for (int di = 0; di < K; ++di) {
#pragma unroll
        for (int dj = 0; dj < K; ++dj)
          v[di * K + dj] = tile[at + di * SW + dj];
      }
      Net::run(v);
      float med = v[Net::out];
      if (med == INFINITY) {
        int m = 0;
#pragma unroll 1
        for (int di = 0; di < K; ++di) {
          for (int dj = 0; dj < K; ++dj) m += nan_at[at + di * SW + dj];
        }
        if (m >= Net::n - (Net::n - 1) / 2) med = -INFINITY;
      } else if (med == 0.f) {
#pragma unroll 1
        for (int di = 0; di < K; ++di) {
          for (int dj = 0; dj < K; ++dj) {
            const float u = tile[at + di * SW + dj];
            if (u == 0.f) med = u;
          }
        }
      }
      store(out + (long long)c * H * W + (long long)oy * W + ox, med);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(TS* TS)
    median_rank_kernel(const T* __restrict__ x, T* __restrict__ out, int C,
                       int H, int W, int k, int pt, int pl) {
  extern __shared__ float stage[];  // [TS + k - 1][TS + k - 1]
  const int SW = TS + k - 1;
  const int r0 = blockIdx.y * TS, c0 = blockIdx.x * TS;
  const int ty = threadIdx.x / TS, tx = threadIdx.x % TS;
  const int n = k * k, mid = (n - 1) / 2;
  for (int c = blockIdx.z; c < C; c += gridDim.z) {
    const T* xc = x + (long long)c * H * W;
    for (int idx = threadIdx.x; idx < SW * SW; idx += TS * TS) {
      const int gr = reflect(r0 - pt + idx / SW, H);
      const int gc = reflect(c0 - pl + idx % SW, W);
      stage[idx] = to_f(xc[(long long)gr * W + gc]);
    }
    __syncthreads();
    const int oy = r0 + ty, ox = c0 + tx;
    if (oy < H && ox < W) {
      const float* win = stage + ty * SW + tx;
      float med = -INFINITY;
      for (int di = 0; di < k; ++di) {
        for (int dj = 0; dj < k; ++dj) {
          const float v = win[di * SW + dj];
          int less = 0, eq = 0;
          for (int ei = 0; ei < k; ++ei) {
            const float* row = win + ei * SW;
            for (int ej = 0; ej < k; ++ej) {
              const float u = row[ej];
              less += u < v;
              eq += u == v;
            }
          }
          if (less <= mid && less + eq > mid) med = v;
        }
      }
      store(out + (long long)c * H * W + (long long)oy * W + ox, med);
    }
    __syncthreads();
  }
}

dim3 grid_of(int C, int H, int W, int rows, int cols) {
  return dim3((W + cols - 1) / cols, (H + rows - 1) / rows,
              C < 65535 ? C : 65535);
}

template <typename T>
using net_fn = void (*)(const T*, T*, int, int, int, int, int);

// the network form's instantiations, k = 1..8 at [k - 1]
template <typename T>
net_fn<T> net_kernel(int k) {
  static const net_fn<T> at[] = {
      median_net_kernel<T, 1>, median_net_kernel<T, 2>,
      median_net_kernel<T, 3>, median_net_kernel<T, 4>,
      median_net_kernel<T, 5>, median_net_kernel<T, 6>,
      median_net_kernel<T, 7>, median_net_kernel<T, 8>};
  return at[k - 1];
}

constexpr int NET_MAX_K = 8;

size_t rank_smem(int k) {
  return sizeof(float) * (size_t)(TS + k - 1) * (TS + k - 1);
}

// the kernel that k selects: the network's instantiation for k <= 8, the
// rank counter otherwise
template <typename T>
const void* kernel_of(int k) {
  return k <= NET_MAX_K ? (const void*)net_kernel<T>(k)
                        : (const void*)median_rank_kernel<T>;
}

template <typename T>
int launch(const void* x, void* out, int C, int H, int W, int k, int pt,
           int pl, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (k <= NET_MAX_K) {
    net_kernel<T>(k)<<<grid_of(C, H, W, NR, NC), NT, 0, s>>>(xt, ot, C, H, W,
                                                            pt, pl);
    return (int)cudaGetLastError();
  }
  const size_t smem = rank_smem(k);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        median_rank_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  median_rank_kernel<T><<<grid_of(C, H, W, TS, TS), TS * TS, smem, s>>>(
      xt, ot, C, H, W, k, pt, pl);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out; the compute is float32).
// x, out [C, H, W] contiguous; pt, pl the reflect padding above and to the
// left (below and to the right it is k - 1 - pt, k - 1 - pl); H and W must
// exceed both. k <= 8 runs the network form, k >= 9 the rank counter.
// Returns cudaGetLastError().
extern "C" int apfp_median_pool(const void* x, void* out, int dtype, int C,
                                int H, int W, int k, int pt, int pl,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, out, C, H, W, k, pt, pl, s);
  return launch<float>(x, out, C, H, W, k, pt, pl, s);
}

// The kernel that k and dtype select: info[0] its registers a thread,
// info[1] its shared memory a block (static for the network form, dynamic
// for the rank form), info[2] the blocks a multiprocessor can hold.
extern "C" int apfp_median_pool_info(int k, int dtype, int* info) {
  const void* fn =
      dtype == 1 ? kernel_of<__nv_bfloat16>(k) : kernel_of<float>(k);
  const bool net = k <= NET_MAX_K;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  const size_t dyn = net ? 0 : rank_smem(k);
  info[0] = attr.numRegs;
  info[1] = net ? (int)attr.sharedSizeBytes : (int)dyn;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[2], fn, net ? NT : TS * TS, dyn);
}
