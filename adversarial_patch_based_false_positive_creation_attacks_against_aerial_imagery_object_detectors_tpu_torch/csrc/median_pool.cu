// k x k median filter by rank counting (K7).
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
// Design: one thread per output pixel, a 16 x 16 block of them. The block
// stages the (16 + k - 1)^2 input tile of one channel in shared memory as
// float32, reflecting the indices at load time (no padded copy in device
// memory), then each thread counts, for each of its n candidates, how many
// window elements are less and how many equal: 2 n^2 compares a pixel, in
// registers, read from shared memory. k is a runtime argument.
//
// What bounds it on the H100: bytes, the input read once and the output
// written once (1.2 MB for the EOT smoother's [3, 224, 224] float32 at
// k = 7: 0.36 us, below a launch). The n^2 compares (7.2e8 there) are the
// real cost; a selection network (the JAX package's shipped forward) needs
// far fewer, and is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TS = 16;  // output tile side; TS x TS threads a block

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

template <typename T>
__global__ void __launch_bounds__(TS* TS)
    median_pool_kernel(const T* __restrict__ x, T* __restrict__ out, int C,
                       int H, int W, int k, int pt, int pl) {
  extern __shared__ float tile[];  // [TS + k - 1][TS + k - 1]
  const int SW = TS + k - 1;
  const int r0 = blockIdx.y * TS, c0 = blockIdx.x * TS;
  const int ty = threadIdx.x / TS, tx = threadIdx.x % TS;
  const int n = k * k, mid = (n - 1) / 2;
  for (int c = blockIdx.z; c < C; c += gridDim.z) {
    const T* xc = x + (long long)c * H * W;
    for (int idx = threadIdx.x; idx < SW * SW; idx += TS * TS) {
      const int gr = reflect(r0 - pt + idx / SW, H);
      const int gc = reflect(c0 - pl + idx % SW, W);
      tile[idx] = to_f(xc[(long long)gr * W + gc]);
    }
    __syncthreads();
    const int oy = r0 + ty, ox = c0 + tx;
    if (oy < H && ox < W) {
      const float* win = tile + ty * SW + tx;
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

template <typename T>
int launch(const void* x, void* out, int C, int H, int W, int k, int pt,
           int pl, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)(TS + k - 1) * (TS + k - 1);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        median_pool_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((W + TS - 1) / TS, (H + TS - 1) / TS, C < 65535 ? C : 65535);
  median_pool_kernel<T><<<grid, TS * TS, smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), C, H, W, k, pt, pl);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out; the compute is float32).
// x, out [C, H, W] contiguous; pt, pl the reflect padding above and to the
// left (below and to the right it is k - 1 - pt, k - 1 - pl); H and W must
// exceed both. Returns cudaGetLastError().
extern "C" int apfp_median_pool(const void* x, void* out, int dtype, int C,
                                int H, int W, int k, int pt, int pl,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, out, C, H, W, k, pt, pl, s);
  return launch<float>(x, out, C, H, W, k, pt, pl, s);
}
