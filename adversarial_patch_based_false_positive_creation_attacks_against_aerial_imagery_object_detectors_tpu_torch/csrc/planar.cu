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
// Both kernels move raw bits (uint16_t for bfloat16, uint32_t for
// float32), so they are exact for either dtype.
//
// to_planar: one thread per output element, lanes fastest, so a warp
// writes 32 neighbouring lanes and every border and padding lane is
// written explicitly. Its reads stride by C elements, which is harmless
// for the stem's 3-channel input but uncoalesced for a wide tensor (the
// 128-channel cotangent g5 of the stem's backward: a warp touches 32
// sectors for 64 bytes), so C >= 32 takes to_planar_tiled: a 32x32
// shared-memory tile transpose per image row, channel-major read and
// lane-major write both coalesced, border, padding lanes and channels
// past C written as zero by the same tiles. from_planar is the mirror
// transpose.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename U>
__global__ void to_planar_kernel(const U* __restrict__ x, U* __restrict__ out,
                                 int W, int C, int cp, int wl, int step,
                                 int offset, int w_out, long long total) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int l = (int)(idx % wl);
  long long r = idx / wl;
  const int c = (int)(r % cp);
  r /= cp;  // b * H + h
  const int j = l - 1;
  U v = 0;
  if (c < C && j >= 0 && j < w_out) {
    const int w = step * j + offset;
    v = x[(r * W + w) * C + c];
  }
  out[idx] = v;
}

// grid (ceil(wl/32), ceil(cp/32), rows), block (32, 8): the tile of lanes
// [l0, l0+32) x channels [c0, c0+32) of one planar row
template <typename U>
__global__ void to_planar_tiled_kernel(const U* __restrict__ x,
                                       U* __restrict__ out, int W, int C,
                                       int cp, int wl, int step, int offset,
                                       int w_out) {
  __shared__ U tile[32][33];
  const long long row = blockIdx.z;  // b * H + h
  const int l0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int k = ty; k < 32; k += 8) {
    const int j = l0 + k - 1, cc = c0 + tx;
    U v = 0;
    if (cc < C && j >= 0 && j < w_out)
      v = x[(row * W + step * j + offset) * C + cc];
    tile[k][tx] = v;
  }
  __syncthreads();
  for (int k = ty; k < 32; k += 8) {
    const int cc = c0 + k, l = l0 + tx;
    if (cc < cp && l < wl) out[(row * cp + cc) * wl + l] = tile[tx][k];
  }
}

template <typename U>
__global__ void from_planar_kernel(const U* __restrict__ xp,
                                   U* __restrict__ out, int cp, int wl,
                                   int w_img, int c) {
  __shared__ U tile[32][33];
  const long long row = blockIdx.z;  // b * H + h
  const int w0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int k = ty; k < 32; k += 8) {
    const int cc = c0 + k, w = w0 + tx;
    if (cc < c && w < w_img) tile[k][tx] = xp[(row * cp + cc) * wl + w + 1];
  }
  __syncthreads();
  for (int k = ty; k < 32; k += 8) {
    const int w = w0 + k, cc = c0 + tx;
    if (cc < c && w < w_img) out[(row * w_img + w) * c + cc] = tile[tx][k];
  }
}

template <typename U>
int launch_to_planar(const void* x, void* out, int B, int H, int W, int C,
                     int cp, int wl, int step, int offset, int w_out,
                     cudaStream_t s) {
  const long long total = (long long)B * H * cp * wl;
  const int nt = 256;
  const long long nb = (total + nt - 1) / nt;
  to_planar_kernel<U><<<(unsigned)nb, nt, 0, s>>>(
      static_cast<const U*>(x), static_cast<U*>(out), W, C, cp, wl, step,
      offset, w_out, total);
  return (int)cudaGetLastError();
}

template <typename U>
int launch_to_planar_tiled(const void* x, void* out, int B, int H, int W,
                           int C, int cp, int wl, int step, int offset,
                           int w_out, cudaStream_t s) {
  // the grid's z limit is 65535 rows: a larger batch is launched in
  // slices of rows, each on its own offset of x and out (a row loop inside
  // the kernel ran slower at the g5 shape)
  const long long rows = (long long)B * H;
  for (long long r0 = 0; r0 < rows; r0 += 65535) {
    const long long n = rows - r0 < 65535 ? rows - r0 : 65535;
    dim3 grid((wl + 31) / 32, (cp + 31) / 32, (unsigned)n);
    dim3 block(32, 8);
    to_planar_tiled_kernel<U><<<grid, block, 0, s>>>(
        static_cast<const U*>(x) + r0 * W * C,
        static_cast<U*>(out) + r0 * cp * wl, W, C, cp, wl, step, offset,
        w_out);
  }
  return (int)cudaGetLastError();
}

template <typename U>
int launch_from_planar(const void* xp, void* out, int B, int H, int cp,
                       int wl, int w_img, int c, cudaStream_t s) {
  dim3 grid((w_img + 31) / 32, (c + 31) / 32, B * H);
  dim3 block(32, 8);
  from_planar_kernel<U><<<grid, block, 0, s>>>(
      static_cast<const U*>(xp), static_cast<U*>(out), cp, wl, w_img, c);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int apfp_to_planar(const void* x, void* out, int dtype, int B,
                              int H, int W, int C, int cp, int wl, int step,
                              int offset, int w_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_to_planar<uint16_t>(x, out, B, H, W, C, cp, wl, step,
                                      offset, w_out, s);
  return launch_to_planar<uint32_t>(x, out, B, H, W, C, cp, wl, step, offset,
                                    w_out, s);
}

// the same contract as apfp_to_planar, as the tiled transpose (C >= 32)
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

extern "C" int apfp_from_planar(const void* xp, void* out, int dtype, int B,
                                int H, int cp, int wl, int w_img, int c,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_from_planar<uint16_t>(xp, out, B, H, cp, wl, w_img, c, s);
  return launch_from_planar<uint32_t>(xp, out, B, H, cp, wl, w_img, c, s);
}
