// The two kernels of the Mosaic lowering probes, on (R, W, C) tensors with C
// innermost and contiguous:
//
//   strided gather  out[r, w, c] = x[r * sr, w * sw, c],  (sr, sw) in
//                   {(2, 1), (1, 2), (2, 2)}, float32 or bfloat16;
//   halo add        out[r, w, c] = xp[r, w, c] + xp[r + 2, w + 2, c], where
//                   xp is x with a one-pixel zero border (xp[i, j] =
//                   x[i - 1, j - 1] inside, 0 outside), float32 or bfloat16
//                   (summed in f32, rounded once).
//
// Replaces: scripts/probe_mosaic.py::try_probe (the f32 bodies k_rowstride,
//   k_substride, k_subreshape, k_rowreshape: the two reshape-splits select
//   the same elements as the strided slices), ::bf16_probe (the same in
//   bf16, and the both-strided slice) and k_halo (the zero-padded VMEM
//   scratch and its shifted sum).
//
// What bounds them on an H100: bytes.  The gather reads the selected
// elements once and writes them once, the halo add reads x once and writes
// out once; at the probes' (16, 64, 128) the data (256-512 KB) moves in well
// under a microsecond and the launch itself is the cost.
//
// What the design does about it -- a simple, correct version: the gather
// gives each thread one 16-byte vector of one output pixel's channels (C
// elements are contiguous in both tensors, so a pixel is a run of C *
// sizeof(T) bytes; element by element when that run or a pointer is not
// 16-byte aligned), consecutive threads on consecutive addresses.  The
// halo add gives each CTA a tile of 4 rows x 16 columns x 32 channels: it
// stages the tile's input with its one-pixel border into shared memory,
// zero where the border falls outside x (the counterpart of the probe's
// zeroed VMEM scratch), then each thread writes the shifted sums of its
// outputs from shared memory.
//
// Built by plain nvcc into a shared library with a C interface (no PyTorch
// headers); bound with ctypes by ops/cuda/build.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileR = 4;     // halo tile: output rows
constexpr int kTileW = 16;    //            output columns
constexpr int kTileC = 32;    //            channels

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// V: the unit one thread copies (uint4 = 16 bytes, or one element);
// per_pixel: units in one pixel's run of channels.
template <typename V, int SR, int SW>
__global__ void __launch_bounds__(kThreads)
    strided_gather_kernel(const V* __restrict__ x, V* __restrict__ out, int w, int ro, int wo,
                          int per_pixel) {
  const long long total = (long long)ro * wo * per_pixel;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    const int v = (int)(i % per_pixel);
    const long long pix = i / per_pixel;
    const int col = (int)(pix % wo);
    const int row = (int)(pix / wo);
    out[i] = x[((long long)row * SR * w + (long long)col * SW) * per_pixel + v];
  }
}

template <typename V>
cudaError_t launch_gather(const void* x, void* out, int w, int ro, int wo, int per_pixel,
                          int sr, int sw, cudaStream_t s) {
  const long long total = (long long)ro * wo * per_pixel;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  if (blocks < 1) blocks = 1;
  const V* xi = static_cast<const V*>(x);
  V* o = static_cast<V*>(out);
  const unsigned g = (unsigned)blocks;
  if (sr == 2 && sw == 1)
    strided_gather_kernel<V, 2, 1><<<g, kThreads, 0, s>>>(xi, o, w, ro, wo, per_pixel);
  else if (sr == 1 && sw == 2)
    strided_gather_kernel<V, 1, 2><<<g, kThreads, 0, s>>>(xi, o, w, ro, wo, per_pixel);
  else
    strided_gather_kernel<V, 2, 2><<<g, kThreads, 0, s>>>(xi, o, w, ro, wo, per_pixel);
  return cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    halo_add_kernel(const T* __restrict__ x, T* __restrict__ out, int r, int w, int c) {
  // tile[i][j][k] = xp[r0 + i, w0 + j, c0 + k] = x[r0 + i - 1, w0 + j - 1, c0 + k]
  __shared__ float tile[kTileR + 2][kTileW + 2][kTileC];
  const int c0 = blockIdx.x * kTileC;
  const int w0 = blockIdx.y * kTileW;
  const int r0 = blockIdx.z * kTileR;
  constexpr int kStaged = (kTileR + 2) * (kTileW + 2) * kTileC;
  for (int i = threadIdx.x; i < kStaged; i += kThreads) {
    const int k = i % kTileC;
    const int j = (i / kTileC) % (kTileW + 2);
    const int t = i / (kTileC * (kTileW + 2));
    const int xr = r0 + t - 1, xc = w0 + j - 1, ch = c0 + k;
    float v = 0.f;
    if (xr >= 0 && xr < r && xc >= 0 && xc < w && ch < c)
      v = to_f32(x[((long long)xr * w + xc) * c + ch]);
    tile[t][j][k] = v;
  }
  __syncthreads();
  constexpr int kOut = kTileR * kTileW * kTileC;
  for (int i = threadIdx.x; i < kOut; i += kThreads) {
    const int k = i % kTileC;
    const int j = (i / kTileC) % kTileW;
    const int t = i / (kTileC * kTileW);
    const int orow = r0 + t, ocol = w0 + j, ch = c0 + k;
    if (orow < r && ocol < w && ch < c)
      out[((long long)orow * w + ocol) * c + ch] = from_f32<T>(tile[t][j][k] + tile[t + 2][j + 2][k]);
  }
}

}  // namespace

extern "C" {

// x: (r, w, c), out: (ceil(r / sr), ceil(w / sw), c), both contiguous, float32
// (dtype 0) or bfloat16 (dtype 1); (sr, sw) one of (2, 1), (1, 2), (2, 2).
// Returns a cudaError_t (0 = launched).
int bugcar_strided_gather(const void* x, void* out, int r, int w, int c, int sr, int sw,
                          int dtype, void* stream) {
  const bool ok_stride = (sr == 2 && sw == 1) || (sr == 1 && sw == 2) || (sr == 2 && sw == 2);
  if (r < 1 || w < 1 || c < 1 || !ok_stride || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int ro = (r + sr - 1) / sr, wo = (w + sw - 1) / sw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int item = dtype == 0 ? 4 : 2;
  const long long run = (long long)c * item;   // bytes of one pixel's channels
  const bool vec = run % 16 == 0 && ((uintptr_t)x | (uintptr_t)out) % 16 == 0;
  if (vec) return (int)launch_gather<uint4>(x, out, w, ro, wo, (int)(run / 16), sr, sw, s);
  if (dtype == 0) return (int)launch_gather<float>(x, out, w, ro, wo, c, sr, sw, s);
  return (int)launch_gather<__nv_bfloat16>(x, out, w, ro, wo, c, sr, sw, s);
}

// x, out: (r, w, c) contiguous, float32 (dtype 0) or bfloat16 (dtype 1).
// Returns a cudaError_t (0 = launched).
int bugcar_halo_add(const void* x, void* out, int r, int w, int c, int dtype, void* stream) {
  if (r < 1 || w < 1 || c < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const long long gr = (r + kTileR - 1) / kTileR, gw = (w + kTileW - 1) / kTileW;
  if (gr > 65535 || gw > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((c + kTileC - 1) / kTileC), (unsigned)gw, (unsigned)gr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    halo_add_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x),
                                                     static_cast<float*>(out), r, w, c);
  else
    halo_add_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), r, w, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
