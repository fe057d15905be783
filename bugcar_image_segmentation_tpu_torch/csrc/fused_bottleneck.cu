// One whole ENet trunk bottleneck (inference) as one CUDA kernel for Hopper.
//
// Replaces: bugcar_image_segmentation_tpu/ops/pallas/bottleneck.py,
//   fused_bottleneck (kernels _regular_kernel and _asym_kernel).
//
// What it computes, per image (NHWC, C = 128 channels, mid = 32):
//   y1  = PReLU(BN(x @ wp))                        1x1 projection, rounded to
//                                                   the activation type
//   acc = core(y1)   regular/dilated: 3x3, dilation d, over a zero-padded y1
//                    asymmetric: z = 5x1(y1) rounded to the activation type,
//                                then 1x5(z)
//   y2  = PReLU(BN(acc))                           rounded to the activation type
//   out = PReLU(BN(y2 @ we) + x)                   f32 until the final store
// Taps that fall outside the image read 0 from the padded y1 (not proj(0)),
// as the TPU kernel's zero-padded scratch does.  Matmul operands are the
// activation type (bf16 or f32), accumulation is f32, folded BatchNorm
// vectors and PReLU slopes are f32.
//
// What bounds it on an H100: at the main path's shape (1x32x64x128 bf16, 16
// launches per frame) one launch must move ~1 MB (x in, out back) and do
// ~71 MFLOP; that is ~0.3 us at 3.35 TB/s and ~0.07 us at the bf16 tensor
// rate, so bytes bound it on paper, and in practice the fixed cost of a
// launch and the latency of a few dependent phases over a small grid.
//
// What the design does about it: one CTA per (output row, image) keeps the
// whole block in shared memory -- the weights (~72 KB as f32), the y1 rows
// the core taps read (3 rows for the dilated 3x3, whatever d is, and 5 rows
// for the 5x1), the 5x1 result and y2 -- so x is read and out written once
// and nothing in between touches device memory.  The projection of a y1
// row is recomputed by each CTA that needs it (3x or 5x) instead of being
// exchanged, which trades FLOPs the card has in excess for a single
// launch.  The products are plain f32 FMA loops; tensor-core mma and TMA
// are later work.
//
// Built by plain nvcc into a shared library with a C interface (no PyTorch
// headers); bound with ctypes by ops/cuda/build.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kC = 128;       // block width (input = output channels)
constexpr int kMid = 32;      // projected width
constexpr int kThreads = 256;
constexpr int kPxPerThread1 = 8;    // pixels per thread in the mid-wide phases
constexpr int kPxPerThread3 = 16;   // pixels per thread in the expansion

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an f32 value to the activation type and back.
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float prelu(float v, float a) {
  return v >= 0.f ? v : a * v;
}

// Shared-memory layout, in floats; the same function sizes the launch.
struct Smem {
  int wp, wc, we, vec, xrow, y1, z, y2, total;
};

__host__ __device__ inline Smem smem_layout(bool asym, int w) {
  const int taps = asym ? 10 : 9;   // 3x3, or 5x1 then 1x5
  const int rows = asym ? 5 : 3;    // y1 rows the core reads
  Smem s;
  s.wp = 0;
  s.wc = s.wp + kC * kMid;
  s.we = s.wc + taps * kMid * kMid;
  s.vec = s.we + kMid * kC;
  s.xrow = s.vec + 6 * kMid + 3 * kC;
  s.y1 = s.xrow + w * kC;
  s.z = s.y1 + rows * w * kMid;
  s.y2 = s.z + w * kMid;
  s.total = s.y2 + w * kMid;
  return s;
}

template <typename T, bool kAsym>
__global__ void __launch_bounds__(kThreads)
fused_bottleneck_kernel(const T* __restrict__ x, T* __restrict__ out,
                        int h, int w, int dil,
                        const float* __restrict__ wp, const float* __restrict__ s1,
                        const float* __restrict__ b1, const float* __restrict__ a1,
                        const float* __restrict__ wcore, const float* __restrict__ s2,
                        const float* __restrict__ b2, const float* __restrict__ a2,
                        const float* __restrict__ we, const float* __restrict__ s3,
                        const float* __restrict__ b3, const float* __restrict__ ao) {
  constexpr int kTaps = kAsym ? 10 : 9;
  constexpr int kRows = kAsym ? 5 : 3;
  extern __shared__ float smem[];
  const Smem L = smem_layout(kAsym, w);
  float* wp_s = smem + L.wp;      // [c][m]
  float* wc_s = smem + L.wc;      // [tap][i][o]
  float* we_s = smem + L.we;      // [m][c]
  float* s1_s = smem + L.vec;
  float* b1_s = s1_s + kMid;
  float* a1_s = b1_s + kMid;
  float* s2_s = a1_s + kMid;
  float* b2_s = s2_s + kMid;
  float* a2_s = b2_s + kMid;
  float* s3_s = a2_s + kMid;
  float* b3_s = s3_s + kC;
  float* ao_s = b3_s + kC;
  float* xrow_s = smem + L.xrow;  // [px][c], one input row
  float* y1_s = smem + L.y1;      // [row][px][m]
  float* z_s = smem + L.z;        // [px][m], the 5x1 result
  float* y2_s = smem + L.y2;      // [px][m]

  const int tid = threadIdx.x;
  const int r = blockIdx.x;       // output row
  const int n = blockIdx.y;       // image
  const T* xn = x + (size_t)n * h * w * kC;

  // Weights in the matmul operand type (the TPU kernel casts them to the
  // activation dtype); BN vectors and slopes stay f32.
  for (int i = tid; i < kC * kMid; i += kThreads) wp_s[i] = round_t<T>(wp[i]);
  for (int i = tid; i < kTaps * kMid * kMid; i += kThreads) wc_s[i] = round_t<T>(wcore[i]);
  for (int i = tid; i < kMid * kC; i += kThreads) we_s[i] = round_t<T>(we[i]);
  for (int i = tid; i < kMid; i += kThreads) {
    s1_s[i] = s1[i]; b1_s[i] = b1[i]; a1_s[i] = a1[i];
    s2_s[i] = s2[i]; b2_s[i] = b2[i]; a2_s[i] = a2[i];
  }
  for (int i = tid; i < kC; i += kThreads) {
    s3_s[i] = s3[i]; b3_s[i] = b3[i]; ao_s[i] = ao[i];
  }

  // Mid-wide phases: a warp owns one pixel group, its lanes the 32 mid
  // channels, so weight reads are consecutive and activation reads are
  // broadcasts.
  const int m = tid % kMid;
  const int pg = tid / kMid;
  constexpr int kGroups = kThreads / kMid;
  constexpr int kChunk1 = kGroups * kPxPerThread1;
  const int step = kAsym ? 1 : dil;
  const int center = kRows / 2;

  // Phase 1: y1 for the rows the core reads.  Rows outside the image are
  // the zero padding.
  bool row_ok[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int yr = r + (k - center) * step;
    row_ok[k] = yr >= 0 && yr < h;
    float* y1row = y1_s + k * w * kMid;
    __syncthreads();  // xrow_s (and, first time, the weights) are ready / free
    if (!row_ok[k]) {
      for (int i = tid; i < w * kMid; i += kThreads) y1row[i] = 0.f;
      continue;
    }
    const T* xr = xn + (size_t)yr * w * kC;
    for (int i = tid; i < w * kC; i += kThreads) xrow_s[i] = to_f<T>(xr[i]);
    __syncthreads();
    for (int base = 0; base < w; base += kChunk1) {
      float acc[kPxPerThread1];
      int pxc[kPxPerThread1];
#pragma unroll
      for (int j = 0; j < kPxPerThread1; ++j) {
        acc[j] = 0.f;
        pxc[j] = min(base + pg + j * kGroups, w - 1) * kC;
      }
      for (int c = 0; c < kC; ++c) {
        const float wv = wp_s[c * kMid + m];
#pragma unroll
        for (int j = 0; j < kPxPerThread1; ++j) acc[j] = fmaf(xrow_s[pxc[j] + c], wv, acc[j]);
      }
#pragma unroll
      for (int j = 0; j < kPxPerThread1; ++j) {
        const int px = base + pg + j * kGroups;
        if (px < w) {
          y1row[px * kMid + m] =
              round_t<T>(prelu(acc[j] * s1_s[m] + b1_s[m], a1_s[m]));
        }
      }
    }
  }
  __syncthreads();

  // Phase 2: the core conv and its BN + PReLU into y2.
  if (!kAsym) {
    for (int base = 0; base < w; base += kChunk1) {
      float acc[kPxPerThread1];
#pragma unroll
      for (int j = 0; j < kPxPerThread1; ++j) acc[j] = 0.f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        if (!row_ok[ky]) continue;
        const float* y1row = y1_s + ky * w * kMid;
        for (int kx = 0; kx < 3; ++kx) {
          const int off = (kx - 1) * dil;
          const float* wt = wc_s + (ky * 3 + kx) * kMid * kMid;
          int src[kPxPerThread1];
          float keep[kPxPerThread1];
#pragma unroll
          for (int j = 0; j < kPxPerThread1; ++j) {
            const int sx = base + pg + j * kGroups + off;
            keep[j] = (sx >= 0 && sx < w) ? 1.f : 0.f;
            src[j] = min(max(sx, 0), w - 1) * kMid;
          }
          for (int i = 0; i < kMid; ++i) {
            const float wv = wt[i * kMid + m];
#pragma unroll
            for (int j = 0; j < kPxPerThread1; ++j)
              acc[j] = fmaf(y1row[src[j] + i] * keep[j], wv, acc[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kPxPerThread1; ++j) {
        const int px = base + pg + j * kGroups;
        if (px < w) {
          y2_s[px * kMid + m] =
              round_t<T>(prelu(acc[j] * s2_s[m] + b2_s[m], a2_s[m]));
        }
      }
    }
  } else {
    // 5x1 down the rows (no BN, no activation), rounded like the TPU
    // kernel's scratch store.
    for (int base = 0; base < w; base += kChunk1) {
      float acc[kPxPerThread1];
      int pxc[kPxPerThread1];
#pragma unroll
      for (int j = 0; j < kPxPerThread1; ++j) {
        acc[j] = 0.f;
        pxc[j] = min(base + pg + j * kGroups, w - 1) * kMid;
      }
#pragma unroll
      for (int ky = 0; ky < 5; ++ky) {
        if (!row_ok[ky]) continue;
        const float* y1row = y1_s + ky * w * kMid;
        const float* wt = wc_s + ky * kMid * kMid;
        for (int i = 0; i < kMid; ++i) {
          const float wv = wt[i * kMid + m];
#pragma unroll
          for (int j = 0; j < kPxPerThread1; ++j) acc[j] = fmaf(y1row[pxc[j] + i], wv, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kPxPerThread1; ++j) {
        const int px = base + pg + j * kGroups;
        if (px < w) z_s[px * kMid + m] = round_t<T>(acc[j]);
      }
    }
    __syncthreads();
    // 1x5 along the row of the 5x1 result, then BN + PReLU.
    for (int base = 0; base < w; base += kChunk1) {
      float acc[kPxPerThread1];
#pragma unroll
      for (int j = 0; j < kPxPerThread1; ++j) acc[j] = 0.f;
      for (int kx = 0; kx < 5; ++kx) {
        const float* wt = wc_s + (5 + kx) * kMid * kMid;
        int src[kPxPerThread1];
        float keep[kPxPerThread1];
#pragma unroll
        for (int j = 0; j < kPxPerThread1; ++j) {
          const int sx = base + pg + j * kGroups + kx - 2;
          keep[j] = (sx >= 0 && sx < w) ? 1.f : 0.f;
          src[j] = min(max(sx, 0), w - 1) * kMid;
        }
        for (int i = 0; i < kMid; ++i) {
          const float wv = wt[i * kMid + m];
#pragma unroll
          for (int j = 0; j < kPxPerThread1; ++j)
            acc[j] = fmaf(z_s[src[j] + i] * keep[j], wv, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kPxPerThread1; ++j) {
        const int px = base + pg + j * kGroups;
        if (px < w) {
          y2_s[px * kMid + m] =
              round_t<T>(prelu(acc[j] * s2_s[m] + b2_s[m], a2_s[m]));
        }
      }
    }
  }
  __syncthreads();

  // Phase 3: expansion + BN, residual, PReLU.  Lanes own consecutive output
  // channels, so the residual read and the store are coalesced.
  const int c = tid % kC;
  const int pg3 = tid / kC;
  constexpr int kGroups3 = kThreads / kC;
  constexpr int kChunk3 = kGroups3 * kPxPerThread3;
  const T* xr = xn + (size_t)r * w * kC;
  T* orow = out + ((size_t)n * h + r) * w * kC;
  for (int base = 0; base < w; base += kChunk3) {
    float acc[kPxPerThread3];
    int pxc[kPxPerThread3];
#pragma unroll
    for (int j = 0; j < kPxPerThread3; ++j) {
      acc[j] = 0.f;
      pxc[j] = min(base + pg3 + j * kGroups3, w - 1) * kMid;
    }
    for (int i = 0; i < kMid; ++i) {
      const float wv = we_s[i * kC + c];
#pragma unroll
      for (int j = 0; j < kPxPerThread3; ++j) acc[j] = fmaf(y2_s[pxc[j] + i], wv, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kPxPerThread3; ++j) {
      const int px = base + pg3 + j * kGroups3;
      if (px < w) {
        float v = acc[j] * s3_s[c] + b3_s[c];
        v += to_f<T>(xr[px * kC + c]);
        orow[px * kC + c] = from_f<T>(prelu(v, ao_s[c]));
      }
    }
  }
}

template <typename T, bool kAsym>
cudaError_t launch(const void* x, void* out, int n, int h, int w, int dil,
                   const float* const* p, cudaStream_t stream) {
  auto kernel = fused_bottleneck_kernel<T, kAsym>;
  const size_t bytes = sizeof(float) * (size_t)smem_layout(kAsym, w).total;
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)limit) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(h, n), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), h, w, dil,
      p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10], p[11]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one launch needs, in bytes (the wrapper checks it).
int bugcar_fused_bottleneck_smem_bytes(int asym, int w) {
  return (int)(sizeof(float) * (size_t)smem_layout(asym != 0, w).total);
}

// x, out: (n, h, w, c) contiguous, float32 (dtype 0) or bfloat16 (dtype 1).
// wp (c, mid); wcore (9, mid, mid) or, for asym, the (5, mid, mid) 5x1 taps
// followed by the (5, mid, mid) 1x5 taps; we (mid, c); all [in][out] f32.
// Returns a cudaError_t (0 = launched).
int bugcar_fused_bottleneck(const void* x, void* out, int n, int h, int w, int c, int mid,
                            const float* wp, const float* s1, const float* b1,
                            const float* a1, const float* wcore, const float* s2,
                            const float* b2, const float* a2, const float* we,
                            const float* s3, const float* b3, const float* ao,
                            int asym, int dilation, int dtype, void* stream) {
  if (c != kC || mid != kMid || n < 1 || h < 1 || w < 1 || n > 65535 ||
      h > 65535 || dilation < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float* p[12] = {wp, s1, b1, a1, wcore, s2, b2, a2, we, s3, b3, ao};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = asym ? launch<float, true>(x, out, n, h, w, 1, p, s)
               : launch<float, false>(x, out, n, h, w, dilation, p, s);
  } else {
    err = asym ? launch<__nv_bfloat16, true>(x, out, n, h, w, 1, p, s)
               : launch<__nv_bfloat16, false>(x, out, n, h, w, dilation, p, s);
  }
  return (int)err;
}

const char* bugcar_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
