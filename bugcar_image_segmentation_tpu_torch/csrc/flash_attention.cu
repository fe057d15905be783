// Blockwise (flash-style) attention for Hopper: softmax(q kT / sqrt(d)) v
// with the online-softmax recurrence, never materialising the (Nq, Nkv)
// score matrix.
//
// Replaces: bugcar_image_segmentation_tpu/ops/pallas/attention.py,
//   flash_attention   (kernel _attn_kernel)         token-major (B, H, N, d)
//   flash_attention_t (kernels _attn_kernel_t and   channel-major (B, H, d, N)
//                      _attn_kernel_t_single)
// One template serves both: kChannelMajor selects how an element (token n,
// channel c) is addressed, n * d + c or c * N + n; the arithmetic is the
// same.
//
// Rounding points, as the TPU kernels: q is scaled by 1/sqrt(d) in f32
// before the dot, scores, the running max / denominator and the
// accumulator are f32, and acc / l is cast to the output type once.
//
// What bounds it on an H100: at SegFormer-B0's stage shapes (d = 32, Nkv =
// 1024 after spatial reduction) each score costs one exp and 2d FMAs of
// the two products, so on paper the exp count on the special-function
// units (16 per SM per clock) bounds it, ahead of the tensor-core FLOPs
// and far ahead of the bytes (q, k, v read once, out written once).
//
// What the design does about it, for now: it is the simple, correct
// version.  One CTA takes kThreads queries of one (batch, head); each
// thread owns one query row -- q scaled, the accumulator, the running max
// and denominator in f32 registers.  K and V stream through shared memory
// in tiles of kTileKv keys, converted to f32 once per tile (rows padded to
// d + 4 floats so that both layouts fill them without bank conflicts),
// and every thread reads each key row as a broadcast.  Scores are
// processed kChunk at a time: chunk max, one rescale of the accumulator,
// then the exp and the P.V FMAs.  The products are f32 FMA loops, so the
// FMA pipes and not the SFUs bound it in practice; tensor-core mma/wgmma,
// TMA and a single-pass variant for short KV are later work.
//
// Built by plain nvcc into a shared library with a C interface (no PyTorch
// headers); bound with ctypes by ops/cuda/build.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 64;   // queries (threads) per CTA
constexpr int kTileKv = 64;    // keys per shared-memory tile
constexpr int kChunk = 16;     // scores per online-softmax update

static_assert(kTileKv % kChunk == 0, "a tile holds whole chunks");

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

// Offset of (token n, channel c) in one (batch, head) slice of n_tok tokens.
template <int D, bool kChannelMajor>
__device__ __forceinline__ size_t at(int n, int c, int n_tok) {
  return kChannelMajor ? (size_t)c * n_tok + n : (size_t)n * D + c;
}

template <typename T, int D, bool kChannelMajor>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int nq, int nkv, float scale) {
  constexpr int kStride = D + 4;   // padded f32 row of a key / value
  __shared__ __align__(16) float ks[kTileKv * kStride];
  __shared__ __align__(16) float vs[kTileKv * kStride];

  const int tid = threadIdx.x;
  const int row = blockIdx.x * kThreads + tid;   // this thread's query
  const bool active = row < nq;
  const size_t bh = blockIdx.y;
  const T* qh = q + bh * nq * D;
  const T* kh = k + bh * nkv * D;
  const T* vh = v + bh * nkv * D;

  float qr[D], acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = active ? to_f<T>(qh[at<D, kChannelMajor>(row, c, nq)]) * scale : 0.f;
    acc[c] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;

  for (int j0 = 0; j0 < nkv; j0 += kTileKv) {
    const int tk = min(kTileKv, nkv - j0);
    __syncthreads();   // the previous tile has been read
    // Fill the tile, 4 channels of one key per step, zeros past the end.
    // Channel-major: consecutive threads take consecutive keys (coalesced
    // reads of a channel row); token-major: consecutive channel quads of a
    // key row.
    for (int i = tid; i < kTileKv * (D / 4); i += kThreads) {
      const int j = kChannelMajor ? i % kTileKv : i / (D / 4);
      const int c0 = 4 * (kChannelMajor ? i / kTileKv : i % (D / 4));
      float4 kq = make_float4(0.f, 0.f, 0.f, 0.f), vq = kq;
      if (j < tk) {
        const int n = j0 + j;
        kq.x = to_f<T>(kh[at<D, kChannelMajor>(n, c0, nkv)]);
        kq.y = to_f<T>(kh[at<D, kChannelMajor>(n, c0 + 1, nkv)]);
        kq.z = to_f<T>(kh[at<D, kChannelMajor>(n, c0 + 2, nkv)]);
        kq.w = to_f<T>(kh[at<D, kChannelMajor>(n, c0 + 3, nkv)]);
        vq.x = to_f<T>(vh[at<D, kChannelMajor>(n, c0, nkv)]);
        vq.y = to_f<T>(vh[at<D, kChannelMajor>(n, c0 + 1, nkv)]);
        vq.z = to_f<T>(vh[at<D, kChannelMajor>(n, c0 + 2, nkv)]);
        vq.w = to_f<T>(vh[at<D, kChannelMajor>(n, c0 + 3, nkv)]);
      }
      *reinterpret_cast<float4*>(ks + j * kStride + c0) = kq;
      *reinterpret_cast<float4*>(vs + j * kStride + c0) = vq;
    }
    __syncthreads();

    for (int jc = 0; jc < tk; jc += kChunk) {
      float s[kChunk];
      float cmax = -CUDART_INF_F;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float4* kr = reinterpret_cast<const float4*>(ks + (jc + u) * kStride);
        float dot = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < D / 4; ++c4) {
          const float4 kk = kr[c4];
          dot = fmaf(qr[4 * c4], kk.x, dot);
          dot = fmaf(qr[4 * c4 + 1], kk.y, dot);
          dot = fmaf(qr[4 * c4 + 2], kk.z, dot);
          dot = fmaf(qr[4 * c4 + 3], kk.w, dot);
        }
        s[u] = jc + u < tk ? dot : -CUDART_INF_F;   // keys past the end drop out
        cmax = fmaxf(cmax, s[u]);
      }
      // The chunk holds at least one real key, so m_new is finite and the
      // first rescale (m = -inf) gives alpha = 0.
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] *= alpha;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float p = expf(s[u] - m_new);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(vs + (jc + u) * kStride);
#pragma unroll
        for (int c4 = 0; c4 < D / 4; ++c4) {
          const float4 vv = vr[c4];
          acc[4 * c4] = fmaf(p, vv.x, acc[4 * c4]);
          acc[4 * c4 + 1] = fmaf(p, vv.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = fmaf(p, vv.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = fmaf(p, vv.w, acc[4 * c4 + 3]);
        }
      }
      m = m_new;
    }
  }

  if (active) {
    T* oh = out + bh * nq * D;
#pragma unroll
    for (int c = 0; c < D; ++c) oh[at<D, kChannelMajor>(row, c, nq)] = from_f<T>(acc[c] / l);
  }
}

template <typename T, int D, bool kChannelMajor>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh,
                   int nq, int nkv, float scale, cudaStream_t stream) {
  const dim3 grid((nq + kThreads - 1) / kThreads, bh);
  flash_attention_kernel<T, D, kChannelMajor><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), nq, nkv, scale);
  return cudaGetLastError();
}

template <bool kChannelMajor>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh, int nq,
             int nkv, int d, float scale, int dtype, void* stream) {
  if (bh < 1 || bh > 65535 || nq < 1 || nkv < 1 || (d != 32 && d != 64) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = d == 32 ? launch<float, 32, kChannelMajor>(q, k, v, out, bh, nq, nkv, scale, s)
                  : launch<float, 64, kChannelMajor>(q, k, v, out, bh, nq, nkv, scale, s);
  } else {
    err = d == 32
        ? launch<__nv_bfloat16, 32, kChannelMajor>(q, k, v, out, bh, nq, nkv, scale, s)
        : launch<__nv_bfloat16, 64, kChannelMajor>(q, k, v, out, bh, nq, nkv, scale, s);
  }
  return (int)err;
}

}  // namespace

extern "C" {

// q, out: (bh, nq, d); k, v: (bh, nkv, d); contiguous, float32 (dtype 0) or
// bfloat16 (dtype 1); d is 32 or 64; scale = 1/sqrt(d) as f32.  Returns a
// cudaError_t (0 = launched).
int bugcar_flash_attention(const void* q, const void* k, const void* v, void* out, int bh,
                           int nq, int nkv, int d, float scale, int dtype, void* stream) {
  return dispatch<false>(q, k, v, out, bh, nq, nkv, d, scale, dtype, stream);
}

// The same on channel-major operands: q, out (bh, d, nq); k, v (bh, d, nkv).
int bugcar_flash_attention_t(const void* q, const void* k, const void* v, void* out, int bh,
                             int nq, int nkv, int d, float scale, int dtype, void* stream) {
  return dispatch<true>(q, k, v, out, bh, nq, nkv, d, scale, dtype, stream);
}

}  // extern "C"
