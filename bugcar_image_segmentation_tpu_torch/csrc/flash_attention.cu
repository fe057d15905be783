// Blockwise (flash-style) attention for Hopper: softmax(q kT / sqrt(d)) v
// with the online-softmax recurrence, never materialising the (Nq, Nkv)
// score matrix.
//
// Replaces: bugcar_image_segmentation_tpu/ops/pallas/attention.py,
//   flash_attention   (kernel _attn_kernel)         token-major (B, H, N, d)
//   flash_attention_t (kernels _attn_kernel_t and   channel-major (B, H, d, N)
//                      _attn_kernel_t_single)
//
// Rounding points, as the TPU kernels: scores, the running max /
// denominator and the accumulator are f32, and acc / l is cast to the
// output type once.
//
// What bounds it on an H100: at SegFormer-B0's stage shapes (d = 32, Nkv =
// 1024 after spatial reduction) each score costs one exp and 2d
// multiply-adds of the two products.  The exps on the special-function
// units (16 per SM per clock) bound it, ahead of the tensor-core FLOPs and
// far ahead of the bytes (q, k, v read once, out written once).
//
// Two kernels serve the four (layout, type) pairs.
//
// bf16, token-major (flash_attention_mma; SegFormer's stage 0, B1-B3's
// d = 64): a CTA of 4 warps takes 64 queries of one (batch, head), 16 rows
// a warp; at d = 32 with at least 264 CTAs' worth of queries in one head
// (stage 0 at 1024x1024) it takes 8 warps and 128 queries, so that each
// K/V tile serves twice the rows.  Q's A fragments are loaded once into
// registers (ldmatrix).  K and V tiles of 64 keys stay in bf16 in shared
// memory (rows padded by 16 bytes, so ldmatrix reads them without bank
// conflicts) and stream through a 2-stage cp.async ring, one barrier a
// tile: the next tile loads while the current one is multiplied.  S = Q.K^T runs on the tensor
// cores (mma.sync m16n8k16, bf16 -> f32, K through ldmatrix); the online
// softmax stays in the S registers: the row max and sum across the quad
// with __shfl_xor, p = 2^(s c - m) with c = scale log2 e folded into one
// fma and ex2.approx on the SFU, alpha rescales the f32 accumulator, l is
// summed from the f32 P; keys are masked only in a ragged last tile.  P.V
// runs on the tensor cores too, with V through ldmatrix.trans and P taken
// from the S registers as the A operand.  To keep the TPU kernel's f32 P,
// P is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi), two products
// into the same f32 accumulator: a single bf16 P is off by more than one
// output ulp wherever the output is near 0 (tests/test_torch_attention_tiles.py
// pins both).  The scale is applied to the f32 scores after the product,
// not to q before it, which differs only at f32 rounding.  The epilogue
// divides by l in f32, casts once, and stores 16 bytes a lane through the
// warp's own rows of the q tile; rows past Nq are not stored, keys past
// Nkv score -inf (their K/V rows are zero-filled).  The grid depends on
// (B*H, Nq) and the CTA width on (Nq, d) only, and every query row runs
// the same instructions either way, so a frame's output does not depend
// on its batch.  Left for later: wgmma with P from registers, and warp
// specialisation (the exps, the split and the products still take turns).
//
// f32 (both layouts) and bf16 channel-major (flash_attention_t) keep the
// first, SIMT design (flash_attention_simt): one thread owns one query
// row -- q scaled by 1/sqrt(d) in f32 before the dot, the accumulator,
// the running max and denominator in f32 registers; K and V stream
// through shared memory in tiles of 64 keys converted to f32 once per
// tile, and the products are f32 FMA loops, so the FMA pipes bound it.
//
// Built by plain nvcc into a shared library with a C interface (no PyTorch
// headers); bound with ctypes by ops/cuda/build.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "ptx.cuh"

namespace {

constexpr int kThreads = 64;   // SIMT: queries (threads) per CTA
constexpr int kTileKv = 64;    // keys per shared-memory tile (both kernels)
constexpr int kChunk = 16;     // SIMT: scores per online-softmax update
constexpr float kLog2e = 1.4426950408889634f;

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
flash_attention_simt(const T* __restrict__ q, const T* __restrict__ k,
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

// f32 (p0, p1) as two bf16 pairs, hi = bf16(p) and lo = bf16(p - hi).
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// 2^x on the special-function unit (rel. error ~2^-22; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// bf16, token-major: q, out (bh, nq, D); k, v (bh, nkv, D); m16n8k16
// fragments as in ptx.cuh.
template <int D, int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
flash_attention_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                    int nq, int nkv, float scale_log2) {
  constexpr int kLd = D + 8;          // padded row (elements): ldmatrix without conflicts
  constexpr int kVecs = D / 8;        // 16-byte vectors per row
  constexpr int kQSteps = D / 16;     // k16 steps of Q.K^T
  constexpr int kSTiles = kTileKv / 8;  // n8 tiles of S (keys)
  constexpr int kOTiles = D / 8;      // n8 tiles of O (channels)
  constexpr int kCta = 32 * kWarps;
  constexpr int kMmaRows = 16 * kWarps;   // queries per CTA
  __shared__ __align__(128) __nv_bfloat16 qs[kMmaRows * kLd];
  constexpr int kStages = 2;   // K/V ring: this tile and the next
  __shared__ __align__(128) __nv_bfloat16 ks[kStages][kTileKv * kLd];
  __shared__ __align__(128) __nv_bfloat16 vs[kStages][kTileKv * kLd];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kMmaRows;
  const size_t bh = blockIdx.y;
  const __nv_bfloat16* qh = q + bh * nq * D;
  const __nv_bfloat16* kh = k + bh * nkv * D;
  const __nv_bfloat16* vh = v + bh * nkv * D;

  for (int i = tid; i < kMmaRows * kVecs; i += kCta) {
    const int r = i / kVecs, c = (i % kVecs) * 8, row = q0 + r;
    cp_async16(qs + r * kLd + c, qh + (size_t)min(row, nq - 1) * D + c, row < nq);
  }
  auto load_kv = [&](int tile, int buf) {
    for (int i = tid; i < kTileKv * kVecs; i += kCta) {
      const int r = i / kVecs, c = (i % kVecs) * 8, key = tile * kTileKv + r;
      const size_t src = (size_t)min(key, nkv - 1) * D + c;
      cp_async16(&ks[buf][r * kLd + c], kh + src, key < nkv);
      cp_async16(&vs[buf][r * kLd + c], vh + src, key < nkv);
    }
  };
  const int ntiles = (nkv + kTileKv - 1) / kTileKv;
  for (int t = 0; t < kStages - 1; ++t) {   // q and the first tiles
    if (t < ntiles) load_kv(t, t);
    cp_async_commit();
  }

  uint32_t qa[kQSteps][4];
  float o[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};   // rows g, g + 8

  for (int tile = 0, buf = 0; tile < ntiles; ++tile, buf = buf + 1 == kStages ? 0 : buf + 1) {
    cp_async_wait<kStages - 2>();   // this tile (and q) have landed
    __syncthreads();                // every warp is past the previous tile
    // refill the buffer the previous tile used, kStages - 1 tiles ahead
    if (tile + kStages - 1 < ntiles)
      load_kv(tile + kStages - 1, buf == 0 ? kStages - 1 : buf - 1);
    cp_async_commit();
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < kQSteps; ++kk)
        ldsm_x4(qa[kk], smem_u32(qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                                 kk * 16 + (lane >> 4) * 8));
    }

    // S = Q.K^T, 16 keys (two n8 tiles) per ldmatrix.x4
    float s[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int jp = 0; jp < kSTiles / 2; ++jp) {
#pragma unroll
      for (int kk = 0; kk < kQSteps; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, smem_u32(&ks[buf][(jp * 16 + (lane & 7) + (lane >> 4) * 8) * kLd + kk * 16 +
                                     ((lane >> 3) & 1) * 8]));
        mma_bf16(s[2 * jp], qa[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qa[kk], b[2], b[3]);
      }
    }

    // online softmax in the log2 domain, p = 2^(s c - m) with c = scale
    // log2 e and m the running max of s c; keys past the end drop out
    const int live = nkv - tile * kTileKv;
    if (live < kTileKv) {
#pragma unroll
      for (int j = 0; j < kSTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * 8 + 2 * t + (e & 1) >= live) s[j][e] = -CUDART_INF_F;
    }
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < kSTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // the tile holds at least one live key, so the new max is finite and
      // the first rescale (m = -inf) gives alpha = 0
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kSTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[j][e], scale_log2, -m[e >> 1]));
        s[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < kOTiles; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P.V, P from the S registers as A, split into bf16 hi + lo
#pragma unroll
    for (int kk = 0; kk < kTileKv / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int jp = 0; jp < kOTiles / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4_t(b, smem_u32(&vs[buf][(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                                       jp * 16 + (lane >> 4) * 8]));
        mma_bf16(o[2 * jp], hi, b[0], b[1]);
        mma_bf16(o[2 * jp], lo, b[0], b[1]);
        mma_bf16(o[2 * jp + 1], hi, b[2], b[3]);
        mma_bf16(o[2 * jp + 1], lo, b[2], b[3]);
      }
    }
  }

  // epilogue: O / l in f32, one cast, staged in the warp's own q rows (its
  // fragments are in registers), stored 16 bytes a lane
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* os = qs + warp * 16 * kLd;
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(os + g * kLd + j * 8 + 2 * t) =
        __floats2bfloat162_rn(o[j][0] / l[0], o[j][1] / l[0]);
    *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * kLd + j * 8 + 2 * t) =
        __floats2bfloat162_rn(o[j][2] / l[1], o[j][3] / l[1]);
  }
  __syncwarp();
  __nv_bfloat16* oh = out + bh * nq * D;
#pragma unroll
  for (int i = lane; i < 16 * kVecs; i += 32) {
    const int r = i / kVecs, c = (i % kVecs) * 8, row = q0 + warp * 16 + r;
    if (row < nq)
      *reinterpret_cast<uint4*>(oh + (size_t)row * D + c) =
          *reinterpret_cast<const uint4*>(os + r * kLd + c);
  }
}

template <typename T, int D, bool kChannelMajor>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh,
                   int nq, int nkv, float scale, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2 && !kChannelMajor) {
    // 128 queries a CTA (8 warps share each K/V tile) where one head's
    // queries alone give every SM two CTAs (SegFormer's stage 0); 64
    // otherwise, and always at d = 64 (static shared memory).  A query
    // row runs the same instructions either way, and the choice does not
    // depend on the batch.
    const float c = scale * kLog2e;
    const T* qq = static_cast<const T*>(q);
    const T* kk = static_cast<const T*>(k);
    const T* vv = static_cast<const T*>(v);
    bool launched = false;
    if constexpr (D == 32) {
      if (nq >= 128 * 264) {
        flash_attention_mma<D, 8><<<dim3((nq + 127) / 128, bh), 256, 0, stream>>>(
            qq, kk, vv, static_cast<T*>(out), nq, nkv, c);
        launched = true;
      }
    }
    if (!launched)
      flash_attention_mma<D, 4><<<dim3((nq + 63) / 64, bh), 128, 0, stream>>>(
          qq, kk, vv, static_cast<T*>(out), nq, nkv, c);
  } else {
    const dim3 grid((nq + kThreads - 1) / kThreads, bh);
    flash_attention_simt<T, D, kChannelMajor><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), nq, nkv, scale);
  }
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
