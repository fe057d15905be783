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
// Two kernels serve the four (layout, type) pairs: bf16 in both layouts
// runs on the tensor cores (flash_attention_mma), f32 in both on the FMA
// pipes (flash_attention_simt).
//
// bf16 (flash_attention_mma): a CTA of 4 warps takes 64 queries of one
// (batch, head), 16 rows a warp; at d = 32 with at least 264 CTAs' worth of
// queries in one head (SegFormer's stage 0 at 1024x1024) it takes 8 warps
// and 128 queries, so that each K/V tile serves twice the rows (channel-
// major from 128 CTAs' worth, stage 1).  Q's A fragments are
// loaded once into registers (ldmatrix).  K and V tiles of 64 keys stay in
// bf16 in shared memory (rows padded by 16 bytes, so ldmatrix reads them
// without bank conflicts) and stream through a 2-stage cp.async ring, one
// barrier a tile: the next tile loads while the current one is multiplied.
// S = Q.K^T runs on the tensor cores (mma.sync m16n8k16, bf16 -> f32); the
// online softmax stays in the S registers: the row max and sum across the
// quad with __shfl_xor, p = 2^(s c - m) with c = scale log2 e folded into
// one fma and ex2.approx on the SFU, alpha rescales the f32 accumulator, l
// is summed from the f32 P; keys are masked only in a ragged last tile.
// P.V runs on the tensor cores too, with P taken from the S registers as
// the A operand.  To keep the TPU kernel's f32 P, P is split into P_hi =
// bf16(P) and P_lo = bf16(P - P_hi), two products into the same f32
// accumulator: a single bf16 P is off by more than one output ulp wherever
// the output is near 0 (tests/test_torch_attention_tiles.py pins both).
// The scale is applied to the f32 scores after the product, not to q
// before it, which differs only at f32 rounding.  The epilogue divides by
// l in f32, casts once, stages the warp's tile in its own part of the q
// tile and stores 16 bytes a lane; queries past Nq are not stored, keys
// past Nkv score -inf (their K/V entries are zero-filled).
//
// The two layouts differ only in how tiles are laid out and read.
// Token-major operands (flash_attention: stage 0, B1-B3's d = 64) load as
// [token][channel] tiles; Q's and K's fragments come from ldmatrix, V's
// from ldmatrix.trans.  Channel-major operands (flash_attention_t: stages
// 1-3, one row per channel, tokens contiguous) load as [channel][token]
// tiles, 16-byte cp.async vectors along the tokens, and each operand takes
// the other ldmatrix form: Q's A fragments and K's B fragments with .trans,
// V's without; the epilogue stages [channel][query] and stores along the
// queries.  Where a row does not start on 16 bytes (Nq or Nkv not a
// multiple of 8), the channel-major tiles load and store element by
// element instead -- the arithmetic is the same.  The grid depends on
// (B*H, Nq) and the CTA width on (Nq, d, layout) only, and every query row
// runs the same instructions at every width, so a frame's output does not
// depend on its batch.  Left for later: wgmma with P from registers, and
// warp specialisation (the exps, the split and the products still take
// turns).
//
// f32 (both layouts) keeps the first, SIMT design (flash_attention_simt):
// one thread owns one query row -- q scaled by 1/sqrt(d) in f32 before the
// dot, the accumulator, the running max and denominator in f32 registers;
// K and V stream through shared memory in tiles of 64 keys converted to
// f32 once per tile, and the products are f32 FMA loops, so the FMA pipes
// bound it.
//
// Built by plain nvcc into a shared library with a C interface (no PyTorch
// headers); bound with ctypes by ops/cuda/build.py.  The wrappers call
// bugcar_flash_attention and bugcar_flash_attention_t, whose CTA width is
// always mma_rows'; bugcar_flash_attention_bf16_rows, which forces a width,
// exists only to measure the widths against each other
// (scripts/torch_attention_plans.py, and a card test that they give the
// same bits) and no serving path calls it.

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

// Offset of (token n, channel c) in one (batch, head) slice of n_tok tokens.
template <int D, bool kChannelMajor>
__device__ __forceinline__ size_t at(int n, int c, int n_tok) {
  return kChannelMajor ? (size_t)c * n_tok + n : (size_t)n * D + c;
}

template <int D, bool kChannelMajor>
__global__ void __launch_bounds__(kThreads)
flash_attention_simt(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, int nq, int nkv,
                     float scale) {
  constexpr int kStride = D + 4;   // padded f32 row of a key / value
  __shared__ __align__(16) float ks[kTileKv * kStride];
  __shared__ __align__(16) float vs[kTileKv * kStride];

  const int tid = threadIdx.x;
  const int row = blockIdx.x * kThreads + tid;   // this thread's query
  const bool active = row < nq;
  const size_t bh = blockIdx.y;
  const float* qh = q + bh * nq * D;
  const float* kh = k + bh * nkv * D;
  const float* vh = v + bh * nkv * D;

  float qr[D], acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = active ? qh[at<D, kChannelMajor>(row, c, nq)] * scale : 0.f;
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
        kq.x = kh[at<D, kChannelMajor>(n, c0, nkv)];
        kq.y = kh[at<D, kChannelMajor>(n, c0 + 1, nkv)];
        kq.z = kh[at<D, kChannelMajor>(n, c0 + 2, nkv)];
        kq.w = kh[at<D, kChannelMajor>(n, c0 + 3, nkv)];
        vq.x = vh[at<D, kChannelMajor>(n, c0, nkv)];
        vq.y = vh[at<D, kChannelMajor>(n, c0 + 1, nkv)];
        vq.z = vh[at<D, kChannelMajor>(n, c0 + 2, nkv)];
        vq.w = vh[at<D, kChannelMajor>(n, c0 + 3, nkv)];
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
    float* oh = out + bh * nq * D;
#pragma unroll
    for (int c = 0; c < D; ++c) oh[at<D, kChannelMajor>(row, c, nq)] = acc[c] / l;
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

// bf16 on the tensor cores; m16n8k16 fragments as in ptx.cuh.
// Token-major (kCM false): q, out (bh, nq, D); k, v (bh, nkv, D); tiles in
// shared memory are [token][channel].  Channel-major (kCM true): q, out
// (bh, D, nq); k, v (bh, D, nkv); tiles are [channel][token], and each
// operand takes the other ldmatrix form (Q and K with .trans, V without).
// vec16 (channel-major only): every operand row starts on 16 bytes, so
// tiles load and the output stores in 16-byte vectors along the tokens;
// otherwise element by element.  The arithmetic is the same in all cases.
template <int D, int kWarps, bool kCM>
__global__ void __launch_bounds__(32 * kWarps)
flash_attention_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                    int nq, int nkv, float scale_log2, bool vec16) {
  constexpr int kVecs = D / 8;        // token-major: 16-byte vectors per row
  constexpr int kQSteps = D / 16;     // k16 steps of Q.K^T
  constexpr int kSTiles = kTileKv / 8;  // n8 tiles of S (keys)
  constexpr int kOTiles = D / 8;      // n8 tiles of O (channels)
  constexpr int kCta = 32 * kWarps;
  constexpr int kMmaRows = 16 * kWarps;   // queries per CTA
  // Padded rows (elements): 16 bytes more than the data, so that the 8
  // row addresses of an ldmatrix fall in 8 distinct 4-bank groups.
  constexpr int kLd = D + 8;                  // token-major, q and k/v
  constexpr int kLdQ = kMmaRows + 8;          // channel-major q
  constexpr int kLdKv = kTileKv + 8;          // channel-major k/v
  constexpr int kQElems = kCM ? D * kLdQ : kMmaRows * kLd;
  constexpr int kKvElems = kCM ? D * kLdKv : kTileKv * kLd;
  __shared__ __align__(128) __nv_bfloat16 qs[kQElems];
  constexpr int kStages = 2;   // K/V ring: this tile and the next
  __shared__ __align__(128) __nv_bfloat16 ks[kStages][kKvElems];
  __shared__ __align__(128) __nv_bfloat16 vs[kStages][kKvElems];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kMmaRows;
  const size_t bh = blockIdx.y;
  const __nv_bfloat16* qh = q + bh * nq * D;
  const __nv_bfloat16* kh = k + bh * nkv * D;
  const __nv_bfloat16* vh = v + bh * nkv * D;

  // Channel-major: `len` tokens from token n0 of each of the D rows of src
  // (n_tok tokens a row) into dst rows of ld elements; zeros past n_tok.
  auto load_cm = [&](__nv_bfloat16* dst, int ld, const __nv_bfloat16* src, int n_tok, int n0,
                     int len) {
    const int per_row = len / 8;
    for (int i = tid; i < D * per_row; i += kCta) {
      const int c = i / per_row, j = (i % per_row) * 8, n = n0 + j;
      __nv_bfloat16* d = dst + c * ld + j;
      const __nv_bfloat16* s = src + (size_t)c * n_tok;
      if (vec16) {   // n_tok % 8 == 0: a vector is all in or all out
        cp_async16(d, s + (n < n_tok ? n : 0), n < n_tok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d[e] = n + e < n_tok ? s[n + e] : __float2bfloat16_rn(0.f);
      }
    }
  };
  if constexpr (kCM) {
    load_cm(qs, kLdQ, qh, nq, q0, kMmaRows);
  } else {
    for (int i = tid; i < kMmaRows * kVecs; i += kCta) {
      const int r = i / kVecs, c = (i % kVecs) * 8, row = q0 + r;
      cp_async16(qs + r * kLd + c, qh + (size_t)min(row, nq - 1) * D + c, row < nq);
    }
  }
  auto load_kv = [&](int tile, int buf) {
    if constexpr (kCM) {
      load_cm(ks[buf], kLdKv, kh, nkv, tile * kTileKv, kTileKv);
      load_cm(vs[buf], kLdKv, vh, nkv, tile * kTileKv, kTileKv);
    } else {
      for (int i = tid; i < kTileKv * kVecs; i += kCta) {
        const int r = i / kVecs, c = (i % kVecs) * 8, key = tile * kTileKv + r;
        const size_t src = (size_t)min(key, nkv - 1) * D + c;
        cp_async16(&ks[buf][r * kLd + c], kh + src, key < nkv);
        cp_async16(&vs[buf][r * kLd + c], vh + src, key < nkv);
      }
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

  // ldmatrix.x4 lane roles: lane / 8 picks the 8x8 matrix, lane % 8 its row.
  const int mrow = lane & 7, mhi = (lane >> 3) & 1, mtop = lane >> 4;
  for (int tile = 0, buf = 0; tile < ntiles; ++tile, buf = buf + 1 == kStages ? 0 : buf + 1) {
    cp_async_wait<kStages - 2>();   // this tile (and q) have landed
    __syncthreads();                // every warp is past the previous tile
    // refill the buffer the previous tile used, kStages - 1 tiles ahead
    if (tile + kStages - 1 < ntiles)
      load_kv(tile + kStages - 1, buf == 0 ? kStages - 1 : buf - 1);
    cp_async_commit();
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < kQSteps; ++kk) {
        if constexpr (kCM)   // rows are channels: transpose to query rows
          ldsm_x4_t(qa[kk], smem_u32(qs + (kk * 16 + mtop * 8 + mrow) * kLdQ + warp * 16 +
                                     mhi * 8));
        else
          ldsm_x4(qa[kk], smem_u32(qs + (warp * 16 + mrow + mhi * 8) * kLd + kk * 16 +
                                   mtop * 8));
      }
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
        if constexpr (kCM)   // rows are channels (k): .trans gives k pairs
          ldsm_x4_t(b, smem_u32(&ks[buf][(kk * 16 + mhi * 8 + mrow) * kLdKv + jp * 16 +
                                         mtop * 8]));
        else
          ldsm_x4(b, smem_u32(&ks[buf][(jp * 16 + mrow + mtop * 8) * kLd + kk * 16 + mhi * 8]));
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
        if constexpr (kCM)   // rows are channels (n), keys (k) along them
          ldsm_x4(b, smem_u32(&vs[buf][(jp * 16 + mtop * 8 + mrow) * kLdKv + kk * 16 +
                                       mhi * 8]));
        else
          ldsm_x4_t(b, smem_u32(&vs[buf][(kk * 16 + mrow + mhi * 8) * kLd + jp * 16 +
                                         mtop * 8]));
        mma_bf16(o[2 * jp], hi, b[0], b[1]);
        mma_bf16(o[2 * jp], lo, b[0], b[1]);
        mma_bf16(o[2 * jp + 1], hi, b[2], b[3]);
        mma_bf16(o[2 * jp + 1], lo, b[2], b[3]);
      }
    }
  }

  // epilogue: O / l in f32, one cast, staged in the shared memory of the
  // warp's own queries of the q tile (its fragments are in registers),
  // stored 16 bytes a lane
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (kCM) {
    // [channel][query]: the warp's 16 columns of the q tile
    __nv_bfloat16* os = qs + warp * 16;
#pragma unroll
    for (int j = 0; j < kOTiles; ++j) {
      const int c = j * 8 + 2 * t;
      os[c * kLdQ + g] = __float2bfloat16_rn(o[j][0] / l[0]);
      os[(c + 1) * kLdQ + g] = __float2bfloat16_rn(o[j][1] / l[0]);
      os[c * kLdQ + g + 8] = __float2bfloat16_rn(o[j][2] / l[1]);
      os[(c + 1) * kLdQ + g + 8] = __float2bfloat16_rn(o[j][3] / l[1]);
    }
    __syncwarp();
    __nv_bfloat16* oh = out + bh * nq * D;
#pragma unroll
    for (int i = lane; i < 2 * D; i += 32) {   // two 8-query vectors a channel
      const int c = i >> 1, j = (i & 1) * 8, n = q0 + warp * 16 + j;
      const __nv_bfloat16* src = os + c * kLdQ + j;
      __nv_bfloat16* dst = oh + (size_t)c * nq + n;
      if (vec16) {
        if (n < nq) *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (n + e < nq) dst[e] = src[e];
      }
    }
  } else {
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
}

// Queries a CTA of the bf16 kernel takes: 128 at d = 32 (8 warps share
// each K/V tile) where one head's queries alone fill the grid -- token-
// major from 264 CTAs (two an SM; SegFormer's stage 0), channel-major from
// 128 (stage 1: 35.6 us against 38.4 at 64); 64 otherwise (stage 2: 30.2
// against 34.6 at 128; stage 3: 19.2, and 21.2 at 32 although 32 covers
// all 132 SMs with 256 CTAs; scripts/torch_attention_plans.py on an H100
// SXM at 700 W).  It depends on (nq, d, layout) only, and a query row runs
// the same instructions at every width, so a frame's output does not
// depend on its batch.
int mma_rows(int nq, int d, bool channel_major) {
  if (d == 32 && nq >= 128 * (channel_major ? 128 : 264)) return 128;
  return 64;
}

template <int D, bool kCM>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, int bh, int nq,
                       int nkv, float scale, int rows, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const float c = scale * kLog2e;
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
  const bool vec16 = kCM && nq % 8 == 0 && nkv % 8 == 0 &&
                     ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) &
                      15) == 0;
  const dim3 grid((nq + rows - 1) / rows, bh);
  if (rows == 32) {
    flash_attention_mma<D, 2, kCM><<<grid, 64, 0, stream>>>(qq, kk, vv, oo, nq, nkv, c, vec16);
  } else if (rows == 64) {
    flash_attention_mma<D, 4, kCM><<<grid, 128, 0, stream>>>(qq, kk, vv, oo, nq, nkv, c, vec16);
  } else {
    if constexpr (D == 32) {   // static shared memory: 128 queries at d = 32 only
      if (rows == 128) {
        flash_attention_mma<D, 8, kCM><<<grid, 256, 0, stream>>>(qq, kk, vv, oo, nq, nkv, c,
                                                                  vec16);
        return cudaGetLastError();
      }
    }
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, int D, bool kChannelMajor>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh,
                   int nq, int nkv, float scale, int rows, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return launch_mma<D, kChannelMajor>(q, k, v, out, bh, nq, nkv, scale,
                                        rows ? rows : mma_rows(nq, D, kChannelMajor), stream);
  } else {
    const dim3 grid((nq + kThreads - 1) / kThreads, bh);
    flash_attention_simt<D, kChannelMajor><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), nq, nkv, scale);
    return cudaGetLastError();
  }
}

template <bool kChannelMajor>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh, int nq,
             int nkv, int d, float scale, int dtype, int rows, void* stream) {
  if (bh < 1 || bh > 65535 || nq < 1 || nkv < 1 || (d != 32 && d != 64) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = d == 32 ? launch<float, 32, kChannelMajor>(q, k, v, out, bh, nq, nkv, scale, 0, s)
                  : launch<float, 64, kChannelMajor>(q, k, v, out, bh, nq, nkv, scale, 0, s);
  } else {
    err = d == 32
        ? launch<__nv_bfloat16, 32, kChannelMajor>(q, k, v, out, bh, nq, nkv, scale, rows, s)
        : launch<__nv_bfloat16, 64, kChannelMajor>(q, k, v, out, bh, nq, nkv, scale, rows, s);
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
  return dispatch<false>(q, k, v, out, bh, nq, nkv, d, scale, dtype, 0, stream);
}

// The same on channel-major operands: q, out (bh, d, nq); k, v (bh, d, nkv).
int bugcar_flash_attention_t(const void* q, const void* k, const void* v, void* out, int bh,
                             int nq, int nkv, int d, float scale, int dtype, void* stream) {
  return dispatch<true>(q, k, v, out, bh, nq, nkv, d, scale, dtype, 0, stream);
}

// Queries a CTA takes for (nq, d, dtype, layout): the bf16 tensor-core
// kernel's plan, or the SIMT kernel's one query a thread.
int bugcar_flash_attention_rows(int nq, int d, int dtype, int channel_major) {
  return dtype == 1 ? mma_rows(nq, d, channel_major != 0) : kThreads;
}

// The bf16 kernel at a given CTA width (32, 64 or 128 queries; 128 only at
// d = 32): for measurement only, timing the widths against each other.
int bugcar_flash_attention_bf16_rows(const void* q, const void* k, const void* v, void* out,
                                     int bh, int nq, int nkv, int d, float scale,
                                     int channel_major, int rows, void* stream) {
  if (rows != 32 && rows != 64 && rows != 128) return (int)cudaErrorInvalidValue;
  return channel_major
      ? dispatch<true>(q, k, v, out, bh, nq, nkv, d, scale, 1, rows, stream)
      : dispatch<false>(q, k, v, out, bh, nq, nkv, d, scale, 1, rows, stream);
}

}  // extern "C"
