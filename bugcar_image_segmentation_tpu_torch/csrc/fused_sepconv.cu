// One Xception separable conv as one kernel:
//   depthwise 3x3 (stride 1, or stride 2 with SAME padding) -> folded BN ->
//   ReLU -> pointwise 1x1 (C -> F, f32 accumulation) -> folded BN [-> ReLU]
// on NHWC tensors, the depthwise intermediate kept on the SM.
//
// Replaces: bugcar_image_segmentation_tpu/ops/pallas/sepconv.py::fused_sepconv
//   (kernels _sepconv_kernel_s1 and _sepconv_kernel_s2 over the row bands of
//   _pick_band).  Same arithmetic and rounding points: f32 depthwise taps over
//   the input as stored, the f32 affine and ReLU, then y1 and the pointwise
//   weights rounded to the activation type, their product accumulated in f32,
//   the f32 affine [and ReLU], one cast to the activation type.  Stride 1 pads
//   1 on every side; stride 2 (even H, W) reads input rows / columns
//   2r..2r+2, zero past the bottom / right edge, no top / left pad.
//
// What bounds it on an H100 (bf16): at the entry flow's large maps (256x512
// and 128x256, C <= 256) the bytes -- x read once, the output written once --
// over 3.35 TB/s; at the middle flow (32x64x728 -> 728) the pointwise
// product's FLOPs over the tensor cores' 989 TFLOP/s and, as close, the
// weights' bytes.  The depthwise and its intermediate never reach device
// memory in either case.
//
// What the design does about it, for now -- a simple, correct version:
// one CTA of 256 threads takes 64 output pixels (consecutive in (n, row,
// column) order, so a tile may span rows and images).  Phase 1 computes the
// depthwise + BN + ReLU of all C channels of those pixels once, reading the
// 3x3 windows straight from device memory (neighbouring taps and rows hit
// L1 / L2, so the TPU's precomputed halo arrays have no counterpart): each
// thread loads the nine taps of its eight pixels, from clamped addresses and
// without branches, before using any, and the next channel chunk's filter
// while it computes.  y1 stays resident in shared memory in the activation
// type, zero-padded to whole 64-channel steps.  Phase 2 walks over the CTA's
// 64-wide tiles of F: the weights -- already in the activation type (the
// model rounds them once, as the TPU kernel rounds them) -- stream through
// shared memory 64 input channels at a time with 16-byte loads, the next
// chunk loaded into registers while the current one is multiplied: in bf16
// by eight warps on the tensor cores (wmma 16x16x16, f32 accumulators,
// 16x32 outputs per warp), in f32 (no TF32) by FMAs, 2x8 outputs a thread.
// When the pixel tiles alone are too few for the card (the middle flow's
// 32), the F tiles are split over several CTAs, each recomputing the
// depthwise.  The ragged ends -- C, F not multiples of the tiles (728),
// pixels past the last -- are zero-padded in shared memory and masked on
// store.  Every output element goes through the same instructions wherever
// its pixel lies in the batch and whichever CTA owns it, so a frame's result
// does not depend on the batch it runs in.  Each weight chunk still costs
// one exposed L2 round trip; a deeper pipeline (cp.async / TMA), the input
// window staged in shared memory and wgmma are later work.
//
// Built by plain nvcc into a shared library with a C interface (no PyTorch
// headers); bound with ctypes by ops/cuda/build.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;    // 8 warps
constexpr int kTileP = 64;       // output pixels per CTA
constexpr int kTileF = 64;       // output channels per tile of phase 2
constexpr int kChunk = 32;       // channels per step of phase 1 (one a thread)
constexpr int kKStep = 64;       // input channels per weight chunk of phase 2
constexpr int kLdC = kTileF + 4;    // f32 accumulator rows of the epilogue
constexpr int kMinCtas = 132;       // one per SM of an H100
constexpr int kPixelStep = kThreads / kChunk;      // pixels a pass covers (8)
constexpr int kPixPerThread = kTileP / kPixelStep;  // 8, their taps in flight together

static_assert(kThreads % kChunk == 0 && kTileP % kPixelStep == 0, "phase 1 mapping");
static_assert(kKStep % kChunk == 0 && kKStep % 16 == 0, "y1 padding covers a K step");
static_assert(kThreads == 32 * (kTileP / 16) * 2, "mma: warps of 16 pixels x 32 channels");

// Weight rows [k][f] in shared memory, in the activation type: 8 elements of
// padding keep bf16 rows a multiple of 8 (wmma's ldm) and 16-byte aligned,
// 4 keep f32 rows 16-byte aligned.
template <typename T> __host__ __device__ constexpr int ld_w() { return sizeof(T) == 2 ? kTileF + 8 : kTileF + 4; }
// 16-byte vectors of a weight chunk each thread stages.
template <typename T> __host__ __device__ constexpr int vecs_per_thread() {
  return kKStep * kTileF * (int)sizeof(T) / 16 / kThreads;
}

// Static shared memory besides y1: the weight chunk, and (bf16) the f32
// accumulator tile of the epilogue.
constexpr int kSmemStatic = kKStep * (kTileF + 8) * 2 + kTileP * kLdC * 4;
static_assert(kKStep * (kTileF + 4) * 4 <= kSmemStatic, "f32 weight chunk fits");

// y1's row stride in elements: C rounded up to whole K steps (zero-filled),
// plus 8 so that wmma's ldm stays a multiple of 8 and rows start on other
// banks.
__host__ __device__ constexpr int y1_stride(int c) { return (c + kKStep - 1) / kKStep * kKStep + 8; }

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

struct Shape {
  int h, w, c, f;      // input map and channels, output channels
  int ho, wo;          // output map
  long long pixels;    // n * ho * wo
  int stride;
  int ftiles_per_cta;  // F tiles of kTileF each CTA computes
};

// bf16 on the tensor cores (kMma) or f32 FMAs.  wpw is (C, F) in T.
template <typename T, bool kMma>
__global__ void __launch_bounds__(kThreads, 2)
fused_sepconv_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                     const float* __restrict__ s1, const float* __restrict__ b1,
                     const T* __restrict__ wpw, const float* __restrict__ s2,
                     const float* __restrict__ b2, T* __restrict__ out, Shape sh,
                     int act_out) {
  extern __shared__ __align__(32) unsigned char y1_smem[];
  __shared__ __align__(32) unsigned char smem[kSmemStatic];
  __shared__ int pix_n[kTileP], pix_r[kTileP], pix_c[kTileP];

  const int tid = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * kTileP;
  const int ldy = y1_stride(sh.c);
  // y1 [p][ldy], on a 128-byte boundary (wmma wants 32-byte aligned tiles)
  T* y1s = reinterpret_cast<T*>((reinterpret_cast<uintptr_t>(y1_smem) + 127) & ~uintptr_t(127));

  // (image, row, column) of the tile's output pixels; -1 past the last.
  if (tid < kTileP) {
    const long long gp = p0 + tid;
    const bool live = gp < sh.pixels;
    const long long per_image = (long long)sh.ho * sh.wo;
    const int rem = live ? (int)(gp % per_image) : 0;
    pix_n[tid] = live ? (int)(gp / per_image) : -1;
    pix_r[tid] = rem / sh.wo;
    pix_c[tid] = rem % sh.wo;
  }
  __syncthreads();

  // -- phase 1: y1 = ReLU(depthwise * s1 + b1) of every channel, once -------
  // Thread (pq, kq) computes channel c0 + kq of pixels pq, pq + 8, ...; the
  // nine taps of its eight pixels are loaded from clamped, valid addresses
  // before any is used, so they are in flight together (the taps outside
  // the map are zeroed afterwards), and the next chunk's filter taps are
  // loaded while this chunk's pixels are.
  const int kq = tid % kChunk;
  const int pq = tid / kChunk;
  float wt[11];   // nine taps, scale, bias of the current channel
  auto load_filter = [&](int c0, float* dst) {
    const int chc = min(c0 + kq, sh.c - 1);   // a valid address to load from
#pragma unroll
    for (int t = 0; t < 9; ++t) dst[t] = taps[t * sh.c + chc];
    dst[9] = s1[chc];
    dst[10] = b1[chc];
  };
  load_filter(0, wt);
  for (int c0 = 0; c0 < ldy - 8; c0 += kChunk) {
    const int ch = c0 + kq;
    const bool live_ch = ch < sh.c;
    const int chc = live_ch ? ch : sh.c - 1;
    float v[kPixPerThread][9];
    int rbase[kPixPerThread], cbase[kPixPerThread];
#pragma unroll
    for (int u = 0; u < kPixPerThread; ++u) {
      const int p = pq + u * kPixelStep;
      const int n = pix_n[p];
      rbase[u] = sh.stride == 1 ? pix_r[p] - 1 : 2 * pix_r[p];
      cbase[u] = sh.stride == 1 ? pix_c[p] - 1 : 2 * pix_c[p];
      const T* img = x + (size_t)(n >= 0 ? n : 0) * sh.h * sh.w * sh.c + chc;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const T* row = img + (size_t)min(max(rbase[u] + dy, 0), sh.h - 1) * sh.w * sh.c;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int ic = min(max(cbase[u] + dx, 0), sh.w - 1);
          v[u][dy * 3 + dx] = to_f<T>(row[(size_t)ic * sh.c]);
        }
      }
    }
    float wn[11];
    if (c0 + kChunk < ldy - 8) load_filter(c0 + kChunk, wn);
#pragma unroll
    for (int u = 0; u < kPixPerThread; ++u) {
      const int p = pq + u * kPixelStep;
      float s = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const bool row_in = rbase[u] + dy >= 0 && rbase[u] + dy < sh.h;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const bool in = row_in && cbase[u] + dx >= 0 && cbase[u] + dx < sh.w;
          s += in ? v[u][dy * 3 + dx] * wt[dy * 3 + dx] : 0.0f;
        }
      }
      const bool live = live_ch && pix_n[p] >= 0;
      y1s[p * ldy + ch] = from_f<T>(live ? fmaxf(s * wt[9] + wt[10], 0.0f) : 0.0f);
    }
#pragma unroll
    for (int t = 0; t < 11; ++t) wt[t] = wn[t];
  }

  // -- phase 2: out = act(y1 . wpw * s2 + b2), one kTileF-wide tile at a time
  // The weights stream through shared memory kKStep input channels at a
  // time, 16 bytes per load where F allows; the next chunk is loaded into
  // registers while the tensor cores (or FMAs) work on the current one.
  constexpr int kLdW = ld_w<T>();
  constexpr int kEpv = 16 / (int)sizeof(T);           // elements per vector
  constexpr int kVpr = kTileF / kEpv;                  // vectors per row
  constexpr int kVecs = vecs_per_thread<T>();
  T* wts = reinterpret_cast<T*>(smem);                                  // [k][kLdW]
  float* c_mma = reinterpret_cast<float*>(smem + kKStep * (kTileF + 8) * 2);  // [p][kLdC]
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn_ = warp & 1;  // mma: pixels wm*16.., channels wn_*32..
  const int ty = tid >> 3, tx = tid & 7;     // simt: pixels ty*2..+1, channels tx*8..+7
  const int nk = (sh.c + kKStep - 1) / kKStep;
  const int ft0 = blockIdx.y * sh.ftiles_per_cta;
  const int ft1 = min(ft0 + sh.ftiles_per_cta, (sh.f + kTileF - 1) / kTileF);
  const int steps = (ft1 - ft0) * nk;
  const bool vec_ok = sh.f % kEpv == 0 && reinterpret_cast<uintptr_t>(wpw) % 16 == 0;

  uint4 pre[kVecs];
  auto load_weights = [&](int step) {
    const int f0 = (ft0 + step / nk) * kTileF, c0 = (step % nk) * kKStep;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int e = tid + j * kThreads;
      const int ci = c0 + e / kVpr, fi = f0 + (e % kVpr) * kEpv;
      const T* src = wpw + (size_t)ci * sh.f + fi;
      if (vec_ok) {
        pre[j] = (ci < sh.c && fi < sh.f) ? *reinterpret_cast<const uint4*>(src)
                                          : make_uint4(0, 0, 0, 0);
      } else {
        T* d = reinterpret_cast<T*>(&pre[j]);
#pragma unroll
        for (int q = 0; q < kEpv; ++q)
          d[q] = (ci < sh.c && fi + q < sh.f) ? src[q] : from_f<T>(0.0f);
      }
    }
  };

  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc_mma[2];
  float acc[2][8];
  if (steps > 0) load_weights(0);
  for (int step = 0; step < steps; ++step) {
    const int kc = step % nk;
    const int f0 = (ft0 + step / nk) * kTileF;
    const int c0 = kc * kKStep;
    if (kc == 0) {
      if constexpr (kMma) {
#pragma unroll
        for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc_mma[j], 0.0f);
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      }
    }
    __syncthreads();   // y1 is complete; the previous chunk and tile are consumed
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int e = tid + j * kThreads;
      *reinterpret_cast<uint4*>(wts + (e / kVpr) * kLdW + (e % kVpr) * kEpv) = pre[j];
    }
    __syncthreads();
    if (step + 1 < steps) load_weights(step + 1);

    if constexpr (kMma) {
#pragma unroll
      for (int kk = 0; kk < kKStep; kk += 16) {
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, T, nvcuda::wmma::row_major> a;
        nvcuda::wmma::load_matrix_sync(a, y1s + (wm * 16) * ldy + c0 + kk, ldy);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, T, nvcuda::wmma::row_major> b;
          nvcuda::wmma::load_matrix_sync(b, wts + kk * kLdW + wn_ * 32 + 16 * j, kLdW);
          nvcuda::wmma::mma_sync(acc_mma[j], a, b, acc_mma[j]);
        }
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < kKStep; ++k) {
        const float a0 = to_f<T>(y1s[(ty * 2) * ldy + c0 + k]);
        const float a1 = to_f<T>(y1s[(ty * 2 + 1) * ldy + c0 + k]);
        const float* wr = reinterpret_cast<const float*>(wts) + k * kLdW + tx * 8;
        const float4 bv0 = *reinterpret_cast<const float4*>(wr);
        const float4 bv1 = *reinterpret_cast<const float4*>(wr + 4);
        const float b8[8] = {bv0.x, bv0.y, bv0.z, bv0.w, bv1.x, bv1.y, bv1.z, bv1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[0][j] = fmaf(a0, b8[j], acc[0][j]);
          acc[1][j] = fmaf(a1, b8[j], acc[1][j]);
        }
      }
    }
    if (kc != nk - 1) continue;

    // -- epilogue of the tile: BN [+ ReLU], cast, store (masked at the ends)
    if constexpr (kMma) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::store_matrix_sync(c_mma + (wm * 16) * kLdC + wn_ * 32 + 16 * j, acc_mma[j],
                                        kLdC, nvcuda::wmma::mem_row_major);
      __syncthreads();
      for (int e = tid; e < kTileP * kTileF; e += kThreads) {
        const int p = e / kTileF, fc = e % kTileF;
        const long long gp = p0 + p;
        const int fi = f0 + fc;
        if (gp >= sh.pixels || fi >= sh.f) continue;
        float y = c_mma[p * kLdC + fc] * s2[fi] + b2[fi];
        if (act_out) y = fmaxf(y, 0.0f);
        out[gp * sh.f + fi] = from_f<T>(y);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const long long gp = p0 + ty * 2 + i;
        if (gp >= sh.pixels) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int fi = f0 + tx * 8 + j;
          if (fi >= sh.f) continue;
          float y = acc[i][j] * s2[fi] + b2[fi];
          if (act_out) y = fmaxf(y, 0.0f);
          out[gp * sh.f + fi] = from_f<T>(y);
        }
      }
    }
  }
}

template <typename T, bool kMma>
cudaError_t launch(const void* x, const float* const* fp, const void* wpw, void* out,
                   const Shape& sh, long long tiles, int fgroups, int act_out, cudaStream_t s) {
  const size_t dyn = (size_t)kTileP * y1_stride(sh.c) * sizeof(T) + 128;
  cudaError_t err = cudaFuncSetAttribute(fused_sepconv_kernel<T, kMma>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)tiles, fgroups);
  fused_sepconv_kernel<T, kMma><<<grid, kThreads, dyn, s>>>(
      static_cast<const T*>(x), fp[0], fp[1], fp[2], static_cast<const T*>(wpw), fp[3], fp[4],
      static_cast<T*>(out), sh, act_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (n, h, w, c) NHWC; out: (n, h/stride, w/stride, f); wpw: (c, f); all
// contiguous, float32 (dtype 0) or bfloat16 (dtype 1).  taps: (9, c) f32, the
// depthwise kernel (3, 3, 1, c) as stored; s1, b1: (c,) f32; s2, b2: (f,)
// f32.  stride 1, or 2 with h and w even.  Returns a cudaError_t (0 =
// launched; the y1 tile, 64 pixels x c rounded up to 64, must fit in shared
// memory: c up to ~1600 in bf16, ~800 in f32).
int bugcar_fused_sepconv(const void* x, const void* taps, const void* s1, const void* b1,
                         const void* wpw, const void* s2, const void* b2, void* out, int n,
                         int h, int w, int c, int f, int stride, int act_out, int dtype,
                         void* stream) {
  if (n < 1 || h < 1 || w < 1 || c < 1 || f < 1 || (stride != 1 && stride != 2) ||
      (stride == 2 && (h % 2 || w % 2)) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Shape sh;
  sh.h = h;
  sh.w = w;
  sh.c = c;
  sh.f = f;
  sh.ho = h / stride;
  sh.wo = w / stride;
  sh.pixels = (long long)n * sh.ho * sh.wo;
  sh.stride = stride;
  const long long tiles = (sh.pixels + kTileP - 1) / kTileP;
  const int ftiles = (f + kTileF - 1) / kTileF;
  // Split the F tiles over enough CTAs to give every SM one.
  const long long want = (kMinCtas + tiles - 1) / tiles;
  const int fgroups = (int)(want < ftiles ? want : ftiles);
  sh.ftiles_per_cta = (ftiles + fgroups - 1) / fgroups;
  const int used = (ftiles + sh.ftiles_per_cta - 1) / sh.ftiles_per_cta;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fp[5] = {static_cast<const float*>(taps), static_cast<const float*>(s1),
                        static_cast<const float*>(b1), static_cast<const float*>(s2),
                        static_cast<const float*>(b2)};
  const cudaError_t err =
      dtype == 0 ? launch<float, false>(x, fp, wpw, out, sh, tiles, used, act_out, s)
                 : launch<__nv_bfloat16, true>(x, fp, wpw, out, sh, tiles, used, act_out, s);
  return (int)err;
}

}  // extern "C"
