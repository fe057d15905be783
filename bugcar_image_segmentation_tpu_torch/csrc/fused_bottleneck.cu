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
// launch, the load of the weights into every CTA and the dependent phases
// (load, project, core, expand, store).
//
// Both kernels cut a launch the same way: one CTA per 16 output pixels of
// a row, so the path's 32x64 map launches 128 CTAs.  A CTA first issues,
// by cp.async, the x pixels its core taps read -- 3 rows (r - d, r, r + d)
// of 16 + 2d columns for the dilated 3x3 (for d > 16 the three 16-column
// windows the taps read, side by side; for d >= w the centre window
// alone), 5 rows of 20 columns for the 5x1 -- together with the weights,
// and recomputes the projection of the halo columns instead of exchanging
// y1 with its neighbours.  The grid depends on (h, w) and the tile on
// (kind, d) only, so a frame's output does not depend on its batch.
//
// f32 (fused_bottleneck_tile): 512 threads, f32 FMA chains on the FMA
// pipes, each output in the order of the first, one-CTA-a-row design
// (input channels in order; taps row by row, then along the row).
//
// bf16 (fused_bottleneck_mma): 8 warps; the weights, rounded to bf16 once
// by the caller in mma fragment order (ops/cuda/bottleneck.pack_weights),
// x and y1 as bf16 in padded shared-memory rows read by ldmatrix; all three
// products on the tensor cores (mma.sync m16n8k16; each k16 step's sum
// added to an f32 sum rounded to nearest, the step's mmas issued together
// before any sum waits on one): the projection an m16 tile a warp at a
// time, the core (implicit GEMM over the shifted y1 rows, K in tap order)
// an n8 tile on each of four warps (the 5x1 one m16 x n8 tile a warp), the
// expansion two n8 tiles a warp; its result staged in place of the x
// pixels it read and stored in 16-byte vectors.
//
// Its roundings are those of the f32 kernel's FMA chains (the first
// design's, so its bits are that design's bf16 bits).  The kernel is held, output by
// output, to a few bf16 ulps of the plain version (cuDNN's f32 sums, the
// same bf16 roundings), and a y1, z or y2 value within f32 rounding of a
// bf16 midpoint rounds apart under two summation orders -- through the
// next product and a residual that nearly cancels, one such flip can pass
// that budget.  So every value the kernel rounds (y1, z, y2, the output)
// is the one the chain gives, bit for bit: beside each sum it carries, on
// the tensor cores too, A = sum |products| and Q = sum of |running sum|
// at its k16 steps, which bound how far the sum can lie from the chain's:
// |tensor-core step - exact| <= 16 u |step's products| for 16 products
// aligned and truncated to f32, the chain's 16 roundings a step u |partial
// sum| each, u = 2^-24; E = 2^-17 A + 2^-18 Q takes that bound about
// twice over.  Where every f32 value within E of the sum rounds to the
// same bf16 bits (the activations are monotone on either side of 0),
// those are the chain's; an element where they are not (on ENet's trunk
// ~8 % of y1, ~15 % of y2, ~2 % of the outputs) is queued, one atomic a
// warp, and recomputed by the chain itself from the same shared-memory
// operands in the chain's order, 16 inputs and weights a 16-byte load.
// tests/test_torch_bottleneck_tiles.py emulates the rule on the CPU.
//
// Built by plain nvcc into a shared library with a C interface (no PyTorch
// headers); bound with ctypes by ops/cuda/build.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "ptx.cuh"

namespace {

constexpr int kC = 128;       // block width (input = output channels)
constexpr int kMid = 32;      // projected width
constexpr int kTilePx = 16;   // output pixels a CTA, one row

__device__ __forceinline__ float prelu(float v, float a) {
  return v >= 0.f ? v : a * v;
}

// The y1 tile of one CTA: `rows` rows (r - d, r, r + d; or r - 2 .. r + 2)
// by `used` columns.  span: tile columns between two horizontal taps of
// the 3x3 -- d while the three 16-column windows the taps read overlap (d <
// 16), 16 when they do not (the tile is then the three windows side by
// side, so it never exceeds 48 columns), 0 when d >= w (the side taps read
// only padding and are skipped); the 1x5 reads 20 contiguous columns.
struct Tile {
  int rows, used, span;
};

__host__ __device__ inline Tile tile_of(bool asym, int w, int dil) {
  Tile t;
  t.rows = asym ? 5 : 3;
  t.span = asym ? 1 : (dil >= w ? 0 : (dil < kTilePx ? dil : kTilePx));
  t.used = asym ? kTilePx + 4 : kTilePx + 2 * t.span;
  return t;
}

// Image column of tile column t, for a CTA whose outputs start at x0.
__device__ __forceinline__ int image_col(const Tile& L, bool asym, int x0, int dil, int t) {
  if (asym) return x0 - 2 + t;
  if (L.span == dil) return x0 - dil + t;   // one window (d <= 16)
  if (L.span == 0) return x0 + t;           // the centre window alone
  return x0 + (t / kTilePx - 1) * dil + t % kTilePx;
}

// -- f32: fused_bottleneck_tile, FMA chains -------------------------------------

constexpr int kTileThreads = 512;
constexpr int kWarps = kTileThreads / 32;

// Shared-memory layout in bytes: the weights, x, then y1, the 5x1 result
// and y2, all f32.
struct Smem {
  int wts, xs, y1, z, y2, total;
};

__host__ __device__ inline Smem smem_layout(bool asym, int w, int dil) {
  const Tile L = tile_of(asym, w, dil);
  const int px = L.rows * L.used;
  Smem s;
  s.wts = 0;
  s.xs = s.wts + 4 * (kC * kMid + (asym ? 10 : 9) * kMid * kMid + kMid * kC);
  s.y1 = s.xs + 4 * px * kC;
  s.z = s.y1 + 4 * px * kMid;
  s.y2 = s.z + (asym ? 4 * (kTilePx + 4) * kMid : 0);
  s.total = s.y2 + 4 * kTilePx * kMid;
  return s;
}

// A (k, n) [k][n] f32 weight matrix from global into shared memory, four
// k a float4: element (k, n) at ((k / 4) n_all + n) 4 + k % 4, so that a
// thread reads w[k..k+3][n] in one 16-byte load.
__device__ __forceinline__ void stage_weights(float* dst, const float* __restrict__ src, int k,
                                              int n) {
  const int per_row = n / 4, units = (k / 4) * per_row;
  for (int u = threadIdx.x; u < units; u += kTileThreads) {
    const int kq = u / per_row, n0 = (u % per_row) * 4;
    float4 v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = __ldg(reinterpret_cast<const float4*>(src + (size_t)(4 * kq + q) * n + n0));
    const float* e[4] = {&v[0].x, &v[1].x, &v[2].x, &v[3].x};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(dst + ((size_t)kq * n + n0 + j) * 4) =
          make_float4(e[0][j], e[1][j], e[2][j], e[3][j]);
  }
}

// The projection y1 = PReLU(BN(x @ wp)) of the tile's P pixels, G a
// thread (pixels wq, wq + 16, ...; G = ceil(P / 16)), each an FMA chain
// over the input channels in order; rows off the image are skipped, columns
// off it get 0.
template <int G>
__device__ __forceinline__ void project(const float* xs, const float4* wp4, float* y1s,
                                        const Tile& L, bool asym, const bool* row_ok, int x0,
                                        int dil, int w, float s1m, float b1m, float a1m) {
  const int m = threadIdx.x % kMid, wq = threadIdx.x / kMid, P = L.rows * L.used;
  int px[G];
  float acc[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    px[j] = min(wq + j * kWarps, P - 1) * kC;
    acc[j] = 0.f;
  }
  for (int c = 0; c < kC; c += 4) {
    const float4 wv = wp4[(c / 4) * kMid + m];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + px[j] + c);
      acc[j] = fmaf(xv.x, wv.x, acc[j]);
      acc[j] = fmaf(xv.y, wv.y, acc[j]);
      acc[j] = fmaf(xv.z, wv.z, acc[j]);
      acc[j] = fmaf(xv.w, wv.w, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int p = wq + j * kWarps;
    if (p >= P || !row_ok[p / L.used]) continue;
    const int ic = image_col(L, asym, x0, dil, p % L.used);
    y1s[p * kMid + m] = ic >= 0 && ic < w ? prelu(acc[j] * s1m + b1m, a1m) : 0.f;
  }
}

// wp (c, mid), wcore (taps, mid, mid), we (mid, c): [in][out] f32.  Every
// output runs the same FMA chain as the first, one-CTA-a-row design of this
// kernel did (input channels in order; taps row by row), so its results
// are the same bits.
template <bool kAsym>
__global__ void __launch_bounds__(kTileThreads)
fused_bottleneck_tile(const float* __restrict__ x, float* __restrict__ out, int h, int w,
                      int dil, const float* __restrict__ wp, const float* __restrict__ wcore,
                      const float* __restrict__ we, const float* __restrict__ s1,
                      const float* __restrict__ b1, const float* __restrict__ a1,
                      const float* __restrict__ s2, const float* __restrict__ b2,
                      const float* __restrict__ a2, const float* __restrict__ s3,
                      const float* __restrict__ b3, const float* __restrict__ ao) {
  constexpr int kRows = kAsym ? 5 : 3;
  constexpr int kTaps = kAsym ? 10 : 9;
  extern __shared__ __align__(16) unsigned char smem_tile[];
  const Tile L = tile_of(kAsym, w, dil);
  const Smem S = smem_layout(kAsym, w, dil);
  float* wts_s = reinterpret_cast<float*>(smem_tile + S.wts);
  const float4* wp4 = reinterpret_cast<const float4*>(wts_s);     // [c/4][m][4]
  const float4* wc4 = wp4 + kC * kMid / 4;                        // [(tap i)/4][o][4]
  const float4* we4 = wc4 + kTaps * kMid * kMid / 4;              // [m/4][c][4]
  float* xs = reinterpret_cast<float*>(smem_tile + S.xs);          // [row][col][c]
  float* y1s = reinterpret_cast<float*>(smem_tile + S.y1);         // [row][col][m]
  float* zs = reinterpret_cast<float*>(smem_tile + S.z);           // [col][m], the 5x1 result
  float* y2s = reinterpret_cast<float*>(smem_tile + S.y2);         // [px][m]

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTilePx, r = blockIdx.y, n = blockIdx.z;
  const int step = kAsym ? 1 : dil, center = kRows / 2;
  const int P = L.rows * L.used;
  const float* xn = x + (size_t)n * h * w * kC;
  bool row_ok[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int ir = r + (k - center) * step;
    row_ok[k] = ir >= 0 && ir < h;
  }

  // -- loads: the x pixels of the tile by cp.async (zeros off the image's
  // columns; rows off the image are left alone, no tap reads them), then,
  // while they land, the weights
  {
    constexpr int kPxVecs = kC / 4;
    for (int i = tid; i < P * kPxVecs; i += kTileThreads) {
      const int px = i / kPxVecs, e = (i % kPxVecs) * 4, k = px / L.used;
      if (!row_ok[k]) continue;
      const int ir = r + (k - center) * step;
      const int ic = image_col(L, kAsym, x0, dil, px % L.used);
      const bool ok = ic >= 0 && ic < w;
      cp_async16(xs + px * kC + e, xn + ((size_t)ir * w + (ok ? ic : 0)) * kC + e, ok);
    }
    cp_async_commit();
    stage_weights(wts_s, wp, kC, kMid);
    stage_weights(wts_s + kC * kMid, wcore, kTaps * kMid, kMid);
    stage_weights(wts_s + (kC + kTaps * kMid) * kMid, we, kMid, kC);
    cp_async_wait<0>();
    __syncthreads();
  }

  // Mid-wide phases: lanes own the 32 mid channels (weight reads are
  // consecutive, activation reads broadcasts), warps take pixels in turn.
  const int m = tid % kMid, wq = tid / kMid;

  // -- projection, as many pixels a thread as the tile needs
  {
    const float s1m = __ldg(s1 + m), b1m = __ldg(b1 + m), a1m = __ldg(a1 + m);
#define BUGCAR_PROJECT(G)                                                                    \
  case G:                                                                                  \
    project<G>(xs, wp4, y1s, L, kAsym, row_ok, x0, dil, w, s1m, b1m, a1m);                 \
    break;
    switch ((P + kWarps - 1) / kWarps) {   // P is 48 .. 144
      BUGCAR_PROJECT(3)
      BUGCAR_PROJECT(4)
      BUGCAR_PROJECT(5)
      BUGCAR_PROJECT(6)
      BUGCAR_PROJECT(7)
      BUGCAR_PROJECT(8)
      BUGCAR_PROJECT(9)
    }
#undef BUGCAR_PROJECT
  }
  __syncthreads();

  // -- core conv and its BN + PReLU into y2: warps 0-3, outputs p = wq + 4 j
  // (each weight read serves four pixels); the other warps wait
  {
    constexpr int kCoreWarps = 4, kPx = kTilePx / kCoreWarps;
    const bool core = wq < kCoreWarps;
    float acc[kPx] = {};
    // y: the tap's input for output 0 ([px][m] rows); k0: its first row
    // of the core matrix (tap x 32)
    auto tap = [&](const float* y, int k0) {
#pragma unroll
      for (int i = 0; i < kMid; i += 4) {
        const float4 wv = wc4[((k0 + i) / 4) * kMid + m];
#pragma unroll
        for (int j = 0; j < kPx; ++j) {
          const float4 yv =
              *reinterpret_cast<const float4*>(y + (wq + kCoreWarps * j) * kMid + i);
          acc[j] = fmaf(yv.x, wv.x, acc[j]);
          acc[j] = fmaf(yv.y, wv.y, acc[j]);
          acc[j] = fmaf(yv.z, wv.z, acc[j]);
          acc[j] = fmaf(yv.w, wv.w, acc[j]);
        }
      }
    };
    if constexpr (!kAsym) {
      if (core) {
        for (int ky = 0; ky < 3; ++ky) {
          if (!row_ok[ky]) continue;
          for (int kx = 0; kx < 3; ++kx) {
            if (kx != 1 && L.span == 0) continue;   // d >= w: only padding
            tap(y1s + (ky * L.used + kx * L.span) * kMid, (ky * 3 + kx) * kMid);
          }
        }
      }
    } else {
      // 5x1 down the rows over the tile's 20 columns q = wq + 4 j (no BN,
      // no activation); columns off the image come out 0
      constexpr int kZ = (kTilePx + 4) / kCoreWarps;
      if (core) {
        float zacc[kZ] = {};
        for (int ky = 0; ky < 5; ++ky) {
          if (!row_ok[ky]) continue;
          const float* y = y1s + ky * L.used * kMid;
#pragma unroll
          for (int i = 0; i < kMid; i += 4) {
            const float4 wv = wc4[((ky * kMid + i) / 4) * kMid + m];
#pragma unroll
            for (int j = 0; j < kZ; ++j) {
              const float4 yv =
                  *reinterpret_cast<const float4*>(y + (wq + kCoreWarps * j) * kMid + i);
              zacc[j] = fmaf(yv.x, wv.x, zacc[j]);
              zacc[j] = fmaf(yv.y, wv.y, zacc[j]);
              zacc[j] = fmaf(yv.z, wv.z, zacc[j]);
              zacc[j] = fmaf(yv.w, wv.w, zacc[j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kZ; ++j) zs[(wq + kCoreWarps * j) * kMid + m] = zacc[j];
      }
      __syncthreads();
      if (core)
        for (int kx = 0; kx < 5; ++kx)   // 1x5 along the row
          tap(zs + kx * kMid, (5 + kx) * kMid);
    }
    if (core) {
      const float s2m = __ldg(s2 + m), b2m = __ldg(b2 + m), a2m = __ldg(a2 + m);
#pragma unroll
      for (int j = 0; j < kPx; ++j)
        y2s[(wq + kCoreWarps * j) * kMid + m] = prelu(acc[j] * s2m + b2m, a2m);
    }
  }
  __syncthreads();

  // -- expansion + BN, residual, PReLU: lanes own consecutive output
  // channels (coalesced stores), 4 pixels a thread
  {
    constexpr int kPx = kTilePx * kC / kTileThreads;
    constexpr int kStride = kTileThreads / kC;
    const int c = tid % kC, first = tid / kC;
    float acc[kPx];
#pragma unroll
    for (int j = 0; j < kPx; ++j) acc[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kMid; i += 4) {
      const float4 wv = we4[(i / 4) * kC + c];
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        const float4 yv = *reinterpret_cast<const float4*>(y2s + (first + kStride * j) * kMid + i);
        acc[j] = fmaf(yv.x, wv.x, acc[j]);
        acc[j] = fmaf(yv.y, wv.y, acc[j]);
        acc[j] = fmaf(yv.z, wv.z, acc[j]);
        acc[j] = fmaf(yv.w, wv.w, acc[j]);
      }
    }
    const float s3c = __ldg(s3 + c), b3c = __ldg(b3 + c), aoc = __ldg(ao + c);
    const float* xc = xs + (center * L.used + (kAsym ? 2 : L.span)) * kC;
    float* orow = out + ((size_t)n * h + r) * w * kC;
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      const int p = first + kStride * j;
      if (x0 + p < w) {
        float v = acc[j] * s3c + b3c;
        v += xc[p * kC + c];
        orow[(size_t)(x0 + p) * kC + c] = prelu(v, aoc);
      }
    }
  }
}

// -- bf16: fused_bottleneck_mma, tensor-core sums, the chain's roundings ------

constexpr int kMmaThreads = 256;   // 8 warps
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kXLd = kC + 8;       // padded x pixel row (elements): ldmatrix without conflicts
constexpr int kYLd = kMid + 8;     // padded y1 / z / y2 pixel row
// Weight fragments, in 8-byte words a lane (32 lanes a block), one block
// per (k16 step, n8 tile) of each B matrix, k-major: the projection (8 x 4
// blocks), the core taps (2 x taps x 4) and the expansion (2 x 16).
constexpr int kWpBlocks = (kC / 16) * (kMid / 8);
constexpr int kWeBlocks = (kMid / 16) * (kC / 8);
__host__ __device__ constexpr int core_blocks(bool asym) { return (asym ? 10 : 9) * 2 * (kMid / 8); }
__host__ __device__ constexpr int pack_bytes(bool asym) {
  return (kWpBlocks + core_blocks(asym) + kWeBlocks) * 32 * 8;
}

// How far a tensor-core sum may lie from the FMA chain's (see the notes at
// the top): E = kErrAbs A + kErrAcc Q, about twice the worst case of each
// term (1.5 2^-19 A, 17 2^-24 Q).
constexpr float kErrAbs = 0x1p-17f;
constexpr float kErrAcc = 0x1p-18f;
constexpr uint32_t kAbs2 = 0x7fff7fffu;   // |.| of two packed bf16
constexpr uint32_t kUnsure = 0x10000u;    // not a bf16 bit pattern

// Shared memory of one CTA, offsets in bytes: the weight fragments, x (the
// tile's rows, `cols` = `used` rounded up to whole 16-pixel m tiles), y1,
// the 5x1 result, y2, and the queue of elements the chain recomputes.
struct MmaTile {
  Tile t;
  int cols, xs, y1, z, y2, fix, total;
};

__host__ __device__ inline MmaTile mma_tile(bool asym, int w, int dil) {
  MmaTile s;
  s.t = tile_of(asym, w, dil);
  s.cols = (s.t.used + 15) / 16 * 16;
  const int px = s.t.rows * s.cols;
  s.xs = pack_bytes(asym);
  s.y1 = s.xs + 2 * px * kXLd;
  s.z = s.y1 + 2 * px * kYLd;
  s.y2 = s.z + (asym ? 2 * 32 * kYLd : 0);
  s.fix = s.y2 + 2 * kTilePx * kYLd;
  s.total = s.fix + 2 * (px * kMid > kTilePx * kC ? px * kMid : kTilePx * kC);
  return s;
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  return *reinterpret_cast<const uint16_t*>(&h);
}

__device__ __forceinline__ void put_bits(__nv_bfloat16* p, uint32_t bits) {
  *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(bits);
}

// The value a rounding point rounds, from an f32 sum v: t = fma(v, s, b)
// (+ r for the output's residual), then PReLU with slope a; the 5x1 result
// is v itself (kId).  Monotone in v on either side of t = 0.
enum Point { kAct, kOut, kId };

template <Point kP>
__device__ __forceinline__ float pre_act(float v, float s, float b, float r) {
  if constexpr (kP == kId) return v;
  const float t = __fmaf_rn(v, s, b);
  if constexpr (kP == kOut) return __fadd_rn(t, r);
  return t;
}

template <Point kP>
__device__ __forceinline__ float finish(float t, float a) {
  if constexpr (kP == kId) return t;
  return t >= 0.f ? t : __fmul_rn(a, t);
}

// The bf16 bits of every f32 sum within e of acc, or kUnsure where they
// are not all the same, lie astride the activation's kink, or include a
// zero that is not a negative one's.  e = 0 only when every product is 0:
// acc is then the chain's +0.  Branch-free, so that a lane settles its
// elements side by side.
template <Point kP>
__device__ __forceinline__ uint32_t settle(float acc, float e, float s, float b, float r,
                                          float a) {
  const float tl = pre_act<kP>(__fsub_rn(acc, e), s, b, r);
  const float th = pre_act<kP>(__fadd_rn(acc, e), s, b, r);
  const uint32_t bl = bf16_bits(finish<kP>(tl, a)), bh = bf16_bits(finish<kP>(th, a));
  const bool neg = kP != kId && tl < 0.f && th < 0.f;
  const bool kink = kP != kId && !neg && (tl < 0.f || th < 0.f);
  const bool unsure = bl != bh || kink || ((bl & 0x7fffu) == 0 && !neg);
  return unsure && e != 0.f ? kUnsure : bl;
}

__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// The FMA chain acc = fma(v[i], B[k0 + i][n], acc) over i = 0 .. len - 1 in
// order, B a fragment-ordered (K, n_all) matrix (blocks (k16, n8), k-major;
// lane 4g + t of a block holds rows 2t, 2t + 1 and 2t + 8, 2t + 9 of column
// g, so one column's 16 rows of a block are 32 contiguous bytes); k0 and
// len are multiples of 16, v is on 16 bytes.
__device__ __forceinline__ float chain(const __nv_bfloat16* v, const uint2* f, int n_all, int k0,
                                       int n, int len, float acc) {
  const uint2* col = f + (k0 >> 4) * (n_all >> 3) * 32 + (n >> 3) * 32 + ((n & 7) << 2);
  for (int k = 0; k < len; k += 16, col += (n_all >> 3) * 32) {
    const uint4 va = *reinterpret_cast<const uint4*>(v + k);       // inputs k .. k + 7
    const uint4 vb = *reinterpret_cast<const uint4*>(v + k + 8);   // k + 8 .. k + 15
    const uint4 w0 = *reinterpret_cast<const uint4*>(col);         // rows 0 1, 8 9, 2 3, 10 11
    const uint4 w1 = *reinterpret_cast<const uint4*>(col + 2);     // rows 4 5, 12 13, 6 7, 14 15
    const uint32_t vv[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
    const uint32_t ww[8] = {w0.x, w0.z, w1.x, w1.z, w0.y, w0.w, w1.y, w1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc = __fmaf_rn(lo_bf16(vv[i]), lo_bf16(ww[i]), acc);
      acc = __fmaf_rn(hi_bf16(vv[i]), hi_bf16(ww[i]), acc);
    }
  }
  return acc;
}

// One k16 step of n8 tiles j < kN: d = a . b[j] issued for every tile first
// (no result waits on the one before), then c += d rounded to nearest, with
// the error terms: q += |c| before the step, s += |a| . |b|.
template <int kN>
__device__ __forceinline__ void mma_step(float (&c)[kN][4], float (&q)[kN][4],
                                         float (&s)[kN][4], const uint32_t (&a)[4],
                                         const uint2 (&b)[kN]) {
  uint32_t aa[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) aa[i] = a[i] & kAbs2;
  float d[kN][4];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
    mma_bf16(d[j], a, b[j].x, b[j].y);
    mma_bf16(s[j], aa, b[j].x & kAbs2, b[j].y & kAbs2);
  }
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      q[j][e] += fabsf(c[j][e]);
      c[j][e] = __fadd_rn(c[j][e], d[j][e]);
    }
}

// E of an element: how far its sum may lie from the chain's.
__device__ __forceinline__ float bound(float acc, float q, float s) {
  return kErrAbs * s + kErrAcc * (q + fabsf(acc));
}

// Queue slots for a lane's `cnt` elements: one atomic a warp (every lane
// of the warp calls it).
__device__ __forceinline__ int queue_slots(int* count, int cnt) {
  const int lane = threadIdx.x & 31;
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  int base = 0;
  if (lane == 31 && incl) base = atomicAdd(count, incl);
  return __shfl_sync(0xffffffffu, base, 31) + incl - cnt;
}

// wpack: wp (c, mid), the core taps (taps x mid, mid) and we (mid, c),
// rounded to bf16, each in fragment order, one after the other.
template <bool kAsym>
__global__ void __launch_bounds__(kMmaThreads)
fused_bottleneck_mma(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                     int h, int w, int dil, const uint2* __restrict__ wpack,
                     const float* __restrict__ s1, const float* __restrict__ b1,
                     const float* __restrict__ a1, const float* __restrict__ s2,
                     const float* __restrict__ b2, const float* __restrict__ a2,
                     const float* __restrict__ s3, const float* __restrict__ b3,
                     const float* __restrict__ ao) {
  // its own name: the f32 kernel's dynamic shared array is smem_tile
  extern __shared__ __align__(128) unsigned char smem_mma[];
  __shared__ int nfix[4];   // queued: projection, 5x1, core, expansion
  const MmaTile L = mma_tile(kAsym, w, dil);
  const int cols = L.cols, used = L.t.used, span = L.t.span;
  const uint2* wp_f = reinterpret_cast<const uint2*>(smem_mma);
  const uint2* core_f = wp_f + kWpBlocks * 32;
  const uint2* we_f = core_f + core_blocks(kAsym) * 32;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_mma + L.xs);   // [row][col][c]
  __nv_bfloat16* y1s = reinterpret_cast<__nv_bfloat16*>(smem_mma + L.y1);  // [row][col][m]
  __nv_bfloat16* zs = reinterpret_cast<__nv_bfloat16*>(smem_mma + L.z);    // [col][m], 5x1
  __nv_bfloat16* y2s = reinterpret_cast<__nv_bfloat16*>(smem_mma + L.y2);  // [px][m]
  uint16_t* fix = reinterpret_cast<uint16_t*>(smem_mma + L.fix);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mrow = lane & 7, mhi = (lane >> 3) & 1, mtop = lane >> 4;
  const int x0 = blockIdx.x * kTilePx, r = blockIdx.y, n = blockIdx.z;
  constexpr int kRows = kAsym ? 5 : 3;
  const int step = kAsym ? 1 : dil, center = kRows / 2;
  const __nv_bfloat16* xn = x + (size_t)n * h * w * kC;
  if (tid < 4) nfix[tid] = 0;
  bool row_ok[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int ir = r + (k - center) * step;
    row_ok[k] = ir >= 0 && ir < h;
  }
  // tile column -> whether it holds an image pixel the core reads
  auto in_image = [&](int col) {
    if (col >= used) return false;
    const int ic = image_col(L.t, kAsym, x0, dil, col);
    return ic >= 0 && ic < w;
  };

  // -- loads, issued together: x pixels and the projection weights, then
  // the other weights
  {
    const int vecs = kRows * cols * (kC / 8);
    for (int i = tid; i < vecs; i += kMmaThreads) {
      const int px = i / (kC / 8), v = (i % (kC / 8)) * 8, k = px / cols;
      if (!row_ok[k]) continue;   // a padding row: the core skips it
      const int ir = r + (k - center) * step, col = px % cols;
      const bool ok = in_image(col);
      const int ic = ok ? image_col(L.t, kAsym, x0, dil, col) : 0;
      cp_async16(xs + px * kXLd + v, xn + ((size_t)ir * w + ic) * kC + v, ok);
    }
    const char* src = reinterpret_cast<const char*>(wpack);
    char* dst = reinterpret_cast<char*>(smem_mma);
    const int first = kWpBlocks * 32 * 8 / 16, all = pack_bytes(kAsym) / 16;
    for (int i = tid; i < first; i += kMmaThreads) cp_async16(dst + 16 * i, src + 16 * i, true);
    cp_async_commit();
    for (int i = first + tid; i < all; i += kMmaThreads)
      cp_async16(dst + 16 * i, src + 16 * i, true);
    cp_async_commit();
  }

  // -- projection: y1 = PReLU(BN(x @ wp)) over the tile, an m16 tile (16
  // pixels x 32 channels) a warp at a time; a lane's channels are
  // 8 j + 2 t + {0, 1}
  {
    float vs[8], vb[8], va[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = (i >> 1) * 8 + 2 * t + (i & 1);
      vs[i] = __ldg(s1 + c), vb[i] = __ldg(b1 + c), va[i] = __ldg(a1 + c);
    }
    cp_async_wait<1>();
    __syncthreads();
    for (int mt = warp; mt < kRows * cols / 16; mt += kMmaWarps) {
      const int p0 = mt * 16;
      if (!row_ok[p0 / cols]) continue;
      float acc[4][4] = {}, q[4][4] = {}, sa[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, smem_u32(xs + (p0 + mrow + mhi * 8) * kXLd + kk * 16 + mtop * 8));
        uint2 bw[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) bw[j] = wp_f[(kk * (kMid / 8) + j) * 32 + lane];
        mma_step<4>(acc, q, sa, a, bw);
      }
      const int col = p0 % cols + g;
      const bool in[2] = {in_image(col), in_image(col + 8)};
      uint32_t bits[4][4];
      int cnt = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 2 * j + (e & 1);
          bits[j][e] = in[e >> 1] ? settle<kAct>(acc[j][e], bound(acc[j][e], q[j][e], sa[j][e]),
                                                 vs[i], vb[i], 0.f, va[i])
                                  : 0u;
          cnt += bits[j][e] == kUnsure;
        }
      int slot = queue_slots(&nfix[0], cnt);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = p0 + g + 8 * (e >> 1), c = j * 8 + 2 * t + (e & 1);
          if (bits[j][e] == kUnsure)
            fix[slot++] = p * kMid + c;
          else
            put_bits(y1s + p * kYLd + c, bits[j][e]);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < nfix[0]; i += kMmaThreads) {
    const int p = fix[i] / kMid, c = fix[i] % kMid;
    const float v = chain(xs + p * kXLd, wp_f, kMid, 0, c, kC, 0.f);
    y1s[p * kYLd + c] = __float2bfloat16_rn(finish<kAct>(pre_act<kAct>(
        v, __ldg(s1 + c), __ldg(b1 + c), 0.f), __ldg(a1 + c)));
  }
  __syncthreads();

  // -- core: implicit GEMM over the shifted y1 rows, an m16 x n8 tile a
  // warp, K in tap order; taps on padding rows add nothing and are skipped
  float acc[1][4], q[1][4], sa[1][4];
  auto clear = [&]() {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][e] = q[0][e] = sa[0][e] = 0.f;
  };
  auto tap = [&](const __nv_bfloat16* a_rows, int blk, int j) {
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      uint32_t a[4];
      ldsm_x4(a, smem_u32(a_rows + (mrow + mhi * 8) * kYLd + kh * 16 + mtop * 8));
      const uint2 bw[1] = {core_f[((blk * 2 + kh) * (kMid / 8) + j) * 32 + lane]};
      mma_step<1>(acc, q, sa, a, bw);
    }
  };
  if constexpr (kAsym) {
    // 5x1 down the rows over the tile's first 32 columns (the 1x5 reads
    // 20), rounded to bf16 (no BN, no activation), warp = (m16 tile, n8
    // tile); columns off the image come out 0
    {
      const int mt = warp >> 2, ch = (warp & 3) * 8 + 2 * t;
      clear();
      for (int ky = 0; ky < 5; ++ky)
        if (row_ok[ky]) tap(y1s + (ky * cols + mt * 16) * kYLd, ky, warp & 3);
      uint32_t bits[4];
      int cnt = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = mt * 16 + g + 8 * (e >> 1);
        bits[e] = col < used ? settle<kId>(acc[0][e], bound(acc[0][e], q[0][e], sa[0][e]),
                                           0.f, 0.f, 0.f, 0.f)
                             : 0u;
        cnt += bits[e] == kUnsure;
      }
      int slot = queue_slots(&nfix[1], cnt);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = mt * 16 + g + 8 * (e >> 1), c = ch + (e & 1);
        if (bits[e] == kUnsure)
          fix[slot++] = col * kMid + c;
        else
          put_bits(zs + col * kYLd + c, bits[e]);
      }
    }
    __syncthreads();
    for (int i = tid; i < nfix[1]; i += kMmaThreads) {
      const int col = fix[i] / kMid, c = fix[i] % kMid;
      float v = 0.f;
      for (int ky = 0; ky < 5; ++ky)
        if (row_ok[ky]) v = chain(y1s + (ky * cols + col) * kYLd, core_f, kMid, ky * kMid, c,
                                  kMid, v);
      zs[col * kYLd + c] = __float2bfloat16_rn(v);
    }
    __syncthreads();
  }
  if (warp < kMid / 8) {   // the core's four n8 tiles
    const int ch = warp * 8 + 2 * t;
    clear();
    if constexpr (!kAsym) {
      for (int ky = 0; ky < 3; ++ky) {
        if (!row_ok[ky]) continue;
        for (int kx = 0; kx < 3; ++kx) {
          if (kx != 1 && span == 0) continue;   // d >= w: only padding
          tap(y1s + (ky * cols + kx * span) * kYLd, ky * 3 + kx, warp);
        }
      }
    } else {
      for (int kx = 0; kx < 5; ++kx) tap(zs + kx * kYLd, 5 + kx, warp);   // 1x5 along the row
    }
    const float cs[2] = {__ldg(s2 + ch), __ldg(s2 + ch + 1)};
    const float cb[2] = {__ldg(b2 + ch), __ldg(b2 + ch + 1)};
    const float ca[2] = {__ldg(a2 + ch), __ldg(a2 + ch + 1)};
    uint32_t bits[4];
    int cnt = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = g + 8 * (e >> 1);
      bits[e] = x0 + p < w ? settle<kAct>(acc[0][e], bound(acc[0][e], q[0][e], sa[0][e]),
                                          cs[e & 1], cb[e & 1], 0.f, ca[e & 1])
                           : 0u;
      cnt += bits[e] == kUnsure;
    }
    int slot = queue_slots(&nfix[2], cnt);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = g + 8 * (e >> 1), c = ch + (e & 1);
      if (bits[e] == kUnsure)
        fix[slot++] = p * kMid + c;
      else
        put_bits(y2s + p * kYLd + c, bits[e]);
    }
  }
  __syncthreads();
  for (int i = tid; i < nfix[2]; i += kMmaThreads) {
    const int p = fix[i] / kMid, c = fix[i] % kMid;
    float v = 0.f;
    if constexpr (!kAsym) {
      for (int ky = 0; ky < 3; ++ky) {
        if (!row_ok[ky]) continue;
        for (int kx = 0; kx < 3; ++kx) {
          if (kx != 1 && span == 0) continue;
          v = chain(y1s + (ky * cols + kx * span + p) * kYLd, core_f, kMid,
                    (ky * 3 + kx) * kMid, c, kMid, v);
        }
      }
    } else {
      for (int kx = 0; kx < 5; ++kx)
        v = chain(zs + (p + kx) * kYLd, core_f, kMid, (5 + kx) * kMid, c, kMid, v);
    }
    y2s[p * kYLd + c] = __float2bfloat16_rn(finish<kAct>(pre_act<kAct>(
        v, __ldg(s2 + c), __ldg(b2 + c), 0.f), __ldg(a2 + c)));
  }
  __syncthreads();

  // -- expansion + BN + residual + PReLU, 16 output channels a warp (two n8
  // tiles); the result replaces the x pixels it read (the centre row of
  // the tile), queued ones once the chain has them
  __nv_bfloat16* xc = xs + (center * cols + (kAsym ? 2 : span)) * kXLd;
  {
    float e4[2][4] = {}, qe[2][4] = {}, se[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < kMid / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, smem_u32(y2s + (mrow + mhi * 8) * kYLd + kk * 16 + mtop * 8));
      uint2 bw[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) bw[jj] = we_f[(kk * (kC / 8) + warp * 2 + jj) * 32 + lane];
      mma_step<2>(e4, qe, se, a, bw);
    }
    constexpr uint32_t kSkip = 0x20000u;   // a pixel past the image's edge
    uint32_t bits[2][4];
    int cnt = 0;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = g + 8 * (e >> 1), c = (warp * 2 + jj) * 8 + 2 * t + (e & 1);
        bits[jj][e] = x0 + p < w
            ? settle<kOut>(e4[jj][e], bound(e4[jj][e], qe[jj][e], se[jj][e]), __ldg(s3 + c),
                           __ldg(b3 + c), __bfloat162float(xc[p * kXLd + c]), __ldg(ao + c))
            : kSkip;
        cnt += bits[jj][e] == kUnsure;
      }
    int slot = queue_slots(&nfix[3], cnt);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = g + 8 * (e >> 1), c = (warp * 2 + jj) * 8 + 2 * t + (e & 1);
        if (bits[jj][e] == kUnsure)
          fix[slot++] = p * kC + c;
        else if (bits[jj][e] != kSkip)
          put_bits(xc + p * kXLd + c, bits[jj][e]);
      }
  }
  __syncthreads();
  for (int i = tid; i < nfix[3]; i += kMmaThreads) {
    const int p = fix[i] / kC, c = fix[i] % kC;
    __nv_bfloat16* px = xc + p * kXLd + c;
    const float v = chain(y2s + p * kYLd, we_f, kC, 0, c, kMid, 0.f);
    *px = __float2bfloat16_rn(finish<kOut>(pre_act<kOut>(
        v, __ldg(s3 + c), __ldg(b3 + c), __bfloat162float(*px)), __ldg(ao + c)));
  }
  __syncthreads();
  __nv_bfloat16* orow = out + ((size_t)n * h + r) * w * kC;
  for (int i = tid; i < kTilePx * (kC / 8); i += kMmaThreads) {
    const int p = i / (kC / 8), v = (i % (kC / 8)) * 8;
    if (x0 + p < w)
      *reinterpret_cast<uint4*>(orow + (size_t)(x0 + p) * kC + v) =
          *reinterpret_cast<const uint4*>(xc + p * kXLd + v);
  }
}

cudaError_t smem_limit(int* limit) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return (bits & 15) == 0;
}

// Set the kernel's dynamic shared memory to `bytes`, or refuse it.
template <typename K>
cudaError_t reserve_smem(K kernel, int bytes) {
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  if (bytes > limit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int smem_bytes(bool asym, int w, int dil, bool bf16) {
  return bf16 ? mma_tile(asym, w, dil).total : smem_layout(asym, w, dil).total;
}

// p: wp, s1, b1, a1, wcore, s2, b2, a2, we, s3, b3, ao (f32).
template <bool kAsym>
cudaError_t launch_tile(const void* x, void* out, int n, int h, int w, int dil,
                        const float* const* p, cudaStream_t stream) {
  if (!aligned16({x, out, p[0], p[4], p[8]})) return cudaErrorMisalignedAddress;
  auto kernel = fused_bottleneck_tile<kAsym>;
  const int bytes = smem_bytes(kAsym, w, dil, false);
  cudaError_t err = reserve_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kTilePx - 1) / kTilePx, h, n);
  kernel<<<grid, kTileThreads, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out), h, w, dil, p[0], p[4], p[8],
      p[1], p[2], p[3], p[5], p[6], p[7], p[9], p[10], p[11]);
  return cudaGetLastError();
}

template <bool kAsym>
cudaError_t launch_mma(const void* x, void* out, int n, int h, int w, int dil,
                       const void* wpack, const float* const* p, cudaStream_t stream) {
  if (!aligned16({x, out, wpack})) return cudaErrorMisalignedAddress;
  auto kernel = fused_bottleneck_mma<kAsym>;
  const int bytes = smem_bytes(kAsym, w, dil, true);
  cudaError_t err = reserve_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kTilePx - 1) / kTilePx, h, n);
  kernel<<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), h, w, dil,
      static_cast<const uint2*>(wpack), p[1], p[2], p[3], p[5], p[6], p[7], p[9], p[10], p[11]);
  return cudaGetLastError();
}

bool bad_args(int n, int h, int w, int c, int mid, int dilation) {
  return c != kC || mid != kMid || n < 1 || h < 1 || w < 1 || n > 65535 || h > 65535 ||
         dilation < 1;
}

}  // namespace

extern "C" {

// Shared memory one launch needs, in bytes (the wrapper reports it).
int bugcar_fused_bottleneck_smem_bytes(int asym, int w, int dilation, int dtype) {
  return smem_bytes(asym != 0, w, asym ? 1 : dilation, dtype == 1);
}

// How a launch is cut: plan[0] CTAs, [1] threads a CTA, [2] output pixels
// a CTA, [3] y1 rows and [4] y1 columns a CTA projects (for bf16 those the
// core reads; the kernel projects them in whole 16-pixel tiles).  Returns
// a cudaError_t.
int bugcar_fused_bottleneck_plan(int n, int h, int w, int asym, int dilation, int dtype,
                                 int* plan) {
  if (bad_args(n, h, w, kC, kMid, dilation) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Tile t = tile_of(asym != 0, w, asym ? 1 : dilation);
  plan[0] = (w + kTilePx - 1) / kTilePx * h * n;
  plan[1] = dtype == 1 ? kMmaThreads : kTileThreads;
  plan[2] = kTilePx;
  plan[3] = t.rows;
  plan[4] = t.used;
  return 0;
}

// x, out: (n, h, w, c) contiguous, float32 (dtype 0) or bfloat16 (dtype 1).
// wp (c, mid); wcore (9, mid, mid) or, for asym, the (5, mid, mid) 5x1 taps
// followed by the (5, mid, mid) 1x5 taps; we (mid, c); all [in][out] f32,
// read by the f32 kernel.  wpack, read for bf16: the same three matrices
// rounded to bf16, each in mma fragment order, one after the other
// (ops/cuda/bottleneck.pack_weights).  The f32 BatchNorm vectors and PReLU
// slopes serve both.  x, out and the weights start on 16 bytes.  Returns
// a cudaError_t (0 = launched).
int bugcar_fused_bottleneck(const void* x, void* out, int n, int h, int w, int c, int mid,
                            const float* wp, const float* s1, const float* b1,
                            const float* a1, const float* wcore, const float* s2,
                            const float* b2, const float* a2, const float* we,
                            const float* s3, const float* b3, const float* ao,
                            const void* wpack, int asym, int dilation, int dtype,
                            void* stream) {
  if (bad_args(n, h, w, c, mid, dilation) || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && !wpack))
    return (int)cudaErrorInvalidValue;
  const float* p[12] = {wp, s1, b1, a1, wcore, s2, b2, a2, we, s3, b3, ao};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = asym ? 1 : dilation;
  cudaError_t err;
  if (dtype == 0) {
    err = asym ? launch_tile<true>(x, out, n, h, w, d, p, s)
               : launch_tile<false>(x, out, n, h, w, d, p, s);
  } else {
    err = asym ? launch_mma<true>(x, out, n, h, w, d, wpack, p, s)
               : launch_mma<false>(x, out, n, h, w, d, wpack, p, s);
  }
  return (int)err;
}

const char* bugcar_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
