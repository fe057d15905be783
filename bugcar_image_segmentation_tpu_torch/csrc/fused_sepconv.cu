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
// weights' bytes.  In practice a CTA's chain of dependent phases, and the
// weights re-read from L2 by every pixel tile, set its time.
//
// bf16 (sepconv_bf16): one CTA of 256 threads takes a tile of kTR x 8
// output pixels of one image (kTR = 8, or 4 where C is too wide for a
// 64-pixel y1 in shared memory) and runs in two phases.  Its bf16 operands
// lie in shared memory as 8 x 8 core matrices (8 rows of 16 bytes).
//  1. Depthwise, once per output pixel per launch.  The tile's input window
//     ((kTR + 2) x 10 pixels at stride 1, (2 kTR + 1) x 17 at stride 2, the
//     columns of the latter split by parity) is staged 32 channels at a time
//     in four 8-channel planes with 16-byte cp.async, three chunks in flight,
//     the chunk's f32 taps and BN beside it; the zero fill gives both
//     paddings.  A thread takes 8 channels of one pixel (neighbouring
//     threads, neighbouring pixels: conflict-free 16-byte shared loads), the
//     taps as f32, fmaf in (dy, dx) order, the affine and ReLU, and rounds y1
//     to bf16 once.  Where one image's pixel tiles are too few for 132 SMs
//     (the middle flow's 32), a thread block cluster of G <= 8 CTAs shares a
//     tile: each computes C / G of y1's channels and writes them into every
//     peer's y1 through distributed shared memory, cluster.sync(), then each
//     multiplies its share of the F tiles on the full y1.  (Before, each CTA
//     that split F recomputed the whole depthwise from scalar global loads.)
//  2. Pointwise on the tensor cores, two F tiles (64 x 128 outputs) a step:
//     y1 stays resident; the weights stream through a ring of 2-4 stages of
//     64 K x 128 F chunks, each two 64 x 64 TMA boxes with 128-byte swizzle
//     completing on the stage's mbarrier (two lanes issue them; the first
//     ones before phase 1), so no register, load unit or proxy fence touches
//     them.  kTR = 8: wgmma m64n64k16, one warpgroup per 64 columns, A (y1)
//     and B (the chunk, N-major) read from shared memory by descriptor, one
//     step's products in flight while the previous step's slot is refilled.
//     kTR = 4: mma.sync m16n8k16 through ldmatrix.  Epilogue: the f32 affine,
//     an optional ReLU, one cast, the 64 x 128 tile staged in the idle window
//     buffers and stored 16 bytes a thread, masked at the ragged ends (pixels
//     past the map, C and F not multiples of 64, e.g. 728).  The measured
//     order of changes: wgmma with cp.async weights was no faster than
//     mma.sync (the generic-to-async proxy fence each chunk needs, and the
//     load units, set the step); TMA with 16-byte boxes no better; 64 x 64
//     swizzled boxes halved the step time (scripts/torch_sepconv_split.py).
// The plan -- tile rows, cluster size G, ring stages -- comes from the
// wrapper (ops/cuda/sepconv.py plan()), a function of (H, W, C, F, stride)
// alone, and is checked here; the channel slices and F-tile ranges follow
// from G by one formula.  Every output element runs the same instructions,
// K in the same order, whichever CTA owns it and however large the batch
// is, so a frame's result does not depend on its batch.  C or F not a
// multiple of 8 (or unaligned operands) load element by element instead of
// by cp.async / TMA; the arithmetic is the same.
//
// f32 (sepconv_f32, SIMT, the first design): one CTA of 256 threads takes 64
// consecutive output pixels; phase 1 reads the 3x3 windows straight from
// device memory into an f32 y1 in shared memory, phase 2 streams the
// weights through shared memory 64 input channels at a time (register
// prefetch) into f32 FMAs, 2x8 outputs a thread; the F tiles are split over
// G CTAs of the same plan, each recomputing the depthwise.
//
// Built by plain nvcc into a shared library with a C interface (no PyTorch
// headers); bound with ctypes by ops/cuda/build.py.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ptx.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;    // 8 warps
constexpr int kTileF = 64;       // output channels per F tile
constexpr int kKStep = 64;       // input channels per weight chunk
constexpr int kSmemMax = 232448;  // dynamic shared memory a CTA may use

// -- the plan -----------------------------------------------------------------

// Mirrors ops/cuda/sepconv.py: shapes and shared-memory layout of a launch.
// bf16 operands live in shared memory as 8 x 8 "core matrices" (8 rows of
// 16 contiguous bytes, 128 bytes each): the layout wgmma reads without
// swizzling, and the one ldmatrix reads without bank conflicts.
constexpr int kTileC = 8;         // output columns of a pixel tile
constexpr int kDwChunk = 32;      // channels of a window chunk (4 planes of 8)
constexpr int kWinBufs = 3;       // window chunks in flight: this one and two ahead
constexpr int kStepF = 2 * kTileF;  // output channels a pointwise step multiplies
constexpr int kRingStage = kKStep * kStepF * 2;   // bytes of one weight chunk

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }
__host__ __device__ constexpr int win_rows(int tr, int stride) { return stride == 1 ? tr + 2 : 2 * tr + 1; }
__host__ __device__ constexpr int win_cols(int stride) { return stride == 1 ? kTileC + 2 : 2 * kTileC + 1; }
// Bytes between the window's channel planes: the plane rounded up to 128,
// plus 32, so that the 4 planes of one pixel start on different banks.
__host__ __device__ constexpr int win_plane(int tr, int stride) {
  return round_up(win_rows(tr, stride) * win_cols(stride) * 16, 128) + 32;
}

struct Layout {   // byte offsets in dynamic shared memory
  int win, filt, ring, bars, total;
};

__host__ __device__ inline Layout layout(int tr, int c, int stride, int stages) {
  Layout l;
  l.win = tr * kTileC * round_up(c, kKStep) * 2;                      // y1 first
  l.filt = l.win + round_up(kWinBufs * (kDwChunk / 8) * win_plane(tr, stride), 128);
  l.ring = round_up(l.filt + kWinBufs * 11 * kDwChunk * 4, 1024);   // 128-byte swizzle atoms
  l.bars = l.ring + stages * kRingStage;   // one mbarrier per ring stage
  l.total = l.bars + 4 * 8;
  return l;
}

struct Plan {
  int n, h, w, c, f, ho, wo, stride;
  int tiles_w;     // pixel tiles across the output width
  int cluster;     // G: CTAs sharing a pixel tile
  int stages;      // weight ring depth
  int vec;         // 16-byte copies (C, F multiples of 8, aligned operands)
  Layout lay;
};

// -- PTX helpers (besides ptx.cuh's) ---------------------------------------------

// 4-byte asynchronous copy global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
// One TMA box (64 F x 64 K of the weights) into shared memory, completing
// on the mbarrier; out-of-range elements arrive as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int f, int k,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(f), "r"(k), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, no swizzle: start, LBO = byte stride of
// core matrices along K, SBO = along M (A) or N (B).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, int lbo, int sbo) {
  return (uint64_t)((addr >> 4) & 0x3fff) | ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32);
}
// d += a . b over one warpgroup: m64n64k16, bf16, f32 accumulator; A
// K-major, B N-major (transposed), both from shared memory.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(1));
}

// -- bf16: window in shared memory, cluster-shared y1, tensor-core pointwise ----

// Byte offset of weights (row k, columns 8 q..8 q + 7) in a ring chunk: two
// boxes of 64 rows x 128 bytes (columns 0-63, 64-127), the 16-byte pieces
// of row k XOR-swizzled by k % 8 (TMA's and wgmma's 128-byte swizzle).
__device__ __forceinline__ int ring_at(int k, int q) {
  return (q >> 3) * (kKStep * 128) + k * 128 + (((q & 7) ^ (k & 7)) << 4);
}

// Window column slot: stride 2 stores even columns first, then odd ones.
__device__ __forceinline__ int win_slot(int wx, int stride) {
  return stride == 1 ? wx : (wx & 1) * (kTileC + 1) + (wx >> 1);
}

// kTR = 8: the pointwise on wgmma, one warpgroup per 64 of the step's 128
// columns; kTR = 4 (32 pixels, only where C is too wide for 64): mma.sync
// through ldmatrix, 2 x 4 warps of 16 x 32.
template <int kTR>
__global__ void __launch_bounds__(kThreads, 2)
sepconv_bf16(const __nv_bfloat16* __restrict__ x, const float* __restrict__ taps,
             const float* __restrict__ s1, const float* __restrict__ b1,
             const __nv_bfloat16* __restrict__ wpw, const __grid_constant__ CUtensorMap wmap,
             const float* __restrict__ s2, const float* __restrict__ b2,
             __nv_bfloat16* __restrict__ out, Plan pl, int act_out) {
  constexpr int kM = kTR * kTileC;          // pixels of the tile (64 or 32)
  constexpr bool kWgmma = kM == 64;
  constexpr int kNJ = kWgmma ? 8 : 4;       // n8 tiles of a thread's accumulator
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = pl.cluster;
  const int rank = (int)(blockIdx.x % G);
  const int ty = blockIdx.y, tx = blockIdx.x / G, n = blockIdx.z;
  const int c = pl.c, f = pl.f, stride = pl.stride;
  const int cp = round_up(c, kKStep);       // y1's channels, zero-padded
  const int wr = win_rows(kTR, stride), wc = win_cols(stride);
  const int plane = win_plane(kTR, stride);
  unsigned char* y1 = smem;                 // core matrices (pixel group, channel group)
  unsigned char* win = smem + pl.lay.win;   // [buffer][channel plane][wy][slot] x 16 bytes
  float* filt = reinterpret_cast<float*>(smem + pl.lay.filt);
  unsigned char* ring = smem + pl.lay.ring;  // [stage] core matrices (F group, K group)
  const uint32_t y1_s = smem_u32(y1), ring_s = smem_u32(ring);
  const uint32_t bars_s = smem_u32(smem + pl.lay.bars);
  // byte offset of y1's (pixel p, channels c8..c8 + 7)
  auto y1_at = [&](int p, int c8) { return ((p >> 3) * (cp >> 3) + (c8 >> 3)) * 128 + (p & 7) * 16; };

  // this CTA's channel slice (whole groups of 8) and F tiles
  const int groups = (c + 7) / 8;
  const int c_lo = 8 * (rank * groups / G), c_hi = min(c, 8 * ((rank + 1) * groups / G));
  const int nft = (f + kTileF - 1) / kTileF;
  const int ft_lo = rank * nft / G, ft_hi = (rank + 1) * nft / G;
  const int f_end = min(f, ft_hi * kTileF);   // this CTA's F range ends here
  const int nk = cp / kKStep;
  const int steps = (ft_hi - ft_lo + 1) / 2 * nk;   // two F tiles a step
  const int stages = pl.stages;

  cg::cluster_group cluster = cg::this_cluster();
  if (G > 1) cluster.sync();   // every peer's shared memory exists before any write

  // the weight ring: chunk after chunk (64 input channels by two F tiles)
  // into slot after slot; a cursor, no divisions.  A chunk is two boxes of
  // 64 K rows x 64 F (128 bytes), 16-byte pieces swizzled by the row
  // (ring_at).  With 16-byte aligned rows it comes by TMA, two lanes
  // issuing, completing on the slot's mbarrier: the async proxy that wgmma
  // reads, no register or load-unit traffic, zeros past C and F.
  // Otherwise every thread stores it element by element.
  if (pl.vec && tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars_s + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int ld_slot = 0, ld_k0 = 0, ld_f0 = ft_lo * kTileF;
  auto load_weights = [&]() {
    unsigned char* dst = ring + ld_slot * kRingStage;
    if (pl.vec) {
      if (warp == 0) {   // lane b loads box b
        const uint32_t bar = bars_s + 8 * ld_slot;
        if (lane == 0) mbar_expect_tx(bar, kRingStage);
        __syncwarp();
        if (lane < 2)
          tma_load_2d(smem_u32(dst) + lane * kKStep * 128, &wmap, ld_f0 + 64 * lane, ld_k0, bar);
      }
    } else {
      for (int e = tid; e < kKStep * kStepF / 8; e += kThreads) {
        const int q = e / kKStep, k = ld_k0 + e % kKStep, f8 = ld_f0 + q * 8;
        __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst + ring_at(e % kKStep, q));
        for (int q = 0; q < 8; ++q)
          d[q] = k < c && f8 + q < f_end ? wpw[(size_t)k * f + f8 + q] : __float2bfloat16_rn(0.f);
      }
      fence_proxy_async();   // generic stores before wgmma's reads
    }
    ld_slot = ld_slot + 1 == stages ? 0 : ld_slot + 1;
    ld_k0 += kKStep;
    if (ld_k0 >= c) {
      ld_k0 = 0;
      ld_f0 += kStepF;
    }
  };
  for (int s = 0; s < stages - 1 && s < steps; ++s) load_weights();

  // y1's padding channels [8 * groups, C rounded up to 64) are zero
  for (int e = tid; e < kM * (cp / 8 - groups); e += kThreads) {
    const int p = e % kM, c8 = 8 * (groups + e / kM);
    *reinterpret_cast<uint4*>(y1 + y1_at(p, c8)) = make_uint4(0, 0, 0, 0);
  }

  // -- phase 1: y1 = bf16(ReLU(depthwise * s1 + b1)) of this CTA's channels
  const int iy0 = stride == 1 ? ty * kTR - 1 : 2 * ty * kTR;
  const int ix0 = stride == 1 ? tx * kTileC - 1 : 2 * tx * kTileC;
  const __nv_bfloat16* img = x + (size_t)n * pl.h * pl.w * c;
  auto load_chunk = [&](int c0, int buf) {
    unsigned char* wdst = win + buf * (kDwChunk / 8) * plane;
    if (pl.vec) {
      for (int i = tid; i < wr * wc * (kDwChunk / 8); i += kThreads) {
        const int wp = i / (kDwChunk / 8), cv = i % (kDwChunk / 8);
        const int wy = wp / wc, wx = wp % wc, iy = iy0 + wy, ix = ix0 + wx;
        const bool ok = iy >= 0 && iy < pl.h && ix >= 0 && ix < pl.w && c0 + 8 * cv < c_hi;
        cp_async16(wdst + cv * plane + (wy * wc + win_slot(wx, stride)) * 16,
                   ok ? img + ((size_t)iy * pl.w + ix) * c + c0 + 8 * cv : x, ok);
      }
    } else {
      for (int i = tid; i < wr * wc * kDwChunk; i += kThreads) {
        const int wp = i / kDwChunk, cc = i % kDwChunk;
        const int wy = wp / wc, wx = wp % wc, iy = iy0 + wy, ix = ix0 + wx;
        const bool ok = iy >= 0 && iy < pl.h && ix >= 0 && ix < pl.w && c0 + cc < c_hi;
        reinterpret_cast<__nv_bfloat16*>(wdst + (cc >> 3) * plane +
                                         (wy * wc + win_slot(wx, stride)) * 16)[cc & 7] =
            ok ? img[((size_t)iy * pl.w + ix) * c + c0 + cc] : __float2bfloat16_rn(0.f);
      }
    }
    // nine taps, scale, bias of the chunk's channels, f32, zero past the slice
    float* fdst = filt + buf * 11 * kDwChunk;
    for (int i = tid; i < 11 * kDwChunk; i += kThreads) {
      const int t = i / kDwChunk, ch = c0 + i % kDwChunk;
      const bool ok = ch < c_hi;
      const float* src = t < 9 ? taps + t * c + ch : (t == 9 ? s1 + ch : b1 + ch);
      cp_async4(fdst + i, ok ? src : taps, ok);
    }
  };
  const int chunks = (c_hi - c_lo + kDwChunk - 1) / kDwChunk;
  for (int i = 0; i < kWinBufs - 1; ++i) {
    if (i < chunks) load_chunk(c_lo + i * kDwChunk, i);
    cp_async_commit();
  }
  for (int i = 0, buf = 0; i < chunks; ++i, buf = buf + 1 == kWinBufs ? 0 : buf + 1) {
    const int c0 = c_lo + i * kDwChunk;
    if (i + kWinBufs - 1 < chunks)
      load_chunk(c0 + (kWinBufs - 1) * kDwChunk, buf == 0 ? kWinBufs - 1 : buf - 1);
    cp_async_commit();
    cp_async_wait<kWinBufs - 1>();
    __syncthreads();
    // thread: pixel p (neighbouring threads, neighbouring pixels), channels
    // 8 cv..8 cv + 7 of the chunk
    const int p = tid % kM, cv = tid / kM;
    if (cv < kDwChunk / 8 && c0 + 8 * cv < c_hi) {
      const unsigned char* wsrc = win + buf * (kDwChunk / 8) * plane + cv * plane;
      const float* fs = filt + buf * 11 * kDwChunk + 8 * cv;
      const int py = p / kTileC, px = p % kTileC;
      float acc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int wy = stride * py + dy, wx = stride * px + dx;
          const uint4 raw =
              *reinterpret_cast<const uint4*>(wsrc + (wy * wc + win_slot(wx, stride)) * 16);
          const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw);
          const float4 t0 = *reinterpret_cast<const float4*>(fs + (dy * 3 + dx) * kDwChunk);
          const float4 t1 = *reinterpret_cast<const float4*>(fs + (dy * 3 + dx) * kDwChunk + 4);
          const float tv[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = fmaf(__bfloat162float(xv[e]), tv[e], acc[e]);
        }
      }
      uint4 packed;
      __nv_bfloat16* pv = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        pv[e] = __float2bfloat16_rn(
            fmaxf(fmaf(acc[e], fs[9 * kDwChunk + e], fs[10 * kDwChunk + e]), 0.f));
      unsigned char* dst = y1 + y1_at(p, c0 + 8 * cv);
      if (G == 1) {
        *reinterpret_cast<uint4*>(dst) = packed;
      } else {
        for (int r = 0; r < G; ++r)
          *reinterpret_cast<uint4*>(cluster.map_shared_rank(dst, r)) = packed;
      }
    }
    __syncthreads();   // the chunk's buffers are read before the next load refills them
  }
  fence_proxy_async();   // y1's writes, here and in the peers, before wgmma reads them
  if (G > 1)
    cluster.sync();      // every peer's slice of y1 has landed here
  else
    __syncthreads();
  fence_proxy_async();

  // -- phase 2: out = act(y1 . wpw * s2 + b2), two F tiles a step -----------
  // a thread's accumulator entry (j, e) is output row rbase + g + 8 (e / 2),
  // column f0 + cbase + 8 j + 2 t + e % 2 of the step.  wgmma runs one step
  // ahead of the ring: a step's products are issued, then the previous
  // step's are waited for and its slot refilled.  The epilogue stages the
  // 64 x 128 output tile in the (then idle) window buffers and stores it 16
  // bytes a thread, whole rows at a time.
  const int g = lane >> 2, t = lane & 3;
  const int rbase = kWgmma ? 16 * (warp & 3) : 16 * (warp >> 2);
  const int cbase = kWgmma ? 64 * (warp >> 2) : 32 * (warp & 3);
  constexpr int kLdO = kStepF + 8;   // staged output row (elements), 16-byte aligned
  __nv_bfloat16* ostage = reinterpret_cast<__nv_bfloat16*>(win);
  float acc[kNJ][4];
  float sc[kNJ][2], bc[kNJ][2];   // the columns' affine, loaded as they start
  int slot = 0, k0 = 0, f0 = ft_lo * kTileF, phases = 0;
  for (int step = 0; step < steps; ++step) {
    if (k0 == 0) {
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int fi = f0 + cbase + j * 8 + 2 * t + e;
          sc[j][e] = fi < f_end ? s2[fi] : 0.f;
          bc[j][e] = fi < f_end ? b2[fi] : 0.f;
        }
      }
    }
    if (pl.vec) {
      mbar_wait(bars_s + 8 * slot, (phases >> slot) & 1);   // this step's chunk has landed
      phases ^= 1 << slot;
    } else {
      __syncthreads();   // the element-wise stores of this step's chunk are visible
    }

    const uint32_t wts = ring_s + slot * kRingStage;
    if constexpr (kWgmma) {
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kKStep; kk += 16) {
        // A: 64 pixels x 16 channels of y1; B: 16 channels x this
        // warpgroup's 64 columns of the chunk
        const uint64_t da = wgmma_desc(y1_s + ((k0 + kk) >> 3) * 128, 128, cp * 16);
        const uint64_t db =
            wgmma_desc(wts + (cbase >> 6) * kKStep * 128 + kk * 128, kKStep * 128, 1024) |
            (1ull << 62);   // 128-byte swizzle: LBO between 64-column boxes, SBO 8 rows
        wgmma_m64n64k16(acc, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");   // the previous step's
    } else {
#pragma unroll
      for (int kk = 0; kk < kKStep; kk += 16) {
        uint32_t a[4];
        const int ar = rbase + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4(a, y1_s + y1_at(ar, k0 + kk + (lane >> 4) * 8));
#pragma unroll
        for (int jp = 0; jp < kNJ / 2; ++jp) {
          uint32_t b[4];
          const int bk = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int bf = cbase + jp * 16 + (lane >> 4) * 8;
          ldsm_x4_t(b, wts + ring_at(bk, bf >> 3));
          mma_bf16(acc[2 * jp], a, b[0], b[1]);
          mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
        }
      }
      fence_proxy_async();   // these reads before the slot's next TMA write
    }
    __syncthreads();   // the previous step's slot is read by every warp
    if (step + stages - 1 < steps) load_weights();   // into that slot
    slot = slot + 1 == stages ? 0 : slot + 1;
    k0 += kKStep;
    if (k0 < c) continue;

    // epilogue of the two F tiles: BN [+ ReLU], cast, staged, stored
    if constexpr (kWgmma) asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = rbase + g + 8 * half;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        float y0 = fmaf(acc[j][2 * half], sc[j][0], bc[j][0]);
        float y1v = fmaf(acc[j][2 * half + 1], sc[j][1], bc[j][1]);
        if (act_out) {
          y0 = fmaxf(y0, 0.f);
          y1v = fmaxf(y1v, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(ostage + p * kLdO + cbase + j * 8 + 2 * t) =
            __floats2bfloat162_rn(y0, y1v);
      }
    }
    __syncthreads();
    for (int e = tid; e < kM * (kStepF / 8); e += kThreads) {
      const int p = e / (kStepF / 8), fc = (e % (kStepF / 8)) * 8, fi = f0 + fc;
      const int oy = ty * kTR + p / kTileC, ox = tx * kTileC + p % kTileC;
      if (oy >= pl.ho || ox >= pl.wo || fi >= f_end) continue;
      __nv_bfloat16* orow = out + (((size_t)n * pl.ho + oy) * pl.wo + ox) * f;
      const __nv_bfloat16* srow = ostage + p * kLdO + fc;
      if (pl.vec && fi + 8 <= f_end) {
        *reinterpret_cast<uint4*>(orow + fi) = *reinterpret_cast<const uint4*>(srow);
      } else {
        for (int q = 0; q < 8 && fi + q < f_end; ++q) orow[fi + q] = srow[q];
      }
    }
    k0 = 0;
    f0 += kStepF;
  }
  cp_async_wait<0>();   // nothing in flight when the CTA exits
}

// -- f32: SIMT ------------------------------------------------------------------

constexpr int kTileP = 64;       // f32: output pixels per CTA
// y1's row stride (f32): C rounded up to whole K steps (zero-filled) plus 8.
__host__ __device__ constexpr int y1_ld(int c) { return round_up(c, kKStep) + 8; }
constexpr int kChunk = 32;       // f32 phase 1: channels per step (one a thread)
constexpr int kLdWf = kTileF + 4;   // f32 weight rows, 16-byte aligned
constexpr int kPixelStep = kThreads / kChunk;      // pixels a pass covers (8)
constexpr int kPixPerThread = kTileP / kPixelStep;  // 8, their taps in flight together
constexpr int kVecsF32 = kKStep * kTileF / 4 / kThreads;   // float4 of a chunk a thread stages

static_assert(kThreads % kChunk == 0 && kTileP % kPixelStep == 0, "phase 1 mapping");

__global__ void __launch_bounds__(kThreads, 1)
sepconv_f32(const float* __restrict__ x, const float* __restrict__ taps,
            const float* __restrict__ s1, const float* __restrict__ b1,
            const float* __restrict__ wpw, const float* __restrict__ s2,
            const float* __restrict__ b2, float* __restrict__ out, Plan pl, int act_out) {
  extern __shared__ __align__(16) unsigned char y1_smem[];
  __shared__ __align__(16) float wts[kKStep * kLdWf];
  __shared__ int pix_n[kTileP], pix_r[kTileP], pix_c[kTileP];

  const int tid = threadIdx.x;
  const long long pixels = (long long)pl.n * pl.ho * pl.wo;
  const long long p0 = (long long)blockIdx.x * kTileP;
  const int ldy = y1_ld(pl.c);
  float* y1s = reinterpret_cast<float*>(y1_smem);

  // (image, row, column) of the tile's output pixels; -1 past the last.
  if (tid < kTileP) {
    const long long gp = p0 + tid;
    const bool live = gp < pixels;
    const long long per_image = (long long)pl.ho * pl.wo;
    const int rem = live ? (int)(gp % per_image) : 0;
    pix_n[tid] = live ? (int)(gp / per_image) : -1;
    pix_r[tid] = rem / pl.wo;
    pix_c[tid] = rem % pl.wo;
  }
  __syncthreads();

  // -- phase 1: y1 = ReLU(depthwise * s1 + b1) of every channel -------------
  // Thread (pq, kq) computes channel c0 + kq of pixels pq, pq + 8, ...; the
  // nine taps of its eight pixels are loaded from clamped, valid addresses
  // before any is used (the taps outside the map are zeroed afterwards).
  const int kq = tid % kChunk, pq = tid / kChunk;
  for (int c0 = 0; c0 < ldy - 8; c0 += kChunk) {
    const int ch = c0 + kq;
    const bool live_ch = ch < pl.c;
    const int chc = live_ch ? ch : pl.c - 1;
    float wt[11];
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t] = taps[t * pl.c + chc];
    wt[9] = s1[chc];
    wt[10] = b1[chc];
    float v[kPixPerThread][9];
    int rbase[kPixPerThread], cbase[kPixPerThread];
#pragma unroll
    for (int u = 0; u < kPixPerThread; ++u) {
      const int p = pq + u * kPixelStep;
      const int n = pix_n[p];
      rbase[u] = pl.stride == 1 ? pix_r[p] - 1 : 2 * pix_r[p];
      cbase[u] = pl.stride == 1 ? pix_c[p] - 1 : 2 * pix_c[p];
      const float* img = x + (size_t)(n >= 0 ? n : 0) * pl.h * pl.w * pl.c + chc;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* row = img + (size_t)min(max(rbase[u] + dy, 0), pl.h - 1) * pl.w * pl.c;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int ic = min(max(cbase[u] + dx, 0), pl.w - 1);
          v[u][dy * 3 + dx] = row[(size_t)ic * pl.c];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kPixPerThread; ++u) {
      const int p = pq + u * kPixelStep;
      float s = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const bool row_in = rbase[u] + dy >= 0 && rbase[u] + dy < pl.h;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const bool in = row_in && cbase[u] + dx >= 0 && cbase[u] + dx < pl.w;
          s += in ? v[u][dy * 3 + dx] * wt[dy * 3 + dx] : 0.0f;
        }
      }
      const bool live = live_ch && pix_n[p] >= 0;
      y1s[p * ldy + ch] = live ? fmaxf(s * wt[9] + wt[10], 0.0f) : 0.0f;
    }
  }

  // -- phase 2: out = act(y1 . wpw * s2 + b2), this CTA's F tiles -----------
  const int ty = tid >> 3, tx = tid & 7;   // pixels ty*2..+1, channels tx*8..+7
  const int nk = (pl.c + kKStep - 1) / kKStep;
  const int nft = (pl.f + kTileF - 1) / kTileF;
  const int ft0 = blockIdx.y * nft / pl.cluster, ft1 = (blockIdx.y + 1) * nft / pl.cluster;
  const int steps = (ft1 - ft0) * nk;
  float4 pre[kVecsF32];
  auto load_weights = [&](int step) {
    const int f0 = (ft0 + step / nk) * kTileF, c0 = (step % nk) * kKStep;
#pragma unroll
    for (int j = 0; j < kVecsF32; ++j) {
      const int e = tid + j * kThreads, ci = c0 + e / (kTileF / 4), fi = f0 + (e % (kTileF / 4)) * 4;
      float* d = reinterpret_cast<float*>(&pre[j]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        d[q] = (ci < pl.c && fi + q < pl.f) ? wpw[(size_t)ci * pl.f + fi + q] : 0.0f;
    }
  };
  float acc[2][8];
  if (steps > 0) load_weights(0);
  for (int step = 0; step < steps; ++step) {
    const int kc = step % nk;
    const int f0 = (ft0 + step / nk) * kTileF;
    const int c0 = kc * kKStep;
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
    __syncthreads();   // y1 is complete; the previous chunk is consumed
#pragma unroll
    for (int j = 0; j < kVecsF32; ++j) {
      const int e = tid + j * kThreads;
      *reinterpret_cast<float4*>(wts + (e / (kTileF / 4)) * kLdWf + (e % (kTileF / 4)) * 4) = pre[j];
    }
    __syncthreads();
    if (step + 1 < steps) load_weights(step + 1);
#pragma unroll 4
    for (int k = 0; k < kKStep; ++k) {
      const float a0 = y1s[(ty * 2) * ldy + c0 + k];
      const float a1 = y1s[(ty * 2 + 1) * ldy + c0 + k];
      const float4 bv0 = *reinterpret_cast<const float4*>(wts + k * kLdWf + tx * 8);
      const float4 bv1 = *reinterpret_cast<const float4*>(wts + k * kLdWf + tx * 8 + 4);
      const float b8[8] = {bv0.x, bv0.y, bv0.z, bv0.w, bv1.x, bv1.y, bv1.z, bv1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[0][j] = fmaf(a0, b8[j], acc[0][j]);
        acc[1][j] = fmaf(a1, b8[j], acc[1][j]);
      }
    }
    if (kc != nk - 1) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long gp = p0 + ty * 2 + i;
      if (gp >= pixels) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int fi = f0 + tx * 8 + j;
        if (fi >= pl.f) continue;
        float y = acc[i][j] * s2[fi] + b2[fi];
        if (act_out) y = fmaxf(y, 0.0f);
        out[gp * pl.f + fi] = y;
      }
    }
  }
}

// The TMA map of the (C, F) bf16 weights: boxes of 64 F x 64 K, 128-byte
// swizzle.
cudaError_t weight_map(CUtensorMap* map, const void* wpw, int c, int f) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)f, (cuuint64_t)c};
  const cuuint64_t strides[1] = {(cuuint64_t)f * 2};
  const cuuint32_t box[2] = {64, kKStep};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(wpw), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch_bf16(const void* x, const float* const* fp, const void* wpw, void* out,
                        const Plan& pl, int tile_rows, int act_out, cudaStream_t s) {
  CUtensorMap wmap = {};
  cudaError_t err = pl.vec ? weight_map(&wmap, wpw, pl.c, pl.f) : cudaSuccess;
  if (err != cudaSuccess) return err;
  void (*kernel)(const __nv_bfloat16*, const float*, const float*, const float*,
                 const __nv_bfloat16*, const CUtensorMap, const float*, const float*,
                 __nv_bfloat16*, Plan, int) = tile_rows == 8 ? sepconv_bf16<8> : sepconv_bf16<4>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.lay.total);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(pl.cluster * pl.tiles_w),
                     (unsigned)((pl.ho + tile_rows - 1) / tile_rows), (unsigned)pl.n);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.lay.total;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const __nv_bfloat16* xa = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wa = static_cast<const __nv_bfloat16*>(wpw);
  __nv_bfloat16* oa = static_cast<__nv_bfloat16*>(out);
  const float *taps = fp[0], *s1 = fp[1], *b1 = fp[2], *s2 = fp[3], *b2 = fp[4];
  Plan pa = pl;
  int act = act_out;
  void* args[] = {&xa, &taps, &s1, &b1, &wa, &wmap, &s2, &b2, &oa, &pa, &act};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* x, const float* const* fp, const void* wpw, void* out,
                       const Plan& pl, int act_out, cudaStream_t s) {
  const long long tiles = ((long long)pl.n * pl.ho * pl.wo + kTileP - 1) / kTileP;
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  const size_t dyn = (size_t)kTileP * y1_ld(pl.c) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(sepconv_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dyn);
  if (err != cudaSuccess) return err;
  sepconv_f32<<<dim3((unsigned)tiles, pl.cluster), kThreads, dyn, s>>>(
      static_cast<const float*>(x), fp[0], fp[1], fp[2], static_cast<const float*>(wpw), fp[3],
      fp[4], static_cast<float*>(out), pl, act_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (n, h, w, c) NHWC; out: (n, h/stride, w/stride, f); wpw: (c, f); all
// contiguous, float32 (dtype 0) or bfloat16 (dtype 1).  taps: (9, c) f32, the
// depthwise kernel (3, 3, 1, c) as stored; s1, b1: (c,) f32; s2, b2: (f,)
// f32.  stride 1, or 2 with h and w even.  The plan (ops/cuda/sepconv.py
// plan()): tile_rows 8 or 4, cluster 1-8 (at most the F tiles and the
// 8-channel groups), stages 2-4; its shared memory must fit a CTA.
// f32 takes the cluster size as its F split.  Returns a cudaError_t (0 =
// launched; cudaErrorInvalidValue for shapes or a plan it cannot run).
int bugcar_fused_sepconv(const void* x, const void* taps, const void* s1, const void* b1,
                         const void* wpw, const void* s2, const void* b2, void* out, int n,
                         int h, int w, int c, int f, int stride, int act_out, int dtype,
                         int tile_rows, int cluster, int stages, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || c < 1 || f < 1 || (stride != 1 && stride != 2) ||
      (stride == 2 && (h % 2 || w % 2)) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Plan pl;
  pl.n = n;
  pl.h = h;
  pl.w = w;
  pl.c = c;
  pl.f = f;
  pl.ho = h / stride;
  pl.wo = w / stride;
  pl.stride = stride;
  pl.tiles_w = (pl.wo + kTileC - 1) / kTileC;
  pl.cluster = cluster;
  pl.stages = stages;
  const int nft = (f + kTileF - 1) / kTileF;
  if (cluster < 1 || cluster > 8 || cluster > nft ||
      cluster > (c + 7) / 8 || (tile_rows != 8 && tile_rows != 4) || stages < 2 || stages > 4)
    return (int)cudaErrorInvalidValue;
  pl.lay = layout(tile_rows, c, stride, stages);
  pl.vec = c % 8 == 0 && f % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(wpw) % 16 == 0;
  if (pl.lay.total > kSmemMax || (long long)pl.cluster * pl.tiles_w > 2147483647LL ||
      (pl.ho + tile_rows - 1) / tile_rows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fp[5] = {static_cast<const float*>(taps), static_cast<const float*>(s1),
                        static_cast<const float*>(b1), static_cast<const float*>(s2),
                        static_cast<const float*>(b2)};
  const cudaError_t err = dtype == 0 ? launch_f32(x, fp, wpw, out, pl, act_out, s)
                                     : launch_bf16(x, fp, wpw, out, pl, tile_rows, act_out, s);
  return (int)err;
}

// Clusters of `cluster` CTAs of the bf16 kernel (tile_rows 8 or 4) with
// `smem` bytes of dynamic shared memory each that the card holds at once
// (cudaOccupancyMaxActiveClusters); a negative cudaError_t on failure.
// ops/cuda/sepconv.py's MAX_CLUSTERS records its answers.
int bugcar_fused_sepconv_max_clusters(int tile_rows, int smem, int cluster) {
  if ((tile_rows != 8 && tile_rows != 4) || smem < 0 || smem > kSmemMax || cluster < 1 ||
      cluster > 8)
    return -(int)cudaErrorInvalidValue;
  void (*kernel)(const __nv_bfloat16*, const float*, const float*, const float*,
                 const __nv_bfloat16*, const CUtensorMap, const float*, const float*,
                 __nv_bfloat16*, Plan, int) = tile_rows == 8 ? sepconv_bf16<8> : sepconv_bf16<4>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 64);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(kernel), &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

}  // extern "C"
