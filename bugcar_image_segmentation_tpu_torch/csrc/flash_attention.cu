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
// far ahead of the bytes (q, k, v read once, out written once).  With P
// split in two (below) the tensor cores do three products of 2d FLOPs a
// score, which at d = 64 (SegFormer B1-B3) nears the exps' time.
//
// Two kernels serve the four (layout, type) pairs: bf16 in both layouts
// runs on the tensor cores (flash_attention_wgmma), f32 in both on the FMA
// pipes (flash_attention_simt).
//
// bf16 (flash_attention_wgmma): warp-specialised, wgmma + TMA.  A CTA takes
// 64 queries of one (batch, head) per consumer warpgroup (one or two; the
// plan) and one producer warpgroup, whose first thread loads the CTA's Q
// tile once and streams K and V tiles of 64 keys into a ring of 2-4 stages
// in shared memory by TMA, each stage with a full and an empty mbarrier;
// setmaxnreg hands the producer's registers to the consumers.  A consumer
// warpgroup runs, per K/V tile, S = Q.K^T as wgmma m64n64k16 (Q and K read
// from shared memory by descriptor; d / 16 k-steps), the online softmax in
// the S accumulator registers (the row max as a tree and across the four
// threads of a row with shuffles, p = 2^(s c - m) with c = scale log2 e
// folded into one fma and ex2.approx on the SFU, alpha rescaling the f32
// accumulator, l summed from the f32 P; keys past Nkv score -inf in the
// last tile only), then O += P.V as wgmma m64n{d}k16 with P taken from
// registers (the accumulator layout is the A fragments' layout).  To keep
// the TPU kernel's f32 P, P is split into P_hi = bf16(P) and P_lo =
// bf16(P - P_hi), two products into the same f32 accumulator: a single
// bf16 P is off by more than one output ulp wherever the output is near 0
// (tests/test_torch_attention_tiles.py pins both).  The next tile's S
// product is issued with this tile's P.V, before the next tile's softmax.
// With two consumer warpgroups, named barriers make them take turns
// issuing their products.  The epilogue divides by l in f32, casts once,
// stages the warpgroup's tile in its part of the Q tile and stores it by
// TMA (queries past Nq are clipped).
//
// The two layouts run the same loop on other tiles.  Token-major operands
// (flash_attention: stage 0, B1-B3's d = 64) are [token][channel] tiles
// with the 64- (d = 32) or 128-byte (d = 64) swizzle, one TMA box a tile;
// Q and K are K-major operands, V is MN-major (the transpose bit).
// Channel-major operands (flash_attention_t: stages 1-3, one row per
// channel, tokens contiguous) are [channel][token] tiles in boxes of 64
// tokens with the 128-byte swizzle; Q and K are MN-major, V K-major.  No
// layout is copied or transposed in device memory.  TMA needs 16-byte
// aligned operands and row strides: where a channel-major Nq or Nkv is not
// a multiple of 8 (or a pointer is not aligned), the whole producer
// warpgroup loads the tiles element by element into the same swizzled
// layout, and the consumers store the output element by element -- the
// arithmetic is the same.  The plan (consumer warpgroups, ring stages) is
// a function of (Nq, d) only, the key tile is 64 at every plan,
// and every query row runs the same instructions at every plan, so a
// frame's output does not depend on its batch and every plan gives the
// same bits.  The mbarrier waits trap after a bounded number of polls
// rather than hang, and a launch whose register counts could leave
// setmaxnreg waiting is refused.
//
// What the measurements decided (scripts/torch_attention_plans.py and
// scripts/torch_attention_split.py on an H100 SXM at 700 W; PERF.md).
// Tiles of 128 keys leave S (64 registers), P hi + lo (64) and O in flight
// together, more than a consumer gets; the compiler then spills P and
// serialises every product, so the tile is 64 keys.  The consumers keep
// 216 (one) or 232 (two) registers after setmaxnreg; three CTAs an SM, or
// a producer warp alone, leave them fewer, with the same spills (and a
// producer warp alone gives its registers back to one scheduler only, so
// the consumers on the other three wait for them forever).  The default
// plan is four ring stages and, but for B2's large stages, one consumer
// warpgroup, two CTAs an SM (see attention_plan).  Forcing the exps
// between
// the two products' waits (so that they overlap this warpgroup's P.V)
// made it slower; the compiler's schedule is kept, and the other CTA on
// the SM fills the gaps.
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
// bugcar_flash_attention and bugcar_flash_attention_t, which take the plan
// of bugcar_flash_attention_plan; bugcar_flash_attention_bf16_plan, which
// forces a plan, exists only to measure the plans against each other
// (scripts/torch_attention_plans.py, and a card test that they give the
// same bits) and no serving path calls it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "ptx.cuh"

namespace {

constexpr int kThreads = 64;   // SIMT: queries (threads) per CTA
constexpr int kTileKv = 64;    // SIMT: keys per shared-memory tile
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

// -- bf16: warp-specialised, wgmma + TMA -------------------------------------

constexpr int kRows = 64;          // queries of a consumer warpgroup (wgmma's M)
constexpr int kKeys = 64;          // keys of a K/V tile (S's N; one channel-major box)
constexpr int kWg = 128;           // threads of a warpgroup
constexpr int kSmemMax = 232448;   // dynamic shared memory a CTA may use
constexpr int kProducerRegs = 40;  // registers a producer thread keeps

// A CTA: kC consumer warpgroups, then the producer warpgroup; one consumer
// runs two CTAs an SM, two run one (8 consumer warps an SM either way).
// The launch bounds give 128 or 168 registers a thread; the consumers then
// take all that the producer gives back (setmaxnreg.inc).  Fewer CTAs'
// worth of registers (three CTAs an SM, or a producer warp alone) leave
// the consumers short, and the compiler spills P and serialises the
// products.
template <int kC>
__host__ __device__ constexpr int ctas_per_sm() {
  return kC == 1 ? 2 : 1;
}
template <int kC>
__host__ __device__ constexpr int consumer_regs() {
  return kC == 1 ? 216 : 232;
}

// Shared memory, byte offsets from a 1024-aligned base (the swizzle atoms'
// alignment): the Q tile (one box of 64 queries a consumer), the ring's
// stages (a K tile, then a V tile), the mbarriers (full[stages],
// empty[stages], the Q tile's).  `total` includes the base's alignment.
struct Layout {
  int q_box, tile, stage, ring, bars, total;
};

__host__ __device__ inline Layout layout(int d, int consumers, int stages) {
  Layout l;
  l.q_box = kRows * d * 2;
  l.tile = kKeys * d * 2;
  l.stage = 2 * l.tile;
  l.ring = consumers * l.q_box;
  l.bars = l.ring + stages * l.stage;
  l.total = l.bars + 8 * (2 * stages + 1) + 1024;
  return l;
}

// The TMA's and wgmma's swizzle of a tile with rows of kSpan (64 or 128)
// bytes: the 16-byte chunk index of byte a XOR the index of its 128-byte
// row, modulo kSpan / 16.
template <int kSpan>
__device__ __forceinline__ uint32_t swz(uint32_t a) {
  return a ^ (((a >> 7) & (kSpan / 16 - 1)) << 4);
}

// Byte offset of (token n, channel c) in a tile.  Token-major: rows of D
// channels (span 2 D bytes).  Channel-major: boxes of 64 tokens, each D
// channel rows of 128 bytes (span 128).
template <int D, bool kCM>
__device__ __forceinline__ uint32_t tile_at(int n, int c) {
  if constexpr (kCM)
    return (n >> 6) * (D * 128) + swz<128>(c * 128 + (n & 63) * 2);
  else
    return swz<2 * D>(n * (2 * D) + c * 2);
}

// wgmma shared-memory descriptor: start, LBO and SBO in bytes, and the
// swizzle (bits 62-63: 1 = 128-byte, 2 = 64-byte).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int span) {
  return (uint64_t)((addr >> 4) & 0x3fff) | ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | ((uint64_t)(span == 128 ? 1 : 2) << 62);
}

// Descriptors of a tile at its k-step 0, and the byte offset of k-step
// kk.  Swizzled K-major operands advance 32 bytes along their rows (SBO: 8
// rows; LBO unused); MN-major ones advance 16 rows (SBO: 8 rows; LBO: the
// next box of 64 tokens).  The start field is the address / 16 in its low
// 14 bits, so a descriptor advances by adding offset / 16 (shared
// addresses stay below 256 KB).
// S = Q.K^T (channels 16 kk..): A = a consumer's Q box, B = a K tile; both
// MN-major channel-major, K-major token-major.
template <int D, bool kCM>
__device__ __forceinline__ uint64_t qk_desc(uint32_t tile) {
  return kCM ? smem_desc(tile, D * 128, 1024, 128) : smem_desc(tile, 16, 16 * D, 2 * D);
}
template <int D, bool kCM>
__host__ __device__ constexpr uint32_t qk_step(int kk) {
  return kCM ? kk * 2048 : kk * 32;
}
// O += P.V (keys 16 kk..): B = a V tile, MN-major token-major, K-major
// channel-major.
template <int D, bool kCM>
__device__ __forceinline__ uint64_t v_desc(uint32_t tile) {
  return kCM ? smem_desc(tile, 16, 1024, 128) : smem_desc(tile, 16 * D, 16 * D, 2 * D);
}
template <int D, bool kCM>
__host__ __device__ constexpr uint32_t v_step(int kk) {
  return kCM ? kk * 32 : kk * 32 * D;
}

template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTA), "n"(kTB));
}

template <int kTB>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(kTB));
}

template <int kTB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(kTB));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// Pins registers that an asynchronous wgmma reads or writes to this point
// of the program, so that no access to them moves across its issue or wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
// Named barriers: n threads in all, some waiting (sync), some not (arrive).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// f32 (p0, p1) as two bf16 pairs, hi = bf16(p) and lo = bf16(p - hi).
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// P (the S accumulator after softmax_step) as bf16 hi + lo A fragments of
// the P.V k-steps: k-step kk holds keys 16 kk + 2 t (+1, +8, +9).
__device__ __forceinline__ void split_p(const float (&s)[kKeys / 2], uint32_t (&hi)[kKeys / 16][4],
                                        uint32_t (&lo)[kKeys / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1], hi[kk][e], lo[kk][e]);
}

// S = Q.K^T of one consumer (descriptors of the Q box and the K tile): d /
// 16 k-steps, one commit group.
template <int D, bool kCM>
__device__ __forceinline__ void issue_s(float (&s)[kKeys / 2], uint64_t qd, uint64_t kd) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64<kCM, kCM>(s, qd + (qk_step<D, kCM>(kk) >> 4), kd + (qk_step<D, kCM>(kk) >> 4),
                           kk > 0);
  wgmma_commit();
}

// O += P_hi.V + P_lo.V: 2 x 8 k-steps, one commit group.
template <int D, bool kCM>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&hi)[kKeys / 16][4],
                                         const uint32_t (&lo)[kKeys / 16][4], uint64_t vd) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const uint64_t db = vd + (v_step<D, kCM>(kk) >> 4);
    if constexpr (D == 32) {
      wgmma_rs_n32<!kCM>(o, hi[kk], db);
      wgmma_rs_n32<!kCM>(o, lo[kk], db);
    } else {
      wgmma_rs_n64<!kCM>(o, hi[kk], db);
      wgmma_rs_n64<!kCM>(o, lo[kk], db);
    }
  }
  wgmma_commit();
}

// One tile's online-softmax step in the S accumulator, whose entry i is
// row g + 8 ((i >> 1) & 1) of the warp's 16, key 8 (i >> 2) + 2 t + (i & 1)
// of the tile: keys from `live` on score -inf, m and l are updated in the
// log2 domain (p = 2^(s c - m), m the running max of s c), s becomes P and
// alpha the rescale of each row's accumulator.
__device__ __forceinline__ void softmax_step(float (&s)[kKeys / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int live, int t, float c) {
  if (live < kKeys) {
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i)
      if (8 * (i >> 2) + 2 * t + (i & 1) >= live) s[i] = -CUDART_INF_F;
  }
  // each row's max as a tree (independent maxima, the same value)
  float t4[4][kKeys / 16];
#pragma unroll
  for (int i = 0; i < kKeys / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) t4[e][i] = fmaxf(s[8 * i + e], s[8 * i + 4 + e]);
#pragma unroll
  for (int n = kKeys / 32; n >= 1; n /= 2)
#pragma unroll
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) t4[e][i] = fmaxf(t4[e][i], t4[e][i + n]);
  float mx[2] = {fmaxf(t4[0][0], t4[1][0]), fmaxf(t4[2][0], t4[3][0])};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // the tile holds at least one live key, so the new max is finite and
    // the first rescale (m = -inf) gives alpha = 0
    const float m_new = fmaxf(m[r], mx[r] * c);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) {
    const float p = ex2(fmaf(s[i], c, -m[(i >> 1) & 1]));
    s[i] = p;
    l[(i >> 1) & 1] += p;
  }
}

// bf16 on wgmma.  Token-major (kCM false): q, out (bh, nq, D); k, v (bh,
// nkv, D).  Channel-major (kCM true): q, out (bh, D, nq); k, v (bh, D,
// nkv).  Warpgroups 0..kC-1 consume, 64 queries each; warpgroup kC
// produces (its first thread issues the TMA loads; with vec 0 all its
// threads load element by element).  The tensor maps are used with vec
// only.
template <int D, bool kCM, int kC>
__global__ void __launch_bounds__(kWg * (kC + 1), ctas_per_sm<kC>())
flash_attention_wgmma(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap omap,
                      const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                      int nq, int nkv, float scale_log2, int stages, int vec) {
  using T = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t base = (raw_s + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw_s);
  const Layout lay = layout(D, kC, stages);
  const uint32_t ring = base + lay.ring, bars = base + lay.bars;
  // mbarriers: full[s] at bars + 8 s, empty[s] at bars + 8 (stages + s)
  const uint32_t q_full = bars + 16 * stages;
  // the warpgroup index through a shuffle, so that the compiler sees the
  // role branch below as warp-uniform and compiles each role with its own
  // register count (setmaxnreg)
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / kWg, 0);
  const int q0 = blockIdx.x * kRows * kC;
  const int bh = blockIdx.y;
  const int ntiles = (nkv + kKeys - 1) / kKeys;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (stages + s), 4 * kC);   // every consumer warp releases
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kC) {
    // -- producer: the Q tile once, then K and V tile after tile ----------
    regs_dec<kProducerRegs>();
    const int t = tid - kWg * kC;
    if (vec) {
      if (t != 0) return;
      mbar_expect_tx(q_full, kC * lay.q_box);
      for (int w = 0; w < kC; ++w) {
        if constexpr (kCM)
          tma_load_3d(base + w * lay.q_box, &qmap, q0 + w * kRows, 0, bh, q_full);
        else
          tma_load_3d(base + w * lay.q_box, &qmap, 0, q0 + w * kRows, bh, q_full);
      }
      for (int j = 0, s = 0, ph = 0; j < ntiles; ++j) {
        if (j >= stages) mbar_wait(bars + 8 * (stages + s), ph ^ 1);   // slot released
        const uint32_t full = bars + 8 * s, kt = ring + s * lay.stage, vt = kt + lay.tile;
        mbar_expect_tx(full, lay.stage);
        if constexpr (kCM) {   // a tile is one box of 64 tokens
          tma_load_3d(kt, &kmap, j * kKeys, 0, bh, full);
          tma_load_3d(vt, &vmap, j * kKeys, 0, bh, full);
        } else {
          tma_load_3d(kt, &kmap, 0, j * kKeys, bh, full);
          tma_load_3d(vt, &vmap, 0, j * kKeys, bh, full);
        }
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
    } else {
      // `len` tokens from token n0 of src (n_tok tokens) into a tile at
      // dst, zeros past n_tok, in the layout TMA would give; then visible
      // to wgmma
      auto fill = [&](unsigned char* dst, const T* src, int n_tok, int n0, int len) {
        for (int i = t; i < len * D; i += kWg) {
          const int n = kCM ? i % len : i / D, c = kCM ? i / len : i % D, tok = n0 + n;
          *reinterpret_cast<T*>(dst + tile_at<D, kCM>(n, c)) =
              tok < n_tok ? src[kCM ? (size_t)c * n_tok + tok : (size_t)tok * D + c]
                          : __float2bfloat16_rn(0.f);
        }
        fence_proxy_async();
        bar_sync(1, kWg);
      };
      fill(smem, q + (size_t)bh * nq * D, nq, q0, kC * kRows);
      if (t == 0) mbar_arrive(q_full);
      const T* kh = k + (size_t)bh * nkv * D;
      const T* vh = v + (size_t)bh * nkv * D;
      for (int j = 0, s = 0, ph = 0; j < ntiles; ++j) {
        if (j >= stages) mbar_wait(bars + 8 * (stages + s), ph ^ 1);
        unsigned char* kt = smem + lay.ring + s * lay.stage;
        fill(kt, kh, nkv, j * kKeys, kKeys);
        fill(kt + lay.tile, vh, nkv, j * kKeys, kKeys);
        if (t == 0) mbar_arrive(bars + 8 * s);
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // -- consumers: 64 queries each ----------------------------------------
    regs_inc<consumer_regs<kC>()>();
    const int w = wg, t = tid - kWg * wg, warp = t >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const uint32_t my_q = base + w * lay.q_box;
    // descriptors of the Q box and of ring slot 0's K and V tiles; slot st
    // is st * lay.stage bytes further
    const uint64_t qd = qk_desc<D, kCM>(my_q), kd0 = qk_desc<D, kCM>(ring);
    const uint64_t vd0 = v_desc<D, kCM>(ring + lay.tile);
    const uint32_t slot16 = lay.stage >> 4;
    float s[kKeys / 2], o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, alpha[2];
    // Two consumers take turns issuing their products: named barrier 4 + w
    // is consumer w's turn; consumer 1 lets consumer 0 go first and passes
    // the turn back after each of its issues but the last.
    if (kC == 2 && w == 1) bar_arrive(4, 2 * kWg);

    mbar_wait(q_full, 0);
    mbar_wait(bars, 0);   // tile 0
    if (kC == 2) bar_sync(4 + w, 2 * kWg);
    wgmma_fence();
    issue_s<D, kCM>(s, qd, kd0);
    if (kC == 2) bar_arrive(5 - w, 2 * kWg);
    wgmma_wait<0>();
    reg_fence(s);
    softmax_step(s, m, l, alpha, nkv, tq, scale_log2);

    // tiles 0 .. ntiles - 2: the next tile's scores and this tile's P.V
    // issued together, then the next tile's softmax
    int st = 0, ph = 0;
    for (int j = 0; j + 1 < ntiles; ++j) {
      uint32_t hi[kKeys / 16][4], lo[kKeys / 16][4];
      split_p(s, hi, lo);
      const int nst = st + 1 == stages ? 0 : st + 1, nph = nst == 0 ? ph ^ 1 : ph;
      mbar_wait(bars + 8 * nst, nph);
      if (kC == 2) bar_sync(4 + w, 2 * kWg);
      wgmma_fence();
      issue_s<D, kCM>(s, qd, kd0 + nst * slot16);
      issue_pv<D, kCM>(o, hi, lo, vd0 + st * slot16);
      if (kC == 2) bar_arrive(5 - w, 2 * kWg);
      wgmma_wait<1>();
      reg_fence(s);
      softmax_step(s, m, l, alpha, nkv - (j + 1) * kKeys, tq, scale_log2);
      wgmma_wait<0>();   // this tile's P.V
      reg_fence(o);
      reg_fence(hi);
      reg_fence(lo);
      if (lane == 0) mbar_arrive(bars + 8 * (stages + st));   // this warp has read the slot
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      st = nst;
      ph = nph;
    }
    {   // the last tile's P.V
      uint32_t hi[kKeys / 16][4], lo[kKeys / 16][4];
      split_p(s, hi, lo);
      if (kC == 2) bar_sync(4 + w, 2 * kWg);
      wgmma_fence();
      issue_pv<D, kCM>(o, hi, lo, vd0 + st * slot16);
      if (kC == 2 && w == 0) bar_arrive(5, 2 * kWg);
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence(hi);
      reg_fence(lo);
    }

    // epilogue: O / l in f32, one cast, staged in this consumer's Q box
    // (its products are done), stored by TMA or element by element
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    unsigned char* os = smem + w * lay.q_box;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      const int c = 8 * jn + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h;
        const float y0 = o[4 * jn + 2 * h] / l[h], y1 = o[4 * jn + 2 * h + 1] / l[h];
        if constexpr (kCM) {
          *reinterpret_cast<T*>(os + tile_at<D, true>(r, c)) = __float2bfloat16_rn(y0);
          *reinterpret_cast<T*>(os + tile_at<D, true>(r, c + 1)) = __float2bfloat16_rn(y1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(os + tile_at<D, false>(r, c)) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
    }
    fence_proxy_async();
    bar_sync(2 + w, kWg);
    const int n0 = q0 + w * kRows;
    if (vec) {
      if (t == 0) {
        if constexpr (kCM)
          tma_store_3d(&omap, my_q, n0, 0, bh);
        else
          tma_store_3d(&omap, my_q, 0, n0, bh);
      }
    } else {
      T* oh = out + (size_t)bh * nq * D;
      for (int i = t; i < kRows * D; i += kWg) {
        const int n = kCM ? i % kRows : i / D, c = kCM ? i / kRows : i % D;
        if (n0 + n < nq)
          oh[kCM ? (size_t)c * nq + n0 + n : (size_t)(n0 + n) * D + c] =
              *reinterpret_cast<const T*>(os + tile_at<D, kCM>(n, c));
      }
    }
  }
}

// The launch plan of the bf16 kernel: consumer warpgroups a CTA (64
// queries each) and ring stages.  It may depend on (nq, d) only,
// and a query row runs the same instructions at every plan, so a frame's
// output does not depend on its batch.  Four stages (two expose the
// loads); two consumers where d = 64 and nq >= 16384 (B2's stages 0-1,
// 1.5-3 % faster), one elsewhere (two lose up to 34 % at stage 3), from
// scripts/torch_attention_plans.py on an H100 SXM at 700 W.
struct Plan {
  int consumers, stages;
};

Plan attention_plan(int nq, int d) { return {d == 64 && nq >= 16384 ? 2 : 1, 4}; }

// TMA map of a bf16 operand of bh slices of `rows` rows of `inner`
// contiguous elements: boxes of box_inner x box_rows, the given swizzle.
cudaError_t tensor_map(CUtensorMap* map, const void* base, int inner, int rows, int bh,
                       int box_inner, int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2, (cuuint64_t)inner * rows * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, bool kCM, int kC>
cudaError_t launch_wgmma_c(const CUtensorMap* maps, const void* q, const void* k, const void* v,
                           void* out, int bh, int nq, int nkv, float c, int stages, int vec,
                           cudaStream_t stream) {
  using T = __nv_bfloat16;
  auto kernel = flash_attention_wgmma<D, kCM, kC>;
  // setmaxnreg.inc waits until the producer warp on the same scheduler has
  // given registers back: a build whose launch count cannot cover the
  // consumers' raise would wait forever, so it is refused.
  static int regs = 0;
  if (regs == 0) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    regs = attr.numRegs;
  }
  if (regs * (kC + 1) < kProducerRegs + kC * consumer_regs<kC>())
    return cudaErrorInvalidConfiguration;
  const int smem = layout(D, kC, stages).total;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kRows * kC - 1) / (kRows * kC), bh);
  kernel<<<grid, kWg * (kC + 1), smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), nq, nkv, c, stages, vec);
  return cudaGetLastError();
}

template <int D, bool kCM>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int bh, int nq,
                         int nkv, float scale, Plan pl, cudaStream_t stream) {
  if ((pl.consumers != 1 && pl.consumers != 2) || pl.stages < 2 || pl.stages > 4)
    return cudaErrorInvalidValue;
  // TMA: 16-byte aligned operands and row strides (channel-major rows of
  // nq or nkv tokens); otherwise element by element
  const int vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) & 15) == 0 &&
                  (!kCM || (nq % 8 == 0 && nkv % 8 == 0));
  CUtensorMap maps[4] = {};
  if (vec) {
    const CUtensorMapSwizzle tok_swz = D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_128B;
    const void* ptrs[4] = {q, k, v, out};
    for (int i = 0; i < 4; ++i) {
      const int n = i == 1 || i == 2 ? nkv : nq, box = i == 1 || i == 2 ? kKeys : kRows;
      const cudaError_t err =
          kCM ? tensor_map(&maps[i], ptrs[i], n, D, bh, 64, D, CU_TENSOR_MAP_SWIZZLE_128B)
              : tensor_map(&maps[i], ptrs[i], D, n, bh, D, box, tok_swz);
      if (err != cudaSuccess) return err;
    }
  }
  const float c = scale * kLog2e;
  return pl.consumers == 1
      ? launch_wgmma_c<D, kCM, 1>(maps, q, k, v, out, bh, nq, nkv, c, pl.stages, vec, stream)
      : launch_wgmma_c<D, kCM, 2>(maps, q, k, v, out, bh, nq, nkv, c, pl.stages, vec, stream);
}

template <int D, bool kChannelMajor>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh, int nq,
                   int nkv, float scale, int dtype, Plan pl, cudaStream_t stream) {
  if (dtype == 1) {
    if (pl.consumers == 0) pl = attention_plan(nq, D);
    return launch_wgmma<D, kChannelMajor>(q, k, v, out, bh, nq, nkv, scale, pl, stream);
  }
  const dim3 grid((nq + kThreads - 1) / kThreads, bh);
  flash_attention_simt<D, kChannelMajor><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), nq, nkv, scale);
  return cudaGetLastError();
}

template <bool kChannelMajor>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh, int nq, int nkv,
             int d, float scale, int dtype, Plan pl, void* stream) {
  if (bh < 1 || bh > 65535 || nq < 1 || nkv < 1 || (d != 32 && d != 64) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      d == 32 ? launch<32, kChannelMajor>(q, k, v, out, bh, nq, nkv, scale, dtype, pl, s)
              : launch<64, kChannelMajor>(q, k, v, out, bh, nq, nkv, scale, dtype, pl, s);
  return (int)err;
}

}  // namespace

extern "C" {

// q, out: (bh, nq, d); k, v: (bh, nkv, d); contiguous, float32 (dtype 0) or
// bfloat16 (dtype 1); d is 32 or 64; scale = 1/sqrt(d) as f32.  Returns a
// cudaError_t (0 = launched).
int bugcar_flash_attention(const void* q, const void* k, const void* v, void* out, int bh,
                           int nq, int nkv, int d, float scale, int dtype, void* stream) {
  return dispatch<false>(q, k, v, out, bh, nq, nkv, d, scale, dtype, Plan{0, 0}, stream);
}

// The same on channel-major operands: q, out (bh, d, nq); k, v (bh, d, nkv).
int bugcar_flash_attention_t(const void* q, const void* k, const void* v, void* out, int bh,
                             int nq, int nkv, int d, float scale, int dtype, void* stream) {
  return dispatch<true>(q, k, v, out, bh, nq, nkv, d, scale, dtype, Plan{0, 0}, stream);
}

// The launch plan for (nq, d, dtype), into plan[0..4]: queries a CTA,
// ring stages, threads a CTA, dynamic shared memory bytes, keys a tile
// (bf16: the wgmma kernel's; f32: the SIMT kernel's one query a thread,
// 0, 64, 0, 64).  Both layouts take the same plan.
int bugcar_flash_attention_plan(int nq, int d, int dtype, int* plan) {
  if (dtype != 1) {
    plan[0] = kThreads;
    plan[1] = 0;
    plan[2] = kThreads;
    plan[3] = 0;
    plan[4] = kTileKv;
    return 0;
  }
  const Plan p = attention_plan(nq, d);
  plan[0] = kRows * p.consumers;
  plan[1] = p.stages;
  plan[2] = kWg * (p.consumers + 1);
  plan[3] = layout(d, p.consumers, p.stages).total;
  plan[4] = kKeys;
  return 0;
}

// The bf16 kernel at a given plan (64 or 128 queries a CTA, 2-4 ring
// stages): for measurement only, timing the plans against each other.
int bugcar_flash_attention_bf16_plan(const void* q, const void* k, const void* v, void* out,
                                     int bh, int nq, int nkv, int d, float scale,
                                     int channel_major, int rows, int stages, void* stream) {
  if (rows != 64 && rows != 128) return (int)cudaErrorInvalidValue;
  const Plan p{rows / kRows, stages};
  return channel_major ? dispatch<true>(q, k, v, out, bh, nq, nkv, d, scale, 1, p, stream)
                       : dispatch<false>(q, k, v, out, bh, nq, nkv, d, scale, 1, p, stream);
}

}  // extern "C"
