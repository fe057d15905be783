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
// out once; at the probes' (16, 64, 128) the data (256 KB-1 MB) moves in
// well under a microsecond, below the cost of any launch.
//
// The design, on the tensor memory accelerator (TMA).  The probes asked
// whether the TPU's compiler could express a strided slice, a reshape-split
// and a shifted write into a zeroed scratch; TMA expresses each directly.
// Every CTA owns one output box (C x W x R elements, innermost first) and
// one thread drives the copies:
//
//   strided gather  one TMA load of x's map with traversal strides (1, sw,
//                   sr) (the map's elementStrides: the box spans bw * sw
//                   columns and br * sr rows of x and lands as a dense bw x
//                   br box), then one TMA store of that box into out's map.
//                   The map is x itself, so its strides are x's; a strided
//                   view (dims ceil(W / sw), ceil(R / sr), strides sw and sr
//                   pixels) would need a row stride shorter than its
//                   columns' extent when W is odd, outside the stride rule
//                   cuTensorMapEncodeTiled documents.
//   halo add        two TMA loads of x's map at the output box's origin
//                   shifted by (-1, -1) and (+1, +1) columns and rows: TMA
//                   fills the elements outside x with zeros, which stands in
//                   for the probe's zeroed scratch; the CTA's threads sum
//                   the two boxes in f32 (16 bytes a thread at a time),
//                   round once, and one TMA store writes the box, clipped at
//                   the ragged edges.
//
// The host plan (ops/cuda/probes.py: tma_plan, halo_plan) picks the boxes
// so that the probes' outputs spread over the 132 SMs in one wave, and
// passes the maps' dims, byte strides, boxes, traversal strides and the
// grid in; the launcher checks them against the tensors before it encodes
// the maps.  TMA needs 16-byte aligned bases and strides and an inner box
// of a multiple of 16 bytes: a tensor whose pixel (C * itemsize bytes) is
// not a multiple of 16, or whose base is not 16-byte aligned, takes the
// SIMT kernels below instead (the wrapper's route rule; counted apart).
//
// The SIMT kernels (PR 7's design): the gather gives each thread one
// 16-byte vector of one output pixel's channels (element by element when a
// pixel's run or a pointer is not 16-byte aligned), consecutive threads on
// consecutive addresses; the halo add stages a 4 x 16 x 32 tile with its
// border into shared memory thread by thread and writes the shifted sums.
//
// Also here: an empty kernel, the launch-floor yardstick of the timings.
//
// Built by plain nvcc into a shared library with a C interface (no PyTorch
// headers); bound with ctypes by ops/cuda/build.py.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ptx.cuh"

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

// -- TMA ---------------------------------------------------------------------

constexpr int kMaxBoxBytes = 16384;   // one box in shared memory (probes.MAX_BOX_BYTES)
constexpr int kBoxMax = 256;          // TMA: elements a box dimension spans
constexpr int kHaloThreads = 128;

// The C launchers' plan, int64 values, dims innermost first (C, W, R); the
// layout of ops/cuda/probes.py Plan.packed().
enum PlanSlot {
  kLoadDims = 0,       // 3: the map the loads read (x)
  kLoadStrides = 3,    // 2: bytes between neighbours along dims 1 and 2
  kLoadBox = 5,        // 3: elements of x a load box spans
  kLoadElem = 8,       // 3: traversal strides
  kStoreDims = 11,     // 3: the map the store writes (out)
  kStoreStrides = 14,  // 2
  kStoreBox = 16,      // 3
  kTiles = 19,         // 3: boxes along C, W, R of out
  kGrid = 22,          // CTAs, one a box
  kPlanLen = 23
};

// Output box of CTA blockIdx.x: (c0, w0, r0) in out's elements.
struct Tile {
  int c0, w0, r0;
};
__device__ __forceinline__ Tile tile_of(int bc, int bw, int br, int nc, int nw) {
  const int t = blockIdx.x;
  return {(t % nc) * bc, (t / nc % nw) * bw, (t / (nc * nw)) * br};
}

// a + b on one 32-bit word of each: one f32, or two bf16 summed in f32 and
// rounded once (to nearest even, as from_f32).
template <typename T>
__device__ __forceinline__ uint32_t add_word(uint32_t a, uint32_t b);
template <>
__device__ __forceinline__ uint32_t add_word<float>(uint32_t a, uint32_t b) {
  return __float_as_uint(__uint_as_float(a) + __uint_as_float(b));
}
template <>
__device__ __forceinline__ uint32_t add_word<__nv_bfloat16>(uint32_t a, uint32_t b) {
  const float lo = __uint_as_float(a << 16) + __uint_as_float(b << 16);
  const float hi = __uint_as_float(a & 0xffff0000u) + __uint_as_float(b & 0xffff0000u);
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

__device__ __forceinline__ void mbar_init_fenced(uint32_t bar) {
  mbar_init(bar, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One output box: load x's box at (c0, w0 * sw, r0 * sr) with traversal
// strides (1, sw, sr) -- the map's -- and store it at (c0, w0, r0).  Byte
// copies, so one kernel serves both dtypes.
__global__ void __launch_bounds__(32)
    strided_gather_tma(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap omap, int bc, int bw, int br, int nc,
                       int nw, int sw, int sr, int box_bytes) {
  __shared__ __align__(128) unsigned char buf[kMaxBoxBytes];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x != 0) return;
  const Tile t = tile_of(bc, bw, br, nc, nw);
  const uint32_t b = smem_u32(&bar), dst = smem_u32(buf);
  mbar_init_fenced(b);
  mbar_expect_tx(b, box_bytes);
  tma_load_3d(dst, &xmap, t.c0, t.w0 * sw, t.r0 * sr, b);
  mbar_wait(b, 0);
  // No proxy fence: the TMA load wrote the box and the TMA store reads it,
  // both through the async proxy, ordered by the mbarrier wait (a fence
  // here made the launch measurably slower).
  tma_store_3d(&omap, dst, t.c0, t.w0, t.r0);
}

// One output box: x's boxes at (c0, w0 - 1, r0 - 1) and (c0, w0 + 1,
// r0 + 1), zero outside x, summed in f32 and rounded once.
template <typename T>
__global__ void __launch_bounds__(kHaloThreads)
    halo_add_tma(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap omap, int bc, int bw, int br, int nc,
                 int nw, int box_bytes) {
  __shared__ __align__(128) unsigned char lo[kMaxBoxBytes];   // xp[r, w]
  __shared__ __align__(128) unsigned char hi[kMaxBoxBytes];   // xp[r + 2, w + 2]
  __shared__ __align__(8) uint64_t bar;
  const Tile t = tile_of(bc, bw, br, nc, nw);
  const uint32_t b = smem_u32(&bar);
  if (threadIdx.x == 0) mbar_init_fenced(b);
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(b, 2 * box_bytes);
    tma_load_3d(smem_u32(lo), &xmap, t.c0, t.w0 - 1, t.r0 - 1, b);
    tma_load_3d(smem_u32(hi), &xmap, t.c0, t.w0 + 1, t.r0 + 1, b);
  }
  mbar_wait(b, 0);
  for (int i = threadIdx.x; i < box_bytes / 16; i += kHaloThreads) {
    uint4 a = reinterpret_cast<const uint4*>(lo)[i];
    const uint4 c = reinterpret_cast<const uint4*>(hi)[i];
    a.x = add_word<T>(a.x, c.x);
    a.y = add_word<T>(a.y, c.y);
    a.z = add_word<T>(a.z, c.z);
    a.w = add_word<T>(a.w, c.w);
    reinterpret_cast<uint4*>(lo)[i] = a;
  }
  fence_proxy_async();   // the sums (generic proxy) before the TMA store reads them
  __syncthreads();
  if (threadIdx.x == 0) tma_store_3d(&omap, smem_u32(lo), t.c0, t.w0, t.r0);
}

__global__ void empty_kernel() {}

// The plan against the tensors: the load map is x (r, w, c) with traversal
// strides (1, sw, sr), the store map out (ro, wo, c); boxes within TMA's
// limits and one shared-memory buffer; the tiles cover out; 16-byte
// aligned bases, strides and inner boxes.
bool plan_ok(const long long* p, const void* x, const void* out, int r, int w, int c, int sr,
             int sw, int item) {
  const long long ro = (r + sr - 1) / sr, wo = (w + sw - 1) / sw, run = (long long)c * item;
  if (run % 16 != 0 || ((uintptr_t)x | (uintptr_t)out) % 16 != 0) return false;
  // the dims, strides and traversal strides (the boxes are checked below)
  const long long want[kStoreBox] = {c, w, r, run, run * w, 0, 0, 0, 1, sw, sr,
                                     c, wo, ro, run, run * wo};
  for (int i = 0; i < kStoreBox; ++i)
    if ((i < kLoadBox || i >= kLoadElem) && p[i] != want[i]) return false;
  const long long* box = p + kStoreBox;
  for (int d = 0; d < 3; ++d) {
    const long long ld = p[kLoadBox + d], st = box[d], el = p[kLoadElem + d];
    if (st < 1 || ld != st * el || ld > kBoxMax) return false;
    if (p[kTiles + d] != (p[kStoreDims + d] + st - 1) / st) return false;
  }
  if ((box[0] * item) % 16 != 0 || box[0] * box[1] * box[2] * item > kMaxBoxBytes) return false;
  const long long grid = p[kTiles] * p[kTiles + 1] * p[kTiles + 2];
  return p[kGrid] == grid && grid >= 1 && grid <= 0x7fffffffLL;
}

cudaError_t encode(CUtensorMap* map, int dtype, const void* base, const long long* dims,
                   const long long* strides, const long long* box, const long long* elem) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t gd[3] = {(cuuint64_t)dims[0], (cuuint64_t)dims[1], (cuuint64_t)dims[2]};
  const cuuint64_t gs[2] = {(cuuint64_t)strides[0], (cuuint64_t)strides[1]};
  const cuuint32_t bd[3] = {(cuuint32_t)box[0], (cuuint32_t)box[1], (cuuint32_t)box[2]};
  const cuuint32_t es[3] = {(cuuint32_t)elem[0], (cuuint32_t)elem[1], (cuuint32_t)elem[2]};
  const CUresult res = fn(map, dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                          3, const_cast<void*>(base), gd, gs, bd, es,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Both maps of a plan (the store map's traversal strides are ones).
cudaError_t encode_pair(CUtensorMap* xmap, CUtensorMap* omap, int dtype, const void* x,
                        const void* out, const long long* p) {
  static const long long ones[3] = {1, 1, 1};
  const cudaError_t err =
      encode(xmap, dtype, x, p + kLoadDims, p + kLoadStrides, p + kLoadBox, p + kLoadElem);
  if (err != cudaSuccess) return err;
  return encode(omap, dtype, out, p + kStoreDims, p + kStoreStrides, p + kStoreBox, ones);
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

// The TMA route of bugcar_strided_gather: the same tensors and checks, and
// the host plan (kPlanLen int64 values, ops/cuda/probes.py tma_plan);
// cudaErrorInvalidValue when the plan does not fit the tensors or TMA.
int bugcar_strided_gather_tma(const void* x, void* out, int r, int w, int c, int sr, int sw,
                              int dtype, const long long* plan, void* stream) {
  const bool ok_stride = (sr == 2 && sw == 1) || (sr == 1 && sw == 2) || (sr == 2 && sw == 2);
  if (r < 1 || w < 1 || c < 1 || !ok_stride || (dtype != 0 && dtype != 1) || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  const int item = dtype == 0 ? 4 : 2;
  if (!plan_ok(plan, x, out, r, w, c, sr, sw, item)) return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, omap;
  const cudaError_t err = encode_pair(&xmap, &omap, dtype, x, out, plan);
  if (err != cudaSuccess) return (int)err;
  const long long* box = plan + kStoreBox;
  strided_gather_tma<<<(unsigned)plan[kGrid], 32, 0, static_cast<cudaStream_t>(stream)>>>(
      xmap, omap, (int)box[0], (int)box[1], (int)box[2], (int)plan[kTiles],
      (int)plan[kTiles + 1], sw, sr, (int)(box[0] * box[1] * box[2] * item));
  return (int)cudaGetLastError();
}

// The TMA route of bugcar_halo_add (ops/cuda/probes.py halo_plan).
int bugcar_halo_add_tma(const void* x, void* out, int r, int w, int c, int dtype,
                        const long long* plan, void* stream) {
  if (r < 1 || w < 1 || c < 1 || (dtype != 0 && dtype != 1) || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  const int item = dtype == 0 ? 4 : 2;
  if (!plan_ok(plan, x, out, r, w, c, 1, 1, item)) return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, omap;
  const cudaError_t err = encode_pair(&xmap, &omap, dtype, x, out, plan);
  if (err != cudaSuccess) return (int)err;
  const long long* box = plan + kStoreBox;
  const int bc = (int)box[0], bw = (int)box[1], br = (int)box[2];
  const int nc = (int)plan[kTiles], nw = (int)plan[kTiles + 1], bytes = bc * bw * br * item;
  const unsigned grid = (unsigned)plan[kGrid];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    halo_add_tma<float><<<grid, kHaloThreads, 0, s>>>(xmap, omap, bc, bw, br, nc, nw, bytes);
  else
    halo_add_tma<__nv_bfloat16><<<grid, kHaloThreads, 0, s>>>(xmap, omap, bc, bw, br, nc, nw,
                                                               bytes);
  return (int)cudaGetLastError();
}

// One CTA of one warp that does nothing: the launch floor.
int bugcar_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
