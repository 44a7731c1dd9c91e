// int8 KV-block (de)quantization of the DRAM offload tier, for Hopper.
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/quant_blocks.py:
//   quantize_blocks            x (H, K, bs, D) fp -> q int8 (H, K, bs, D),
//                              scales (H, K) float32, one per (head, block)
//   dequantize_blocks          q, scales -> (H, K, bs, D) float32
//   dequantize_scatter_blocks  q, scales -> bf16 pool blocks dest[k] (of
//                              batch row rows[k]) in place
// with the reference's arithmetic step for step, so that the int8 payload
// and scales equal the plain PyTorch and numpy versions bit for bit:
//   amax = max |x| (float32), scale = amax / 127 and inv = 1 / scale (IEEE
//   divisions, __fdiv_rn; inv = 1 where the scale is 0), q = clip(rint(
//   x * inv), -127, 127) with the product rounded on its own (__fmul_rn,
//   never contracted into an FMA), dequant = float32(q) * scale
//   (__fmul_rn), rounded once to bf16 (__float2bfloat16_rn) on a scatter.
// The build uses no fast-math flag, so nothing here is approximated.
//
// What bounds them: bytes.  Each element is read once and written once
// with a handful of flops (far below the ~295 flops per byte at which the
// H100's compute would bind).
//
// Design: one CTA of 256 threads per (head, block): a 32 x 64 tile at the
// serve shapes.  Threads move 4 elements at a time with vector loads and
// stores, neighbouring threads on neighbouring addresses.  quantize makes
// two passes over its tile (the second from L1/L2): an amax reduction with
// warp shuffles and a shared-memory step across the 8 warps, then the
// rounding.  An out-of-range scatter row or block id is skipped (the
// wrapper bounds-checks ids on the host first).
//
// quant_save_blocks: the int8 tier's save, redesigned for the card.  It
// replaces, on the save path, the pair of Pallas kernels
// `quantize_blocks` (src/repro/kernels/quant_blocks.py:51) and
// `dequantize_blocks` (:86) as the reference's HostPool.flush uses them
// (its numpy twin `_store_quant_span`, src/repro/core/kv_cache.py:315):
// for every block segment of every staged stripe, the resident int8 block
// is dequantized with its scale, the stripe's tokens [off, off + n)
// overwrite their slots (widened to float32), and the whole block is
// requantized with a fresh scale and written back.  One launch takes a
// whole round of items (one item: a request pool, K or V, one block
// segment), every request of a layer's save; the pools are separate
// pinned allocations, so each item carries its own addresses: the
// stripe's (any head and token strides, float32 or bfloat16), the pool
// block's and its scale's, layer offset applied, device-mapped.  The
// wrapper puts two items on one block in different rounds, in staging
// order, since a second requantize of a block is not one merged one.
//
// What bounds it: PCIe latency and bytes, not HBM.  The int8 pools and
// scale planes lie in pinned host memory and are read and written in
// place over the link (2 KB and 4 bytes per (item, head) at the serve
// shape, each way); a save moves a few tens of KB, so one round trip's
// latency (~1-2 us) is most of it.  The design pays that latency once
// per layer save, not once per request and tensor: one launch takes
// every request's K and V, and each CTA issues every load (payload, scale
// and stripe) before it uses any, so their round trips overlap; a
// segment that covers its whole block (off == 0, n == bs: prefill) reads
// nothing from the pool, the overlay replacing every element.
//
// One CTA per (item, head), a 32 x 64 tile at the serve shape, 256
// threads of up to 4 x 4 elements each, held in registers between the
// read and the write (bs * D <= 4096): dequantize, overlay, amax by warp
// shuffles and one shared-memory step, then the rounding above.  MLA's
// blocks (one latent head of 288: 32 x 288 = 9216 elements) take an
// instance of 12 x 4 elements a thread (bs * D <= 12288); the 4 x 4 one
// serves every other config.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

typedef __nv_bfloat16 bf16;

// 4 consecutive elements (16 bytes of float, 8 of bf16) widened to float
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ signed char quant1(float x, float inv) {
  const float r = rintf(__fmul_rn(x, inv));
  return static_cast<signed char>(fminf(fmaxf(r, -127.f), 127.f));
}

__device__ __forceinline__ float4 dequant4(char4 c, float s) {
  return make_float4(__fmul_rn((float)c.x, s), __fmul_rn((float)c.y, s),
                     __fmul_rn((float)c.z, s), __fmul_rn((float)c.w, s));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_blocks_kernel(const T* __restrict__ x, char4* __restrict__ q,
                       float* __restrict__ scales, int blk_elems) {
  __shared__ float red[kWarps];
  const size_t blk = blockIdx.x;   // h * K + k
  const int n4 = blk_elems / 4;
  const T* xb = x + blk * blk_elems;
  float amax = 0.f;
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    const float4 f = load4(xb + 4 * i);
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(f.x), fabsf(f.y)),
                             fmaxf(fabsf(f.z), fabsf(f.w))));
  }
  amax = warp_max(amax);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    amax = warp_max(lane < kWarps ? red[lane] : 0.f);
    if (lane == 0) red[0] = amax;
  }
  __syncthreads();
  const float scale = __fdiv_rn(red[0], 127.0f);
  const float inv = scale > 0.f ? __fdiv_rn(1.0f, scale) : 1.0f;
  if (threadIdx.x == 0) scales[blk] = scale;
  char4* qb = q + blk * n4;
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    const float4 f = load4(xb + 4 * i);
    qb[i] = make_char4(quant1(f.x, inv), quant1(f.y, inv), quant1(f.z, inv),
                       quant1(f.w, inv));
  }
}

__global__ void __launch_bounds__(kThreads)
dequantize_blocks_kernel(const char4* __restrict__ q,
                         const float* __restrict__ scales,
                         float4* __restrict__ out, int blk_elems) {
  const size_t blk = blockIdx.x;
  const int n4 = blk_elems / 4;
  const float s = scales[blk];
  for (int i = threadIdx.x; i < n4; i += kThreads)
    out[blk * n4 + i] = dequant4(q[blk * n4 + i], s);
}

__global__ void __launch_bounds__(kThreads)
dequantize_scatter_blocks_kernel(const char4* __restrict__ q,
                                 const float* __restrict__ scales,
                                 const int* __restrict__ rows,
                                 const int* __restrict__ blocks,
                                 bf16* __restrict__ pool,
                                 long long row_stride, long long head_stride,
                                 long long block_stride, int B, int NB,
                                 int K, int blk_elems) {
  const int k = blockIdx.x;
  const int h = blockIdx.y;
  const int blk = blocks[k];
  const int row = rows != nullptr ? rows[k] : 0;
  if (blk < 0 || blk >= NB || row < 0 || row >= B) return;
  const int n4 = blk_elems / 4;
  const size_t src = (size_t)h * K + k;
  const float s = scales[src];
  const char4* qb = q + src * n4;
  uint2* d = reinterpret_cast<uint2*>(pool + row * row_stride +
                                      h * head_stride + blk * block_stride);
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    const float4 f = dequant4(qb[i], s);
    __nv_bfloat162 lo, hi;
    lo.x = __float2bfloat16_rn(f.x);
    lo.y = __float2bfloat16_rn(f.y);
    hi.x = __float2bfloat16_rn(f.z);
    hi.y = __float2bfloat16_rn(f.w);
    uint2 w;
    w.x = *reinterpret_cast<uint32_t*>(&lo);
    w.y = *reinterpret_cast<uint32_t*>(&hi);
    d[i] = w;
  }
}

// One item of quant_save_blocks (kernels/ops.py packs it: 8 int64).
struct SaveItem {
  long long stripe;     // device address of the stripe at (head 0, token
                        // of the segment's first slot, 0)
  long long stripe_hs;  // stripe head stride, elements
  long long stripe_ts;  // stripe token stride, elements
  long long pool;       // device address of pool[layer, 0, block] (int8)
  long long pool_hs;    // pool head stride, bytes (NB * bs * D)
  long long scale;      // device address of scales[layer, 0, block]
  long long scale_hs;   // scale plane head stride, floats (NB)
  long long meta;       // off | n << 16 | stripe dtype << 32
};
static_assert(sizeof(SaveItem) == 64, "SaveItem is 8 int64");

// 4-element chunks a thread holds: kSaveChunks (bs * D <= 4096), or
// kSaveChunksWide (<= 12288: MLA's 288-wide latent)
constexpr int kSaveChunks = 4;
constexpr int kSaveChunksWide = 12;

template <typename T>
__device__ __forceinline__ float4 load_stripe4(const void* p) {
  const T* s = static_cast<const T*>(p);
  return make_float4(to_f32(s[0]), to_f32(s[1]), to_f32(s[2]),
                     to_f32(s[3]));
}

template <int kChunks>
__global__ void __launch_bounds__(kThreads)
quant_save_blocks_kernel(const SaveItem* __restrict__ items, int bs,
                         int D) {
  __shared__ float red[kWarps];
  const SaveItem it = items[blockIdx.x];
  const int h = blockIdx.y;
  const int off = (int)(it.meta & 0xffff);
  const int n = (int)((it.meta >> 16) & 0xffff);
  const bool bf = ((it.meta >> 32) & 0xff) == kBFloat16;
  const int n4 = bs * D / 4;
  char4* pb = reinterpret_cast<char4*>(it.pool + h * it.pool_hs);
  float* sp = reinterpret_cast<float*>(it.scale) + h * it.scale_hs;
  const int esz = bf ? 2 : 4;
  const char* st = reinterpret_cast<const char*>(it.stripe)
                   + (size_t)h * it.stripe_hs * esz;
  const bool whole = off == 0 && n == bs;
  // every load first, none used yet: the pool's and the scale's round
  // trips over the link overlap (a whole-block segment reads no pool)
  const float s_old = whole ? 0.f : *sp;
  char4 raw[kChunks];
  float4 x[kChunks];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c >= n4) continue;
    const int t = 4 * c / D;
    if (t >= off && t < off + n) {
      const char* p = st + ((t - off) * it.stripe_ts + (4 * c - t * D))
                           * (long long)esz;
      x[j] = bf ? load_stripe4<bf16>(p) : load_stripe4<float>(p);
    } else {
      raw[j] = pb[c];
    }
  }
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c >= n4) continue;
    const int t = 4 * c / D;
    if (!(t >= off && t < off + n)) x[j] = dequant4(raw[j], s_old);
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(x[j].x), fabsf(x[j].y)),
                             fmaxf(fabsf(x[j].z), fabsf(x[j].w))));
  }
  amax = warp_max(amax);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    amax = warp_max(lane < kWarps ? red[lane] : 0.f);
    if (lane == 0) red[0] = amax;
  }
  __syncthreads();
  const float scale = __fdiv_rn(red[0], 127.0f);
  const float inv = scale > 0.f ? __fdiv_rn(1.0f, scale) : 1.0f;
  if (threadIdx.x == 0) *sp = scale;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c >= n4) continue;
    pb[c] = make_char4(quant1(x[j].x, inv), quant1(x[j].y, inv),
                       quant1(x[j].z, inv), quant1(x[j].w, inv));
  }
}

}  // namespace

// Shared limits, checked by the wrappers: contiguous tensors, 16-byte
// aligned, bs * D a multiple of 4.

// x_dtype: kFloat32 or kBFloat16 (common.cuh); n_blocks = H * K.
extern "C" int launch_quantize_blocks(int x_dtype, const void* x, void* q,
                                      void* scales, int n_blocks,
                                      int blk_elems, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks == 0) return (int)cudaGetLastError();
  if (x_dtype == kFloat32)
    quantize_blocks_kernel<float><<<n_blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<char4*>(q),
        static_cast<float*>(scales), blk_elems);
  else if (x_dtype == kBFloat16)
    quantize_blocks_kernel<bf16><<<n_blocks, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<char4*>(q),
        static_cast<float*>(scales), blk_elems);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int launch_dequantize_blocks(const void* q, const void* scales,
                                        void* out, int n_blocks,
                                        int blk_elems, void* stream) {
  if (n_blocks == 0) return (int)cudaGetLastError();
  dequantize_blocks_kernel<<<n_blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char4*>(q), static_cast<const float*>(scales),
      static_cast<float4*>(out), blk_elems);
  return (int)cudaGetLastError();
}

// The pool is bfloat16 (the serving path's dtype), (H, NB, bs, D) with rows
// null (B == 1) or (B, H, NB, bs, D) with rows (K,); strides in pool
// elements, each block's bs * D elements contiguous.
extern "C" int launch_dequantize_scatter_blocks(
    const void* q, const void* scales, const void* rows, const void* blocks,
    void* pool, long long row_stride, long long head_stride,
    long long block_stride, int B, int H, int NB, int K, int blk_elems,
    void* stream) {
  if (K == 0 || H == 0) return (int)cudaGetLastError();
  dequantize_scatter_blocks_kernel<<<dim3(K, H), kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char4*>(q), static_cast<const float*>(scales),
      static_cast<const int*>(rows), static_cast<const int*>(blocks),
      static_cast<bf16*>(pool), row_stride, head_stride, block_stride, B,
      NB, K, blk_elems);
  return (int)cudaGetLastError();
}

// quant_save_blocks: n_items SaveItems (device memory) of pools of bs x D
// blocks and H heads, one CTA per (item, head).  The wrapper checks what
// the kernel takes: D % 4 == 0, bs * D <= 4 * 12 * 256, 4-byte aligned
// pool blocks, no block twice in one launch.
extern "C" int launch_quant_save_blocks(const void* items, int n_items,
                                        int H, int bs, int D, void* stream) {
  if (n_items == 0 || H == 0) return (int)cudaGetLastError();
  if (D % 4 != 0 || bs * D > 4 * kSaveChunksWide * kThreads)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_items, H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SaveItem* it = static_cast<const SaveItem*>(items);
  if (bs * D <= 4 * kSaveChunks * kThreads)
    quant_save_blocks_kernel<kSaveChunks><<<grid, kThreads, 0, s>>>(it, bs,
                                                                   D);
  else
    quant_save_blocks_kernel<kSaveChunksWide><<<grid, kThreads, 0, s>>>(
        it, bs, D);
  return (int)cudaGetLastError();
}

// The device address of a pinned host allocation (its base, as PyTorch's
// pinned allocator returned it), for kernels that read or write it in
// place; the items of quant_save_blocks carry such addresses.
extern "C" int host_device_address(const void* host, void* out) {
  return (int)cudaHostGetDevicePointer(static_cast<void**>(out),
                                       const_cast<void*>(host), 0);
}
