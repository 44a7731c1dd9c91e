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
