// Block scatter into the device KV pool, in place, for Hopper.
//
// Replaces the Pallas TPU kernel `scatter_blocks_hkv` in
// src/repro/kernels/scatter_blocks.py: payload (H, K, bs, D) lands in pool
// blocks dest[k] of every head; untouched blocks persist.  Here the pool
// may also carry a leading batch-row axis, with rows[k] naming each payload
// block's row, so one launch lands a whole batch's restores; and the
// payload is cast to the pool's dtype on the way (a float32 host payload
// into a bfloat16 pool, rounding to nearest even as torch does).
//
// What bounds it: bytes: H * K blocks read once and written once.
//
// Design: one CTA per (payload block, head); threads stride over the
// block's bs * D elements so reads and writes are coalesced, converting
// through float.  An out-of-range row or block id is skipped (the wrapper
// bounds-checks ids on the host first).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
scatter_blocks_kernel(const Tin* __restrict__ payload,
                      const int* __restrict__ rows,
                      const int* __restrict__ blocks, Tout* __restrict__ pool,
                      long long row_stride, long long head_stride,
                      long long block_stride, int B, int NB, int K,
                      int blk_elems) {
  const int k = blockIdx.x;
  const int h = blockIdx.y;
  const int blk = blocks[k];
  const int row = rows != nullptr ? rows[k] : 0;
  if (blk < 0 || blk >= NB || row < 0 || row >= B) return;
  const Tin* s = payload + ((size_t)h * K + k) * blk_elems;
  Tout* d = pool + row * row_stride + h * head_stride + blk * block_stride;
  for (int i = threadIdx.x; i < blk_elems; i += kThreads)
    d[i] = from_f32<Tout>(to_f32(s[i]));
}

template <typename Tin, typename Tout>
int launch(const void* payload, const void* rows, const void* blocks,
           void* pool, long long row_stride, long long head_stride,
           long long block_stride, int B, int H, int NB, int K,
           int blk_elems, cudaStream_t stream) {
  if (K == 0 || H == 0) return (int)cudaGetLastError();
  scatter_blocks_kernel<Tin, Tout><<<dim3(K, H), kThreads, 0, stream>>>(
      static_cast<const Tin*>(payload), static_cast<const int*>(rows),
      static_cast<const int*>(blocks), static_cast<Tout*>(pool), row_stride,
      head_stride, block_stride, B, NB, K, blk_elems);
  return (int)cudaGetLastError();
}

}  // namespace

// The pool is bfloat16 (the serving path's dtype); the payload is float32
// (a restore from the host pool) or bfloat16 (a drop's zero blocks).  rows
// may be null (pool without a batch-row axis, B == 1).  Strides are in pool
// elements; each block's bs * D elements must be contiguous.
extern "C" int launch_scatter_blocks_hkv(
    int payload_dtype, const void* payload, const void* rows,
    const void* blocks, void* pool, long long row_stride,
    long long head_stride, long long block_stride, int B, int H, int NB,
    int K, int blk_elems, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (payload_dtype == kFloat32)
    return launch<float, __nv_bfloat16>(payload, rows, blocks, pool,
                                        row_stride, head_stride, block_stride,
                                        B, H, NB, K, blk_elems, s);
  if (payload_dtype == kBFloat16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        payload, rows, blocks, pool, row_stride, head_stride, block_stride, B,
        H, NB, K, blk_elems, s);
  return (int)cudaErrorInvalidValue;
}
