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
// A second, byte-generic kernel (wrapper `write_blocks_hkv`) copies
// payload blocks of the pool's own dtype into a pool that may lie in
// pinned host memory, written in place through its device-mapped address:
// the write back of the int8 tier's requantized blocks and their float32
// scales into the DRAM pool (the device-to-host half of FlashD2H), one
// launch per tensor.
//
// The same byte-generic kernel at H = 1 (entry `launch_scatter_blocks`,
// wrapper `scatter_blocks`) replaces the flat Pallas kernel
// `scatter_blocks` in src/repro/kernels/scatter_blocks.py: new_kv
// (n_new * bs, D), contiguous, lands block by block in pool (NB, bs, D)
// blocks dest[i], byte for byte, untouched blocks persisting.  The pool may
// be a pinned host pool written through its device-mapped address: the
// second phase of FlashD2H (placing a contiguous flush into paged blocks).
//
// What bounds it: bytes: H * K blocks read once and written once (into a
// host pool, over the PCIe link).
//
// Design: one CTA per (payload block, head); threads stride over the
// block's bs * D elements so reads and writes are coalesced, converting
// through float.  The kernel skips an out-of-range row or block id; the
// wrapper raises on one wherever the ids are host-held (every call the
// port's planes make), before they are uploaded, as the plain version
// does.  Ids handed over as a device tensor are the caller's to check.
//
// A zero-fill kernel (entry `launch_zero_blocks_hkv`, wrapper
// `zero_blocks_hkv`) replaces the drop use of the Pallas
// `scatter_blocks_hkv`, which scatters a zero payload
// (src/repro/core/device_pool.py:745-758, `DevicePoolPlane.drop_blocks`):
// a whole round of evictions, N items of (pool, batch row, block) over a
// table of pools of one shape and strides (K and V of every layer of a
// decode plane), is zeroed in one launch.  What bounds it: bytes written,
// N * H blocks of bs * D bf16; it reads no payload, only the 12-byte items
// and the table.  Design: one CTA per (item, head), each thread storing
// 16-byte units of zeros with coalesced stores: a round of ~300 evicted
// blocks of K and V at H = 2 is ~1,200 CTAs over the 132 SMs, one 4 KB
// block each.
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

// write_blocks: V as in gather_blocks.cu (uint4 or uint32_t units)
template <typename V>
__global__ void __launch_bounds__(kThreads)
write_blocks_kernel(const V* __restrict__ payload,
                    const int* __restrict__ blocks, char* __restrict__ pool,
                    long long head_stride, long long block_stride, int NB,
                    int K, long long blk_vecs) {
  const int k = blockIdx.x;
  const int h = blockIdx.y;
  const int blk = blocks[k];
  if (blk < 0 || blk >= NB) return;
  const V* s = payload + ((size_t)h * K + k) * blk_vecs;
  V* d = reinterpret_cast<V*>(pool + h * head_stride + blk * block_stride);
  for (long long i = threadIdx.x; i < blk_vecs; i += kThreads) d[i] = s[i];
}

// zero_blocks: items (N, 3) int32 of (pool, row, block); pools the device
// table of pool base addresses; strides in bytes, units = 16-byte units per
// block
__global__ void __launch_bounds__(kThreads)
zero_blocks_kernel(const unsigned long long* __restrict__ pools,
                   const int* __restrict__ items, long long row_stride,
                   long long head_stride, long long block_stride,
                   int units) {
  const int* it = items + 3 * (size_t)blockIdx.x;
  const int h = blockIdx.y;
  uint4* d = reinterpret_cast<uint4*>(
      reinterpret_cast<char*>(pools[it[0]]) + it[1] * row_stride
      + h * head_stride + it[2] * block_stride);
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int u = threadIdx.x; u < units; u += kThreads) d[u] = z;
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

// write_blocks: payload (H, K, block_bytes) of the pool's dtype into the
// (H, NB, ...) pool at dst_base + dst_offset, a device allocation or a
// pinned host one (dst_on_host != 0).  Strides and block_bytes in bytes,
// all multiples of 4; 16-byte units where every address allows it.
extern "C" int launch_write_blocks_hkv(
    const void* payload, const void* blocks, void* dst_base,
    long long dst_offset, int dst_on_host, long long head_stride,
    long long block_stride, int H, int NB, int K, long long block_bytes,
    void* stream) {
  char* dst = static_cast<char*>(dst_base);
  if (dst_on_host) {
    void* dev = nullptr;
    cudaError_t e = cudaHostGetDevicePointer(&dev, dst_base, 0);
    if (e != cudaSuccess) return (int)e;
    dst = static_cast<char*>(dev);
  }
  dst += dst_offset;
  if (K == 0 || H == 0) return (int)cudaGetLastError();
  if (block_bytes % 4 != 0 || head_stride % 4 != 0 || block_stride % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const bool wide = block_bytes % 16 == 0 && head_stride % 16 == 0 &&
                    block_stride % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dst) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(payload) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide)
    write_blocks_kernel<uint4><<<dim3(K, H), kThreads, 0, s>>>(
        static_cast<const uint4*>(payload), static_cast<const int*>(blocks),
        dst, head_stride, block_stride, NB, K, block_bytes / 16);
  else
    write_blocks_kernel<uint32_t><<<dim3(K, H), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(payload),
        static_cast<const int*>(blocks), dst, head_stride, block_stride, NB,
        K, block_bytes / 4);
  return (int)cudaGetLastError();
}

// The flat FlashD2H scatter: new_kv (n_new, block_bytes) contiguous into
// blocks dest[i] of the (NB, block_bytes) pool at dst_base + dst_offset
// (device memory, or pinned host memory when dst_on_host != 0), byte for
// byte; the H = 1 case of write_blocks.
extern "C" int launch_scatter_blocks(const void* new_kv, const void* dest,
                                     void* dst_base, long long dst_offset,
                                     int dst_on_host, int NB, int n_new,
                                     long long block_bytes, void* stream) {
  return launch_write_blocks_hkv(new_kv, dest, dst_base, dst_offset,
                                 dst_on_host, (long long)NB * block_bytes,
                                 block_bytes, 1, NB, n_new, block_bytes,
                                 stream);
}

// zero_blocks_hkv: block items[i][2] of row items[i][1], every head, of
// pool items[i][0] in the table ``pools`` (N_pools device addresses, all
// pools (B, H, NB, bs, D) with the strides given, in bytes), zeroed for
// i < N.  Ids are checked by the wrapper; block_bytes and every stride a
// multiple of 16 and every pool 16-byte aligned (checked there too).
extern "C" int launch_zero_blocks_hkv(const void* pools, const void* items,
                                      int N, int H, long long row_stride,
                                      long long head_stride,
                                      long long block_stride,
                                      long long block_bytes, void* stream) {
  if (N == 0 || H == 0) return (int)cudaGetLastError();
  if (block_bytes % 16 != 0 || row_stride % 16 != 0 ||
      head_stride % 16 != 0 || block_stride % 16 != 0)
    return (int)cudaErrorInvalidValue;
  zero_blocks_kernel<<<dim3(N, H), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(pools),
      static_cast<const int*>(items), row_stride, head_stride, block_stride,
      (int)(block_bytes / 16));
  return (int)cudaGetLastError();
}
