// FlashH2D block gather for Hopper.
//
// Replaces the Pallas TPU kernels `gather_blocks_hkv` in
// src/repro/kernels/gather_blocks.py: pool (H, NB, bs, D), idx (K,) ->
// out (H, K, bs, D), every (head, block) copied whole; and `gather_blocks`
// in the same file, the flat form pool (NB, bs, D) -> (K, bs, D), which is
// the H = 1 case of the same kernel (entry `launch_gather_blocks`).
//
// The source may be a pinned host tensor (the host KV pool): the kernel
// then reads it in place through its device-mapped address, so the gather
// IS the host-to-device transfer of the fragmented blocks, one launch for
// all of them (the paper's FlashH2D, section 3.2.1), instead of one
// cudaMemcpy per block.
//
// What bounds it: bytes, and from a host source the PCIe link rather than
// HBM: H * K blocks of bs * D elements are read once and written once, no
// arithmetic.
//
// Byte-generic: it moves the float32 pools of the fp tier, the int8 pools
// of the int8 tier and their float32 scale planes (4-byte blocks) alike.
//
// Design: one CTA per (block, head) copying the block with 16-byte vector
// loads and stores (4-byte ones for blocks that are not whole 16-byte
// vectors), neighbouring threads on neighbouring addresses.  Many
// small CTAs keep many host reads in flight.  An out-of-range block id
// yields a zero block (the wrapper bounds-checks ids on the host first).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// V: the unit each thread moves, uint4 (16 bytes) where the block and both
// bases allow it, else uint32_t (4 bytes: a plane of one f32 scale per
// (head, block) of the int8 tier is such a pool).
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_blocks_kernel(const V* __restrict__ src, const int* __restrict__ idx,
                     V* __restrict__ dst, int NB, int K, long long blk_vecs) {
  const int k = blockIdx.x;
  const int h = blockIdx.y;
  const int blk = idx[k];
  V* d = dst + ((size_t)h * K + k) * blk_vecs;
  if (blk < 0 || blk >= NB) {
    for (long long i = threadIdx.x; i < blk_vecs; i += kThreads) d[i] = V{};
    return;
  }
  const V* s = src + ((size_t)h * NB + blk) * blk_vecs;
  for (long long i = threadIdx.x; i < blk_vecs; i += kThreads) d[i] = s[i];
}

}  // namespace

// src_base: start of the source tensor's allocation (device memory, or a
// pinned host allocation when src_on_host != 0); src_offset: byte offset of
// the (H, NB, bs, D) pool inside it.  block_bytes must be a multiple of 4;
// blocks move in 16-byte units when block_bytes and both addresses are
// multiples of 16.
extern "C" int launch_gather_blocks_hkv(const void* src_base,
                                        long long src_offset, int src_on_host,
                                        const void* idx, void* dst, int H,
                                        int NB, int K, long long block_bytes,
                                        void* stream) {
  const char* src = static_cast<const char*>(src_base);
  if (src_on_host) {
    void* dev = nullptr;
    cudaError_t e =
        cudaHostGetDevicePointer(&dev, const_cast<void*>(src_base), 0);
    if (e != cudaSuccess) return (int)e;
    src = static_cast<const char*>(dev);
  }
  src += src_offset;
  if (K == 0 || H == 0) return (int)cudaGetLastError();
  if (block_bytes % 4 != 0) return (int)cudaErrorInvalidValue;
  const bool wide = block_bytes % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide)
    gather_blocks_kernel<uint4><<<dim3(K, H), kThreads, 0, s>>>(
        reinterpret_cast<const uint4*>(src), static_cast<const int*>(idx),
        static_cast<uint4*>(dst), NB, K, block_bytes / 16);
  else
    gather_blocks_kernel<uint32_t><<<dim3(K, H), kThreads, 0, s>>>(
        reinterpret_cast<const uint32_t*>(src), static_cast<const int*>(idx),
        static_cast<uint32_t*>(dst), NB, K, block_bytes / 4);
  return (int)cudaGetLastError();
}

// The flat FlashH2D gather: pool (NB, bs, D) at src_base + src_offset
// (device memory, or pinned host memory read in place when src_on_host !=
// 0), idx (K,) -> dst (K, bs, D); the H = 1 case of the head-major gather.
extern "C" int launch_gather_blocks(const void* src_base, long long src_offset,
                                    int src_on_host, const void* idx,
                                    void* dst, int NB, int K,
                                    long long block_bytes, void* stream) {
  return launch_gather_blocks_hkv(src_base, src_offset, src_on_host, idx,
                                  dst, 1, NB, K, block_bytes, stream);
}
