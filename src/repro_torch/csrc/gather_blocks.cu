// FlashH2D block gather (head-major) for Hopper.
//
// Replaces the Pallas TPU kernel `gather_blocks_hkv` in
// src/repro/kernels/gather_blocks.py: pool (H, NB, bs, D), idx (K,) ->
// out (H, K, bs, D), every (head, block) copied whole.
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
// Design: one CTA per (block, head) copying the block with 16-byte vector
// loads and stores, neighbouring threads on neighbouring addresses.  Many
// small CTAs keep many host reads in flight.  An out-of-range block id
// yields a zero block (the wrapper bounds-checks ids on the host first).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_blocks_kernel(const uint4* __restrict__ src,
                     const int* __restrict__ idx, uint4* __restrict__ dst,
                     int NB, int K, long long blk_vecs) {
  const int k = blockIdx.x;
  const int h = blockIdx.y;
  const int blk = idx[k];
  uint4* d = dst + ((size_t)h * K + k) * blk_vecs;
  if (blk < 0 || blk >= NB) {
    for (long long i = threadIdx.x; i < blk_vecs; i += kThreads)
      d[i] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const uint4* s = src + ((size_t)h * NB + blk) * blk_vecs;
  for (long long i = threadIdx.x; i < blk_vecs; i += kThreads) d[i] = s[i];
}

}  // namespace

// src_base: start of the source tensor's allocation (device memory, or a
// pinned host allocation when src_on_host != 0); src_offset: byte offset of
// the (H, NB, bs, D) pool inside it.  block_bytes must be a multiple of 16.
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
  gather_blocks_kernel<<<dim3(K, H), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(src), static_cast<const int*>(idx),
      static_cast<uint4*>(dst), NB, K, block_bytes / 16);
  return (int)cudaGetLastError();
}
