// Quest cuboid block scores, max over the GQA group, for Hopper.
//
// Replaces the Pallas TPU kernel `block_score` in
// src/repro/kernels/block_score.py:
//   score[b, h, n] = max_g sum_d max(q[b,h*G+g,d] * mn[d], q[..,d] * mx[d])
//                  = max_g (pos_g . mx_n + neg_g . mn_n)
// with pos = max(q, 0), neg = min(q, 0).  Unlike the Pallas kernel, which
// takes split min/max arrays, it reads the block metadata in the layout the
// KV pool keeps: (B, Hkv, NB, 2, D) float32, [min, max] interleaved.
//
// What bounds it: bytes.  Each block's 2 * D floats of metadata are read
// once and used for 4 * G * D flops: 3.5 (qwen2-0.5b) or 2 (llama3-8b)
// flops per byte.
//
// Design: one CTA of 4 warps per (request, kv-head, tile of 32 blocks).
// The group's q rows, split into pos/neg, sit in shared memory; each warp
// takes one block at a time, lanes hold its min/max dims in registers
// (coalesced reads), and one warp reduction per query head gives the
// head's bound; the running max over heads is written by lane 0.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;             // blocks per CTA
constexpr int kMaxDimChunks = 4;      // D <= 128

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_score_kernel(const T* __restrict__ q, const float* __restrict__ meta,
                   float* __restrict__ out, int Hkv, int NB, int D, int G) {
  extern __shared__ float smem[];
  float* pos = smem;          // G * D
  float* neg = pos + G * D;   // G * D
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const T* qg = q + ((size_t)b * Hkv * G + (size_t)h * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const float x = to_f32(qg[i]);
    pos[i] = fmaxf(x, 0.f);
    neg[i] = fminf(x, 0.f);
  }
  __syncthreads();

  const size_t head_row = (size_t)b * Hkv + h;
  const int n_end = min(NB, (tile + 1) * kTile);
  for (int n = tile * kTile + warp; n < n_end; n += kWarps) {
    const float* mn = meta + (head_row * NB + n) * 2 * D;
    const float* mx = mn + D;
    float mnv[kMaxDimChunks], mxv[kMaxDimChunks];
#pragma unroll
    for (int dc = 0; dc < kMaxDimChunks; ++dc) {
      const int d = lane + 32 * dc;
      mnv[dc] = d < D ? mn[d] : 0.f;
      mxv[dc] = d < D ? mx[d] : 0.f;
    }
    float best = -INFINITY;
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int dc = 0; dc < kMaxDimChunks; ++dc) {
        const int d = lane + 32 * dc;
        if (d < D) s += pos[g * D + d] * mxv[dc] + neg[g * D + d] * mnv[dc];
      }
      best = fmaxf(best, warp_sum(s));
    }
    if (lane == 0) out[head_row * NB + n] = best;
  }
}

template <typename T>
int launch(const void* q, const void* meta, void* out, int B, int Hkv, int NB,
           int D, int G, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * (size_t)G * D;
  dim3 grid((NB + kTile - 1) / kTile, Hkv, B);
  block_score_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const float*>(meta),
      static_cast<float*>(out), Hkv, NB, D, G);
  return (int)cudaGetLastError();
}

}  // namespace

// q bfloat16 (the serving path's dtype), meta float32.  Limits checked by
// the wrapper: D <= 128, G * D * 8 bytes of shared memory <= 48 KB, tensors
// contiguous.
extern "C" int launch_block_score(const void* q, const void* meta, void* out,
                                  int B, int Hkv, int NB, int D, int G,
                                  void* stream) {
  return launch<__nv_bfloat16>(q, meta, out, B, Hkv, NB, D, G,
                               static_cast<cudaStream_t>(stream));
}
