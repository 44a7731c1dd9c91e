// Block-sparse paged decode attention (the DSA compute phase) for Hopper.
//
// Replaces the Pallas TPU kernel `sparse_decode_attention` in
// src/repro/kernels/sparse_decode_attention.py.  One decode token per
// request attends to the K KV blocks its DSA selection picked:
//   out[b, h*G+g] = softmax_t(q[b,h*G+g] . k[t] * scale) @ v[t]
// over the positions t of the selected blocks of kv-head h that are valid
// (sel_valid) and below cur_len[b].  A row with no valid position is 0 (the
// softmax denominator is clamped to 1e-30, as in the Pallas kernel).
//
// What bounds it: bytes.  Per (request, kv-head) it reads K blocks of K and
// V (K * bs * (D + Dv) elements) and does ~2 * G * (D + Dv) flops per
// element pair read: G = 7 (qwen2-0.5b) or 4 (llama3-8b) flops per byte of
// bf16, far below the ~295 the H100 needs before the tensor cores bind.
//
// Design: one CTA of 4 warps per (request, kv-head), which loads its own
// block ids and walks the K blocks in order with an online softmax in f32.
// Each block of K and V is staged in shared memory with 16-byte vector
// loads (K rows padded by one float, so the per-token dot products are free
// of bank conflicts); the whole GQA group (any G <= 16, not only powers of
// two) shares the staged block, warp w owning query heads w, w+4, ...
// Lanes own tokens for the scores and head dims for the accumulator.
// Blocks that are invalid or lie wholly beyond cur_len are skipped, which
// leaves the online-softmax state exactly as the masked update would.
// Known limit: B * Hkv CTAs fill only a small part of the 132 SMs at decode
// batch sizes; splitting K across CTAs (flash-decoding) is later work.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadsPerWarp = 4;   // G <= 16
constexpr int kMaxDimChunks = 4;      // D, Dv <= 128
constexpr int kMaxTokChunks = 4;      // bs <= 128
constexpr float kNegInf = -1e30f;

template <typename T>
__global__ void __launch_bounds__(kThreads)
sparse_decode_attention_kernel(const T* __restrict__ q,
                               const T* __restrict__ k_pool,
                               const T* __restrict__ v_pool,
                               const int* __restrict__ block_idx,
                               const uint8_t* __restrict__ sel_valid,
                               const int* __restrict__ cur_len,
                               T* __restrict__ out, int Hkv, int NB, int bs,
                               int D, int Dv, int K, int G, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                  // G * D
  float* k_s = q_s + G * D;           // bs * (D + 1)
  float* v_s = k_s + bs * (D + 1);    // bs * Dv
  constexpr int kVec = 16 / sizeof(T);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Hq = Hkv * G;

  const T* qg = q + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) q_s[i] = to_f32(qg[i]);

  const int len = cur_len[b];
  const size_t head_row = ((size_t)b * Hkv + h);
  const size_t blk0 = head_row * NB;
  const int* idx = block_idx + head_row * K;
  const uint8_t* val = sel_valid + head_row * K;

  float m[kMaxHeadsPerWarp], l[kMaxHeadsPerWarp];
  float acc[kMaxHeadsPerWarp][kMaxDimChunks];
#pragma unroll
  for (int hi = 0; hi < kMaxHeadsPerWarp; ++hi) {
    m[hi] = kNegInf;
    l[hi] = 0.f;
#pragma unroll
    for (int dc = 0; dc < kMaxDimChunks; ++dc) acc[hi][dc] = 0.f;
  }

  for (int j = 0; j < K; ++j) {
    const int blk = idx[j];
    // CTA-uniform skip: an invalid selection or a block wholly at or beyond
    // cur_len contributes nothing to the online softmax
    if (!val[j] || blk < 0 || blk >= NB || blk * bs >= len) continue;
    __syncthreads();   // the previous block's reads of k_s / v_s are done
    const T* kb = k_pool + (blk0 + blk) * (size_t)bs * D;
    const T* vb = v_pool + (blk0 + blk) * (size_t)bs * Dv;
    for (int i = tid * kVec; i < bs * D; i += kThreads * kVec) {
      float f[kVec];
      load16_f32<T>(kb + i, f);
      const int t = i / D, d = i % D;
#pragma unroll
      for (int e = 0; e < kVec; ++e) k_s[t * (D + 1) + d + e] = f[e];
    }
    for (int i = tid * kVec; i < bs * Dv; i += kThreads * kVec) {
      load16_f32<T>(vb + i, v_s + i);
    }
    __syncthreads();

#pragma unroll
    for (int hi = 0; hi < kMaxHeadsPerWarp; ++hi) {
      const int g = warp + hi * kWarps;
      if (g >= G) break;                       // warp-uniform
      const float* qrow = q_s + g * D;
      float s[kMaxTokChunks];
      float smax = kNegInf;
#pragma unroll
      for (int c = 0; c < kMaxTokChunks; ++c) {
        const int t = lane + 32 * c;
        s[c] = kNegInf;
        if (t < bs && blk * bs + t < len) {
          const float* krow = k_s + t * (D + 1);
          float dot = 0.f;
          for (int d = 0; d < D; ++d) dot += qrow[d] * krow[d];
          s[c] = dot * scale;
        }
        smax = fmaxf(smax, s[c]);
      }
      smax = warp_max(smax);
      const float m_new = fmaxf(m[hi], smax);
      const float corr = expf(m[hi] - m_new);
      float p[kMaxTokChunks];
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxTokChunks; ++c) {
        p[c] = s[c] > 0.5f * kNegInf ? expf(s[c] - m_new) : 0.f;
        psum += p[c];
      }
      psum = warp_sum(psum);
      l[hi] = l[hi] * corr + psum;
#pragma unroll
      for (int dc = 0; dc < kMaxDimChunks; ++dc) acc[hi][dc] *= corr;
#pragma unroll
      for (int c = 0; c < kMaxTokChunks; ++c) {
        if (32 * c >= bs) break;
        for (int tt = 0; tt < 32; ++tt) {
          const int t = 32 * c + tt;
          if (t >= bs) break;
          const float pt = __shfl_sync(0xffffffffu, p[c], tt);
          const float* vrow = v_s + t * Dv;
#pragma unroll
          for (int dc = 0; dc < kMaxDimChunks; ++dc) {
            const int d = lane + 32 * dc;
            if (d < Dv) acc[hi][dc] += pt * vrow[d];
          }
        }
      }
      m[hi] = m_new;
    }
  }

#pragma unroll
  for (int hi = 0; hi < kMaxHeadsPerWarp; ++hi) {
    const int g = warp + hi * kWarps;
    if (g >= G) break;
    const float denom = fmaxf(l[hi], 1e-30f);
    T* orow = out + ((size_t)b * Hq + (size_t)h * G + g) * Dv;
#pragma unroll
    for (int dc = 0; dc < kMaxDimChunks; ++dc) {
      const int d = lane + 32 * dc;
      if (d < Dv) orow[d] = from_f32<T>(acc[hi][dc] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* block_idx, const void* sel_valid, const void* cur_len,
           void* out, int B, int Hkv, int NB, int bs, int D, int Dv, int K,
           int G, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)G * D + (size_t)bs * (D + 1) + (size_t)bs * Dv);
  auto kern = sparse_decode_attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_idx),
      static_cast<const uint8_t*>(sel_valid),
      static_cast<const int*>(cur_len), static_cast<T*>(out), Hkv, NB, bs, D,
      Dv, K, G, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bfloat16 only (the serving path's dtype).  Limits checked by the wrapper:
// G <= 16, D and Dv <= 128 and multiples of 16 bytes, bs <= 128, all
// pointers 16-byte aligned, tensors contiguous.
extern "C" int launch_sparse_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_idx, const void* sel_valid, const void* cur_len,
    void* out, int B, int Hkv, int NB, int bs, int D, int Dv, int K, int G,
    float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_pool, v_pool, block_idx, sel_valid,
                               cur_len, out, B, Hkv, NB, bs, D, Dv, K, G,
                               scale, static_cast<cudaStream_t>(stream));
}
