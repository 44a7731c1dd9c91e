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
// What bounds it: bytes and latency.  Per (request, kv-head) it reads K
// blocks of K and V (K * bs * (D + Dv) elements) and does ~2 * G * (D + Dv)
// flops per element pair read: G = 7 (qwen2-0.5b) or 4 (llama3-8b) flops
// per byte of bf16, far below the ~295 at which the H100's tensor cores
// bind.  At decode batch sizes the bytes are few (4 MB at the serve's
// B 4 x Hkv 2 x K 64 x bs 32 x D 64), so two dependent DRAM round trips
// and a second launch set the floor.
//
// Design (flash-decoding): the K selected blocks of each (request, kv-head)
// are split into runs of ceil(K / splits) blocks, and the GQA group into
// tiles of at most 16 query rows (one tile up to G = 16; granite-20b's
// G = 48 makes three), one CTA of 8 warps per (split, group tile,
// kv-head, request), so B * Hkv * tiles * splits CTAs fill the 132 SMs
// (the wrapper picks splits >= 2 * 132 / (B * Hkv * tiles) where K
// allows, and runs of at most 4 blocks, since a CTA walks its run in
// turn).  The tiles of one split stream the same K and V blocks, the
// second and third reads mostly from L2; each writes its own rows of the
// partials, so the merge is the same for any G.  Each
// CTA compacts its run's live ids (valid, in range, starting below
// cur_len: a CTA-uniform skip that leaves the softmax state exactly as the
// masked update would), then streams their K and V blocks as bf16 into
// shared memory with cp.async, double-buffered (each block one contiguous
// run; K rows padded by 16 bytes so the per-token 16-byte reads are free of
// bank conflicts).  Per block: scores of every (head of the GQA group,
// token) pair into shared memory, one warp per head for the online-softmax
// update (max, exp, sum, kept in shared memory), then the P V update with
// each thread owning up to 4 (head, pair of value dims) float32
// accumulators at Dv <= 128, or 10 in the wide instantiation that takes
// Dv up to 320, so no register array is indexed by heads and dims at once
// (ptxas: no spills).  The wide one serves MLA's latent attend (minicpm3:
// G = 40 query heads, three group tiles, over one latent head with D =
// Dv = 288): its shared memory grows to ~95 KB (q 18 KB, K and V stages
// 74 KB), opted in at launch, so two CTAs fit an SM.  There the pool is
// passed as both k_pool and v_pool and each block is streamed twice;
// loading it once is left for later.  At G = 40 the float32 FMAs do ~40
// flops per byte read, about twice what the H100's FP32 rate sustains at
// its HBM rate, so that shape is bound by operations, ~2x its byte bound.  All arithmetic is float32 FMA: the kernel is bound by
// bytes, not operations.  Each CTA writes its unnormalised partial
// (acc, m, l) in float32 to scratch the wrapper allocates; a second kernel
// merges the splits of each (request, query head) by log-sum-exp and
// writes bf16.  A split with no live block writes m = -1e30, l = 0,
// acc = 0, which the merge weights by 0 (or, when every split is empty,
// turns into an output of 0).
//
// The partial mode (the context-parallel decode, reference
// src/repro/core/dsa.py:206 `sparse_decode_attention_partial`, which the
// reference runs as plain jnp inside its shard_map): a rank holds a
// shard of NB_loc blocks of each pool, the ids are LOCAL, and a
// position's validity is taken at its GLOBAL position, (id + offset) *
// bs + t < cur_len, offset the global id of the shard's block 0.  The
// split kernel is the same template with that offset (the bf16 mode's
// instance compiles without it); a second merge kernel writes each
// (request, query head)'s float32 (acc, m, l) over all splits,
// unnormalised (acc and l relative to m = the max over the splits), for
// the ranks' own log-sum-exp merge.  A rank with no live block for a
// row writes m = -1e30, l = 0, acc = 0, as the reference's partial.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileG = 16;     // query rows of one group tile
// (head, value-dim pair) items per thread: kTileG * Dv / 2 <= kItems *
// kThreads, so Dv <= 128 (the narrow instantiation) or Dv <= 320 (wide).
// Both give the same bits at Dv <= 128, where the narrow one is 3-4%
// faster (ab_kernels.py, PERF.md)
constexpr int kNarrowItems = 4;
constexpr int kWideItems = 10;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

struct Smem {       // Gt: the rows of one group tile, <= kTileG
  float* q;       // Gt * D
  float* sc;      // Gt * bs: scores, then weights
  float* m;       // Gt
  float* l;       // Gt
  float* corr;    // Gt
  int* ids;       // per: the run's live block ids
  int* n_live;    // 1
  __nv_bfloat16* k;   // 2 stages x bs x (D + 8)
  __nv_bfloat16* v;   // 2 stages x bs x Dv
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~15; }

// byte offsets of the Smem fields, shared by the kernel, the launch and
// sparse_decode_attention_smem_bytes (the wrapper's check)
struct SmemLayout {
  size_t q, sc, m, l, corr, ids, n_live, k, v, total;
  __host__ __device__ SmemLayout(int G, int D, int Dv, int bs, int per) {
    q = 0;
    sc = q + sizeof(float) * G * D;
    m = sc + sizeof(float) * G * bs;
    l = m + sizeof(float) * G;
    corr = l + sizeof(float) * G;
    ids = corr + sizeof(float) * G;
    n_live = ids + sizeof(int) * per;
    k = align16(n_live + sizeof(int));
    v = k + sizeof(__nv_bfloat16) * 2 * bs * (D + 8);
    total = v + sizeof(__nv_bfloat16) * 2 * bs * Dv;
  }
};

template <int kItems, bool kPartial = false>
__global__ void __launch_bounds__(kThreads)
split_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k_pool,
             const __nv_bfloat16* __restrict__ v_pool,
             const int* __restrict__ block_idx,
             const uint8_t* __restrict__ sel_valid,
             const int* __restrict__ cur_len, float* __restrict__ part_o,
             float* __restrict__ part_ml, int Hkv, int NB, int bs, int D,
             int Dv, int K, int G, int splits, int per, float scale,
             int offset) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int split = blockIdx.x % splits;
  const int g0 = blockIdx.x / splits * kTileG;   // the tile's first row
  const int Gt = min(kTileG, G - g0);            // and its rows
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const SmemLayout lay(min(G, kTileG), D, Dv, bs, per);
  Smem s;
  s.q = reinterpret_cast<float*>(smem_raw + lay.q);
  s.sc = reinterpret_cast<float*>(smem_raw + lay.sc);
  s.m = reinterpret_cast<float*>(smem_raw + lay.m);
  s.l = reinterpret_cast<float*>(smem_raw + lay.l);
  s.corr = reinterpret_cast<float*>(smem_raw + lay.corr);
  s.ids = reinterpret_cast<int*>(smem_raw + lay.ids);
  s.n_live = reinterpret_cast<int*>(smem_raw + lay.n_live);
  s.k = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.k);
  s.v = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.v);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Hq = Hkv * G;
  const int len = cur_len[b];
  // the shard's first global block id (partial mode; 0 otherwise)
  const int blk_off = kPartial ? offset : 0;
  const size_t head_row = (size_t)b * Hkv + h;
  const int j0 = split * per;
  const int j1 = min(K, j0 + per);

  const __nv_bfloat16* qg =
      q + ((size_t)b * Hq + (size_t)h * G + g0) * D;
  for (int i = tid; i < Gt * D; i += kThreads) s.q[i] = to_f32(qg[i]);
  if (tid < Gt) {
    s.m[tid] = kNegInf;
    s.l[tid] = 0.f;
  }
  if (warp == 0) {   // compact the run's live ids, in order
    const int* idx = block_idx + head_row * K;
    const uint8_t* val = sel_valid + head_row * K;
    int n = 0;
    for (int base = j0; base < j1; base += 32) {
      const int j = base + lane;
      int blk = -1;
      if (j < j1) blk = idx[j];
      const bool live = j < j1 && val[j] && blk >= 0 && blk < NB &&
                        (blk + blk_off) * bs < len;
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) s.ids[n + __popc(mask & ((1u << lane) - 1))] = blk;
      n += __popc(mask);
    }
    if (lane == 0) *s.n_live = n;
  }
  __syncthreads();
  const int n_live = *s.n_live;

  const size_t blk0 = head_row * NB;
  const int k_stride = D + 8;
  auto load = [&](int j, int stage) {
    const int blk = s.ids[j];
    const __nv_bfloat16* kb = k_pool + (blk0 + blk) * (size_t)bs * D;
    const __nv_bfloat16* vb = v_pool + (blk0 + blk) * (size_t)bs * Dv;
    __nv_bfloat16* kd = s.k + (size_t)stage * bs * k_stride;
    __nv_bfloat16* vd = s.v + (size_t)stage * bs * Dv;
    const int kc = D / 8;
    for (int c = tid; c < bs * kc; c += kThreads)
      cp_async16(kd + (c / kc) * k_stride + (c % kc) * 8, kb + c * 8);
    for (int c = tid; c < bs * Dv / 8; c += kThreads)
      cp_async16(vd + c * 8, vb + c * 8);
  };

  const int n_pairs = Dv / 2;
  const int n_items = Gt * n_pairs;
  float acc[kItems][2];
#pragma unroll
  for (int i = 0; i < kItems; ++i) acc[i][0] = acc[i][1] = 0.f;

  if (n_live > 0) load(0, 0);
  cp_async_commit();
  for (int j = 0; j < n_live; ++j) {
    const int st = j & 1;
    if (j + 1 < n_live) load(j + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait1();   // every group but the newest: block j has landed
    __syncthreads();
    const int pos0 = (s.ids[j] + blk_off) * bs;
    const __nv_bfloat16* ks = s.k + (size_t)st * bs * k_stride;
    const __nv_bfloat16* vs = s.v + (size_t)st * bs * Dv;

    // scores of every (head, token) pair; lanes on neighbouring tokens
    for (int p = tid; p < Gt * bs; p += kThreads) {
      const int g = p / bs, t = p - g * bs;
      float dot = kNegInf;
      if (pos0 + t < len) {
        const float* qrow = s.q + g * D;
        const __nv_bfloat16* krow = ks + t * k_stride;
        float d0 = 0.f, d1 = 0.f;   // two chains of dependent FMAs
#pragma unroll 4
        for (int d = 0; d < D; d += 8) {
          float kf[8];
          load16_f32<__nv_bfloat16>(krow + d, kf);
          const float4 qa = *reinterpret_cast<const float4*>(qrow + d);
          const float4 qb = *reinterpret_cast<const float4*>(qrow + d + 4);
          d0 = fmaf(qa.x, kf[0], d0);
          d1 = fmaf(qa.y, kf[1], d1);
          d0 = fmaf(qa.z, kf[2], d0);
          d1 = fmaf(qa.w, kf[3], d1);
          d0 = fmaf(qb.x, kf[4], d0);
          d1 = fmaf(qb.y, kf[5], d1);
          d0 = fmaf(qb.z, kf[6], d0);
          d1 = fmaf(qb.w, kf[7], d1);
        }
        dot = (d0 + d1) * scale;
      }
      s.sc[p] = dot;
    }
    __syncthreads();

    // online-softmax update, one warp per head
    for (int g = warp; g < Gt; g += kWarps) {
      float* row = s.sc + g * bs;
      float mx = kNegInf;
      for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, row[t]);
      mx = warp_max(mx);
      const float m_old = s.m[g];
      const float m_new = fmaxf(m_old, mx);
      float psum = 0.f;
      for (int t = lane; t < bs; t += 32) {
        const float pt = row[t] > 0.5f * kNegInf ? expf(row[t] - m_new) : 0.f;
        row[t] = pt;
        psum += pt;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        s.corr[g] = corr;
        s.l[g] = s.l[g] * corr + psum;
        s.m[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V, each thread on its (head, dim pair) items
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int it = tid + i * kThreads;
      if (it < n_items) {
        const int g = it / n_pairs, dp = it - g * n_pairs;
        const float corr = s.corr[g];
        float a0 = acc[i][0] * corr, a1 = acc[i][1] * corr;
        const float* prow = s.sc + g * bs;
        const __nv_bfloat162* vcol =
            reinterpret_cast<const __nv_bfloat162*>(vs) + dp;
#pragma unroll 8
        for (int t = 0; t < bs; ++t) {
          const float pt = prow[t];
          const float2 vf = __bfloat1622float2(vcol[t * n_pairs]);
          a0 = fmaf(pt, vf.x, a0);
          a1 = fmaf(pt, vf.y, a1);
        }
        acc[i][0] = a0;
        acc[i][1] = a1;
      }
    }
    __syncthreads();   // sc and this stage are free for the next block
  }

  // this tile's rows g0 .. g0 + Gt - 1 of the split's partial
  const size_t part = head_row * splits + split;
  float* po = part_o + (part * G + g0) * Dv;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int it = tid + i * kThreads;
    if (it < n_items)
      reinterpret_cast<float2*>(po)[it] = make_float2(acc[i][0], acc[i][1]);
  }
  if (tid < Gt) {
    part_ml[part * 2 * G + g0 + tid] = s.m[tid];
    part_ml[part * 2 * G + G + g0 + tid] = s.l[tid];
  }
}

// out[b, h*G+g, d] = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M),
// 1e-30), M = max_s m_s, over the splits of (b, h): one CTA per (query
// head, request), the split weights in shared memory, a thread per output
// dim (in turn past kThreads)
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ part_o,
             const float* __restrict__ part_ml, __nv_bfloat16* __restrict__ out,
             int Hkv, int Dv, int G, int splits) {
  extern __shared__ float w_s[];   // splits
  __shared__ float red[kWarps];
  const int hq = blockIdx.x;
  const int b = blockIdx.y;
  const int h = hq / G, g = hq - h * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t head_row = (size_t)b * Hkv + h;
  const float* pml = part_ml + head_row * splits * 2 * G;

  float M = kNegInf;
  for (int sp = tid; sp < splits; sp += kThreads)
    M = fmaxf(M, pml[sp * 2 * G + g]);
  M = warp_max(M);
  if (lane == 0) red[warp] = M;
  __syncthreads();
  M = red[0];
  for (int w = 1; w < kWarps; ++w) M = fmaxf(M, red[w]);
  __syncthreads();
  float L = 0.f;
  for (int sp = tid; sp < splits; sp += kThreads) {
    const float w = expf(pml[sp * 2 * G + g] - M);
    w_s[sp] = w;
    L = fmaf(pml[sp * 2 * G + G + g], w, L);
  }
  L = warp_sum(L);
  if (lane == 0) red[warp] = L;
  __syncthreads();
  L = 0.f;
  for (int w = 0; w < kWarps; ++w) L += red[w];
  const float inv = 1.f / fmaxf(L, 1e-30f);
  const float* po = part_o + (head_row * splits * G + g) * Dv;
  for (int d = tid; d < Dv; d += kThreads) {
    float O = 0.f;
    for (int sp = 0; sp < splits; ++sp)
      O = fmaf(po[(size_t)sp * G * Dv + d], w_s[sp], O);
    out[((size_t)b * Hkv * G + hq) * Dv + d] =
        from_f32<__nv_bfloat16>(O * inv);
  }
}

// The partial mode's merge: acc[b, h*G+g, d] = sum_s acc_s e^(m_s - M),
// m = M = max_s m_s, l = sum_s l_s e^(m_s - M), float32, over the splits
// of (b, h); one CTA per (query head, request), as merge_kernel.
__global__ void __launch_bounds__(kThreads)
merge_partial_kernel(const float* __restrict__ part_o,
                     const float* __restrict__ part_ml,
                     float* __restrict__ acc, float* __restrict__ m_out,
                     float* __restrict__ l_out, int Hkv, int Dv, int G,
                     int splits) {
  extern __shared__ float w_s[];   // splits
  __shared__ float red[kWarps];
  const int hq = blockIdx.x;
  const int b = blockIdx.y;
  const int h = hq / G, g = hq - h * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t head_row = (size_t)b * Hkv + h;
  const float* pml = part_ml + head_row * splits * 2 * G;

  float M = kNegInf;
  for (int sp = tid; sp < splits; sp += kThreads)
    M = fmaxf(M, pml[sp * 2 * G + g]);
  M = warp_max(M);
  if (lane == 0) red[warp] = M;
  __syncthreads();
  M = red[0];
  for (int w = 1; w < kWarps; ++w) M = fmaxf(M, red[w]);
  __syncthreads();
  float L = 0.f;
  for (int sp = tid; sp < splits; sp += kThreads) {
    const float w = expf(pml[sp * 2 * G + g] - M);
    w_s[sp] = w;
    L = fmaf(pml[sp * 2 * G + G + g], w, L);
  }
  L = warp_sum(L);
  if (lane == 0) red[warp] = L;
  __syncthreads();
  L = 0.f;
  for (int w = 0; w < kWarps; ++w) L += red[w];
  const size_t row = (size_t)b * Hkv * G + hq;
  if (tid == 0) {
    m_out[row] = M;
    l_out[row] = L;
  }
  const float* po = part_o + (head_row * splits * G + g) * Dv;
  for (int d = tid; d < Dv; d += kThreads) {
    float O = 0.f;
    for (int sp = 0; sp < splits; ++sp)
      O = fmaf(po[(size_t)sp * G * Dv + d], w_s[sp], O);
    acc[row * Dv + d] = O;
  }
}

}  // namespace

// bfloat16 only (the serving path's dtype).  Limits checked by the wrapper:
// any G >= 1 (in tiles of kTileG rows), D and Dv <= 320 and multiples of
// 8, bs <= 128, all pointers 16-byte aligned, tensors contiguous.  part_o
// (B, Hkv, splits, G, Dv) and part_ml (B, Hkv, splits, 2, G) are float32
// scratch.  Dv <= 128 runs the narrow instantiation.
// the split kernel's dynamic shared memory in bytes at these shapes
extern "C" int sparse_decode_attention_smem_bytes(int G, int D, int Dv,
                                                  int bs, int K,
                                                  int splits) {
  const int per = K > 0 ? (K + splits - 1) / splits : 0;
  return (int)SmemLayout(min(G, kTileG), D, Dv, bs, per).total;
}

extern "C" int launch_sparse_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_idx, const void* sel_valid, const void* cur_len,
    void* out, void* part_o, void* part_ml, int B, int Hkv, int NB, int bs,
    int D, int Dv, int K, int G, int splits, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || Hkv == 0) return (int)cudaGetLastError();
  const int tiles = (G + kTileG - 1) / kTileG;
  if (splits < 1 || G < 1 || kTileG * Dv > 2 * kWideItems * kThreads)
    return (int)cudaErrorInvalidValue;
  const int per = K > 0 ? (K + splits - 1) / splits : 0;
  const SmemLayout lay(min(G, kTileG), D, Dv, bs, per);
  auto kern = kTileG * Dv <= 2 * kNarrowItems * kThreads
                  ? split_kernel<kNarrowItems>
                  : split_kernel<kWideItems>;
  if (lay.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(splits * tiles, Hkv, B), kThreads, lay.total, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int*>(block_idx),
      static_cast<const uint8_t*>(sel_valid),
      static_cast<const int*>(cur_len), static_cast<float*>(part_o),
      static_cast<float*>(part_ml), Hkv, NB, bs, D, Dv, K, G, splits, per,
      scale, 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_kernel<<<dim3(Hkv * G, B), kThreads, sizeof(float) * splits, st>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<__nv_bfloat16*>(out), Hkv, Dv, G, splits);
  return (int)cudaGetLastError();
}

// The partial mode: the same arguments, with block ids local to a shard
// whose block 0 is global block ``offset``; writes float32 acc (B, Hkv *
// G, Dv) and ml (2, B, Hkv * G): m, then l.
extern "C" int launch_sparse_decode_attention_partial(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_idx, const void* sel_valid, const void* cur_len,
    void* acc, void* ml, void* part_o, void* part_ml, int B, int Hkv,
    int NB, int bs, int D, int Dv, int K, int G, int splits, int offset,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || Hkv == 0) return (int)cudaGetLastError();
  const int tiles = (G + kTileG - 1) / kTileG;
  if (splits < 1 || G < 1 || offset < 0 ||
      kTileG * Dv > 2 * kWideItems * kThreads)
    return (int)cudaErrorInvalidValue;
  const int per = K > 0 ? (K + splits - 1) / splits : 0;
  const SmemLayout lay(min(G, kTileG), D, Dv, bs, per);
  auto kern = kTileG * Dv <= 2 * kNarrowItems * kThreads
                  ? split_kernel<kNarrowItems, true>
                  : split_kernel<kWideItems, true>;
  if (lay.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(splits * tiles, Hkv, B), kThreads, lay.total, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int*>(block_idx),
      static_cast<const uint8_t*>(sel_valid),
      static_cast<const int*>(cur_len), static_cast<float*>(part_o),
      static_cast<float*>(part_ml), Hkv, NB, bs, D, Dv, K, G, splits, per,
      scale, offset);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  float* m_out = static_cast<float*>(ml);
  merge_partial_kernel<<<dim3(Hkv * G, B), kThreads, sizeof(float) * splits,
                         st>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<float*>(acc), m_out, m_out + (size_t)B * Hkv * G, Hkv, Dv,
      G, splits);
  return (int)cudaGetLastError();
}
