// Quest cuboid block scores, max over the GQA group, and the fused DSA
// block selection, for Hopper.
//
// `block_score` replaces the Pallas TPU kernel `block_score` in
// src/repro/kernels/block_score.py:
//   score[b, h, n] = max_g sum_d max(q[b,h*G+g,d] * mn[d], q[..,d] * mx[d])
//                  = max_g (pos_g . mx_n + neg_g . mn_n)
// with pos = max(q, 0), neg = min(q, 0).  Unlike the Pallas kernel, which
// takes split min/max arrays, it reads the block metadata in the layout the
// KV pool keeps: (B, Hkv, NB, 2, D) float32, [min, max] interleaved.
//
// `score_select` fuses that bound with the selection the reference runs
// after it, `select_blocks(score_blocks(q, meta), cfg, cur_len + 1)`
// (src/repro/core/dsa.py:133-162), and computes the reference's other
// scorings in `score_blocks` (src/repro/core/dsa.py:86-117) in the same
// launch: InfLLM's mean metadata, (B, Hkv, NB, D) float32 block means,
// scored q . mean_n, and the sum over the GQA group in place of the max,
// each as a template instance (the cuboid / max instance is the code it
// was, bit for bit).  Then: blocks at or past n = ceil((cur_len +
// 1) / bs) masked to -1e30, valid sink and recent blocks forced to +inf,
// the top min(K, NB) per (request, kv-head), sel_valid = score > -5e29 and
// invalid ids replaced by block 0.  It takes cur_len as the cache holds it
// and adds the +1 itself, so no PyTorch op runs between the select stage's
// start and its ids.  One launch.  The ids come out ordered by score,
// highest first, ties by block id, lowest first; torch.topk and
// jax.lax.top_k may order a selection otherwise, so callers compare id
// sets.
//
// What bounds them: bytes.  Each block's 2 * D floats of metadata are read
// once and used for 4 * G * D flops: 3.5 (qwen2-0.5b) or 2 (llama3-8b)
// flops per byte.  At the serve's shape (B 4, Hkv 2, NB 136, D 64) that is
// 0.28 MB, 0.08 us at the HBM rate: both kernels are latency-bound, and the
// design cuts the serial steps on the way from q to the ids.
//
// Design.  A block's bound is summed by a group of 8 lanes, each holding
// D / 8 of the block's min and max dims in registers (4 16-byte chunks of
// each a lane up to D = 128; score_select's wide instantiation holds 10,
// up to D = 320, for MLA's 288-wide latent metadata; 16-byte loads,
// coalesced across the group, issued before the q rows are staged so the
// two loads overlap), so a warp scores 4 blocks at once and each query
// head's sum needs three shuffles inside the group (the previous design
// walked 8 blocks per warp in turn, with a five-shuffle warp sum per query
// head and block).  The group's q rows, split into pos / neg, sit in
// shared memory.
// - block_score: one CTA of 64 threads per (8 blocks, kv-head, request):
//   136 CTAs at the serve's shape.  A wide instance (10 chunks a lane, up
//   to D = 320; 512 threads over 16 blocks, each block's heads split in
//   four, vectorised q staging: block_score_wide_kernel) scores MLA's
//   latent metadata for the context-parallel decode.
// - score_select: one thread block cluster of C <= 8 CTAs per (kv-head,
//   request), each scoring a slice of NB / C blocks and writing each
//   block's masked, forced key into the shared memory of every CTA of the
//   cluster (distributed shared memory; a relaxed cluster arrive at the
//   start and its wait after the first scores keep the barrier that makes
//   those writes safe off the critical path).  After the cluster barrier
//   every CTA holds all NB keys, and each places the blocks of its own
//   slice that rank below K (score descending, then block id ascending: a
//   total order, so the ranks are 0 .. NB - 1 once each) at their rank.
//   No sort and no further cluster barrier.  Up to NB = kRankAllNB (512)
//   each block is ranked among all NB keys, one warp per block, lanes over
//   the keys: NB^2 / C comparisons per CTA, ~2,300 at the serve's shape
//   (64 CTAs, NB 136).  Above it that would grow to ~2 M at NB 4096 and
//   ~8.4 M at 8193, so each CTA first finds the K-th key T by a radix
//   select over the keys' order-preserving bits (four passes of an 8-bit
//   histogram in shared memory), which also gives the number c of keys
//   above T.  Only a block above T is ranked among all NB keys (fewer
//   than K such blocks per cluster); a block equal to T takes rank c +
//   the number of equal keys of lower id, from a scan of the CTA's slice
//   after a count of the equal keys before it, and is selected if that is
//   below K.  So the large-NB select costs O(NB / 256 + K * NB / C / 256)
//   steps per thread.  Keys are held with -0 as +0, so the bits and the
//   float comparisons order them alike.
//   Shared memory per CTA: 8 * G * D + 4 * NB bytes (the GQA group's q
//   rows as pos / neg float32, and the keys); above 48 KB the launch opts
//   in to the card's 227 KB, which bounds NB and G * D (the wrapper's
//   select_max_nb): NB up to ~56,000 at llama3-8b's G * D = 512, ~45,000
//   at granite-20b's G = 48, D = 128, ~33,000 at minicpm3's latent (G =
//   40 absorbed query heads over one latent head, D = 288).
//   The unfused block_score needs 8 * G * D bytes and opts in the same
//   way.
#include "common.cuh"

#include <algorithm>
#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 8;           // lanes per block's sum
constexpr int kNarrowChunks = 4;    // 16-byte chunks per lane: D <= 128
constexpr int kWideChunks = 10;     // score_select's wide kernel: D <= 320
                                    // (same bits at D <= 128, ~20% slower
                                    // there: ab_kernels.py, PERF.md)
constexpr int kScoreThreads = 64;   // block_score: 8 blocks per CTA
constexpr int kWideBlocks = 16;     // block_score's wide instance: 16
constexpr int kWideHeadSplit = 4;   // blocks a CTA, each block's heads in
                                    // four quarters, one a warp quarter
constexpr int kWideScoreThreads = kWideBlocks * kLanes * kWideHeadSplit;
constexpr int kSelThreads = 256;    // score_select: 32 blocks per pass
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr float kMasked = -1e30f;   // ref.NEG_INF
constexpr float kValidCut = -5e29f; // NEG_INF / 2
constexpr int kRankAllNB = 512;     // above: radix-select the K-th key
static_assert(kSelThreads == 256, "one histogram bin per thread");
constexpr int kDefaultSmem = 48 * 1024;   // without the opt-in

// A float's bits as an unsigned whose order is the floats' order (no NaN;
// -0 never occurs: keys are stored with -0 as +0).
__device__ __forceinline__ unsigned order_bits(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The GQA group's q rows (G * D values) as pos / neg float32 in shared
// memory; with kMean q itself in ``pos`` (``neg`` unused).
template <typename T, bool kMean = false>
__device__ __forceinline__ void load_group(const T* __restrict__ qg,
                                           float* pos, float* neg, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float x = to_f32(qg[i]);
    if constexpr (kMean) {
      pos[i] = x;
    } else {
      pos[i] = fmaxf(x, 0.f);
      neg[i] = fminf(x, 0.f);
    }
  }
}

// One block's metadata row as the 8 lanes of its lane group hold it: lane
// ``sub`` the 16-byte chunks sub, sub + 8, ... of min and of max (cuboid,
// (2, D)), or of the mean in ``mx`` (kMean, (D,); ``mn`` unused).
template <int kChunks>
struct MetaRegs {
  float4 mn[kChunks], mx[kChunks];
};

// Loads the row (16-byte aligned, D % 4 == 0); an inactive lane loads
// nothing.  Issued before the q rows are staged, so the two loads overlap.
template <int kChunks, bool kMean = false>
__device__ __forceinline__ void load_meta(MetaRegs<kChunks>& m,
                                          const float* __restrict__ mrow,
                                          int D, int sub, bool active) {
  const int chunks = D / 4;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int ch = sub + kLanes * c;
    if constexpr (kMean) {
      m.mx[c] = (active && ch < chunks)
                    ? __ldg(reinterpret_cast<const float4*>(mrow) + ch)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    } else if (active && ch < chunks) {
      m.mn[c] = __ldg(reinterpret_cast<const float4*>(mrow) + ch);
      m.mx[c] = __ldg(reinterpret_cast<const float4*>(mrow + D) + ch);
    } else {
      m.mn[c] = m.mx[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// One query head's share of the block's bound held by lane ``sub`` of the
// lane group (before the group's three-shuffle sum): pos_g . max + neg_g .
// min over its chunks, or with kMean pos_g . mean (``pos`` then holds q).
template <int kChunks, bool kMean = false>
__device__ __forceinline__ float head_part(const MetaRegs<kChunks>& m,
                                           const float* pos_g,
                                           const float* neg_g, int D,
                                           int sub) {
  const int chunks = D / 4;
  const float4* p4 = reinterpret_cast<const float4*>(pos_g);
  const float4* n4 = reinterpret_cast<const float4*>(neg_g);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int ch = sub + kLanes * c;
    if (ch < chunks) {
      const float4 p = p4[ch];
      if constexpr (kMean) {
        s += p.x * m.mx[c].x + p.y * m.mx[c].y + p.z * m.mx[c].z
             + p.w * m.mx[c].w;
      } else {
        const float4 n = n4[ch];
        s += p.x * m.mx[c].x + p.y * m.mx[c].y + p.z * m.mx[c].z
             + p.w * m.mx[c].w + n.x * m.mn[c].x + n.y * m.mn[c].y
             + n.z * m.mn[c].z + n.w * m.mn[c].w;
      }
    }
  }
  return s;
}

// The score of the block in ``m``: per query head of the group the cuboid
// bound, pos . max + neg . min, or with kMean q . mean (``pos`` then holds
// q itself), reduced over the group's G query heads by the max, or with
// kSum by the sum (in head order); summed by the 8 lanes of the lane group,
// and every lane of the group returns it.  All 32 lanes of the warp must
// call it (the shuffles take the full mask).
template <int kChunks, bool kMean = false, bool kSum = false>
__device__ __forceinline__ float block_bound(const MetaRegs<kChunks>& m,
                                             const float* pos,
                                             const float* neg, int D, int G,
                                             int sub) {
  float best = kSum ? 0.f : -INFINITY;
  for (int g = 0; g < G; ++g) {
    float s = head_part<kChunks, kMean>(m, pos + g * D, neg + g * D, D, sub);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if constexpr (kSum)
      best += s;
    else
      best = fmaxf(best, s);
  }
  return best;
}

template <typename T, int kChunks = kNarrowChunks>
__global__ void __launch_bounds__(kScoreThreads)
block_score_kernel(const T* __restrict__ q, const float* __restrict__ meta,
                   float* __restrict__ out, int Hkv, int NB, int D, int G) {
  extern __shared__ float4 smem4[];
  float* pos = reinterpret_cast<float*>(smem4);   // G * D
  float* neg = pos + G * D;                        // G * D
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head_row = (size_t)b * Hkv + h;
  const int n = blockIdx.x * (kScoreThreads / kLanes) + threadIdx.x / kLanes;
  const int sub = threadIdx.x % kLanes;
  const bool active = n < NB;
  MetaRegs<kChunks> m;
  load_meta(m, meta + (head_row * NB + (active ? n : 0)) * 2 * D, D, sub,
            active);
  load_group(q + ((size_t)b * Hkv * G + (size_t)h * G) * D, pos, neg,
             G * D);
  __syncthreads();
  const float s = block_bound(m, pos, neg, D, G, sub);
  if (active && sub == 0) out[head_row * NB + n] = s;
}

// The group's q rows staged as load_group stages them (cuboid), from 16-byte
// loads of 8 bf16, four of them in flight a thread before any is stored:
// ``n`` % 8 == 0 and ``qg`` 16-byte aligned.
__device__ __forceinline__ void load_group_x8(
    const __nv_bfloat16* __restrict__ qg, float* pos, float* neg, int n) {
  constexpr int kInFlight = 4;
  const uint4* src = reinterpret_cast<const uint4*>(qg);
  float4* p4 = reinterpret_cast<float4*>(pos);
  float4* n4 = reinterpret_cast<float4*>(neg);
  const int n8 = n / 8;
  for (int base = threadIdx.x; base < n8; base += kInFlight * blockDim.x) {
    uint4 u[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int i = base + j * blockDim.x;
      if (i < n8) u[j] = __ldg(src + i);
    }
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int i = base + j * blockDim.x;
      if (i >= n8) break;
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u[j]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 a = __bfloat1622float2(h[2 * half]);
        const float2 b = __bfloat1622float2(h[2 * half + 1]);
        p4[2 * i + half] = make_float4(fmaxf(a.x, 0.f), fmaxf(a.y, 0.f),
                                       fmaxf(b.x, 0.f), fmaxf(b.y, 0.f));
        n4[2 * i + half] = make_float4(fminf(a.x, 0.f), fminf(a.y, 0.f),
                                       fminf(b.x, 0.f), fminf(b.y, 0.f));
      }
    }
  }
}

// block_score's wide instance (D <= 320; MLA's latent: G = 40 query heads
// of 288 over one head, 92 KB of staged q a CTA).  Its first design was
// block_score_kernel's with 10 chunks a lane: 64 threads staging G * D
// values one 2-byte load at a time, each warp walking all 40 heads for its
// 4 blocks, 1.9x slower than the plain einsums.  Here a CTA of 512 threads
// scores 16 blocks: it stages the rows from 16-byte loads, four in flight
// a thread, and its four warp quarters each take a quarter of the heads
// for the same 16 blocks (two heads at a time, so two sums and their
// shuffles overlap), their maxima combined in shared memory: a warp walks
// 10 of MLA's heads, not 40, and a CTA's 16 warps hide one another's
// shared-memory latency, where the first design's 2 could not.  Each
// head's sum is block_bound's (head_part, then the same three shuffles)
// and the max is exact, so the scores are score_select's wide scoring bit
// for bit.
__global__ void __launch_bounds__(kWideScoreThreads)
block_score_wide_kernel(const __nv_bfloat16* __restrict__ q,
                        const float* __restrict__ meta,
                        float* __restrict__ out, int Hkv, int NB, int D,
                        int G) {
  extern __shared__ float4 smem4[];
  float* pos = reinterpret_cast<float*>(smem4);   // G * D
  float* neg = pos + G * D;                        // G * D
  __shared__ float part_best[kWideHeadSplit][kWideBlocks];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head_row = (size_t)b * Hkv + h;
  const int part = threadIdx.x / (kWideBlocks * kLanes);
  const int local = threadIdx.x % (kWideBlocks * kLanes) / kLanes;
  const int n = blockIdx.x * kWideBlocks + local;
  const int sub = threadIdx.x % kLanes;
  const bool active = n < NB;
  MetaRegs<kWideChunks> m;
  load_meta(m, meta + (head_row * NB + (active ? n : 0)) * 2 * D, D, sub,
            active);
  const __nv_bfloat16* qg = q + ((size_t)b * Hkv * G + (size_t)h * G) * D;
  if ((G * D) % 8 == 0 && (reinterpret_cast<uintptr_t>(qg) & 15) == 0)
    load_group_x8(qg, pos, neg, G * D);
  else
    load_group(qg, pos, neg, G * D);
  __syncthreads();
  const int g1 = (part + 1) * G / kWideHeadSplit;
  float best = -INFINITY;
  int g = part * G / kWideHeadSplit;
  for (; g + 1 < g1; g += 2) {
    float s0 = head_part(m, pos + g * D, neg + g * D, D, sub);
    float s1 = head_part(m, pos + (g + 1) * D, neg + (g + 1) * D, D, sub);
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    best = fmaxf(best, fmaxf(s0, s1));
  }
  if (g < g1) {
    float s = head_part(m, pos + g * D, neg + g * D, D, sub);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    best = fmaxf(best, s);
  }
  if (sub == 0) part_best[part][local] = best;   // -inf for a quarter
  __syncthreads();                              // without heads (G < 4)
  if (threadIdx.x < kWideBlocks) {
    const int nb = blockIdx.x * kWideBlocks + threadIdx.x;
    float v = part_best[0][threadIdx.x];
#pragma unroll
    for (int p = 1; p < kWideHeadSplit; ++p)
      v = fmaxf(v, part_best[p][threadIdx.x]);
    if (nb < NB) out[head_row * NB + nb] = v;
  }
}

// The cluster barrier in two halves (PTX ISA 8.0, sm_90): an arrive that
// orders no memory, and the matching wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename T, int kChunks, bool kMean, bool kSum>
__global__ void __launch_bounds__(kSelThreads)
score_select_kernel(const T* __restrict__ q, const float* __restrict__ meta,
                    const int* __restrict__ cur_len, int* __restrict__ idx,
                    bool* __restrict__ sel_valid, int Hkv, int NB, int D,
                    int G, int K, int bs, int sink, int recent) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  extern __shared__ float4 smem4[];
  float* pos = reinterpret_cast<float*>(smem4);   // G * D
  float* neg = pos + G * D;                        // G * D
  float* keys = neg + G * D;                       // NB, in every CTA
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int sub = tid % kLanes;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head_row = (size_t)b * Hkv + h;
  const int per = (NB + C - 1) / C;
  const int n0 = rank * per;
  const int n1 = min(NB, n0 + per);
  constexpr int kPass = kSelThreads / kLanes;     // blocks per pass
  constexpr int kRows = kMean ? 1 : 2;            // metadata rows a block

  // this CTA has started: its shared memory may be written by the others
  // once every CTA has arrived (the wait comes after the first scores)
  cluster_arrive_relaxed();
  MetaRegs<kChunks> m;
  int n = n0 + tid / kLanes;
  load_meta<kChunks, kMean>(
      m, meta + (head_row * NB + (n < n1 ? n : 0)) * kRows * D, D, sub,
      n < n1);
  load_group<T, kMean>(q + ((size_t)b * Hkv * G + (size_t)h * G) * D, pos,
                       neg, G * D);
  // blocks holding a token once this step's token is appended
  const int n_valid = (cur_len[b] + 1 + bs - 1) / bs;
  __syncthreads();   // pos / neg in place

  float* dst = cluster.map_shared_rank(keys, sub < C ? sub : 0);
  bool waited = false;
  for (int base = n0; base < n1; base += kPass, n += kPass) {
    if (base != n0)
      load_meta<kChunks, kMean>(
          m, meta + (head_row * NB + (n < n1 ? n : 0)) * kRows * D, D, sub,
          n < n1);
    const float s = block_bound<kChunks, kMean, kSum>(m, pos, neg, D, G,
                                                      sub);
    if (!waited) {   // uniform across the CTA
      cluster_wait();
      waited = true;
    }
    // the masked, forced key of block n, into every CTA of the cluster
    // (lane sub of the group writes CTA sub's copy)
    if (n < n1 && sub < C) {
      float key = kMasked;
      if (n < n_valid)
        key = (n < sink || n >= n_valid - recent) ? INFINITY
                                                   : (s == 0.f ? 0.f : s);
      dst[n] = key;
    }
  }
  if (!waited) cluster_wait();
  cluster.sync();   // every CTA holds all NB keys

  const size_t out0 = head_row * K;
  if (NB <= kRankAllNB) {
    // the rank of each block of this CTA's slice among all NB; a block
    // ranked below K is selected, at its rank.  One warp per block,
    // lanes over the keys.
    for (int i = n0 + warp; i < n1; i += kSelThreads / 32) {
      const float ki = keys[i];
      unsigned before = 0;
      for (int j = lane; j < NB; j += 32) {
        const float kj = keys[j];
        before += (kj > ki || (kj == ki && j < i)) ? 1u : 0u;
      }
      before = __reduce_add_sync(0xffffffffu, before);
      if (lane == 0 && before < (unsigned)K) {
        const bool v = ki > kValidCut;
        idx[out0 + before] = v ? i : 0;
        sel_valid[out0 + before] = v;
      }
    }
    return;
  }

  // radix select of the K-th largest key over its order bits, 8 bits a
  // pass from the top: ``prefix`` holds the bits fixed so far and
  // ``krem`` the rank of the wanted key among the keys that share them
  __shared__ unsigned hist[256];
  __shared__ unsigned s_prefix, s_krem, s_sum[kSelThreads / 32];
  unsigned prefix = 0, krem = (unsigned)K;
  for (int shift = 24; shift >= 0; shift -= 8) {
    const unsigned fixed = shift == 24 ? 0u : ~0u << (shift + 8);
    hist[tid] = 0;   // kSelThreads == 256 bins
    __syncthreads();
    for (int j = tid; j < NB; j += kSelThreads) {
      const unsigned u = order_bits(keys[j]);
      if ((u & fixed) == prefix) atomicAdd(&hist[(u >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds digits 255 - 8 l down to 248 - 8 l; ``above`` counts
      // the keys of higher digits, over the lanes before it
      unsigned c[8], sum = 0;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        c[t] = hist[255 - 8 * lane - t];
        sum += c[t];
      }
      unsigned incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned x = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += x;
      }
      unsigned above = incl - sum;
      if (above < krem && krem <= incl) {   // exactly one lane
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          if (above + c[t] >= krem) {
            s_prefix = prefix | ((unsigned)(255 - 8 * lane - t) << shift);
            s_krem = krem - above;
            break;
          }
          above += c[t];
        }
      }
    }
    __syncthreads();
    prefix = s_prefix;
    krem = s_krem;
  }
  // the K-th key's bits are ``prefix``; K - krem keys lie above it, and
  // the krem lowest-id keys equal to it are selected
  const unsigned n_above = (unsigned)K - krem;

  // a block above the K-th key: its rank among all NB keys (one warp)
  for (int i = n0 + warp; i < n1; i += kSelThreads / 32) {
    const float ki = keys[i];
    if (order_bits(ki) <= prefix) continue;   // uniform across the warp
    unsigned before = 0;
    for (int j = lane; j < NB; j += 32) {
      const float kj = keys[j];
      before += (kj > ki || (kj == ki && j < i)) ? 1u : 0u;
    }
    before = __reduce_add_sync(0xffffffffu, before);
    if (lane == 0) {
      const bool v = ki > kValidCut;
      idx[out0 + before] = v ? i : 0;
      sel_valid[out0 + before] = v;
    }
  }
  // a block equal to it: rank n_above + the equal keys of lower id (those
  // before this slice, then a scan of the slice in chunks of 256)
  unsigned ties = 0;
  for (int j = tid; j < n0; j += kSelThreads)
    ties += order_bits(keys[j]) == prefix ? 1u : 0u;
  ties = __reduce_add_sync(0xffffffffu, ties);
  __syncthreads();   // s_sum is free
  if (lane == 0) s_sum[warp] = ties;
  __syncthreads();
  unsigned run = 0;
  for (int w = 0; w < kSelThreads / 32; ++w) run += s_sum[w];
  for (int base = n0; base < n1 && run < krem; base += kSelThreads) {
    const int i = base + tid;
    const bool tie = i < n1 && order_bits(keys[i]) == prefix;
    const unsigned mask = __ballot_sync(0xffffffffu, tie);
    __syncthreads();   // every thread has read s_sum
    if (lane == 0) s_sum[warp] = __popc(mask);
    __syncthreads();
    unsigned off = run;
    for (int w = 0; w < warp; ++w) off += s_sum[w];
    const unsigned r = off + __popc(mask & ((1u << lane) - 1u));
    if (tie && r < krem) {
      const float ki = keys[i];
      const bool v = ki > kValidCut;
      idx[out0 + n_above + r] = v ? i : 0;
      sel_valid[out0 + n_above + r] = v;
    }
    for (int w = 0; w < kSelThreads / 32; ++w) run += s_sum[w];
  }
}

// Opt ``kernel`` in to ``bytes`` of dynamic shared memory where that is
// above the default 48 KB (once per size reached; one card per process).
template <typename F>
cudaError_t smem_opt_in(F kernel, size_t bytes, size_t* done) {
  if (bytes <= (size_t)kDefaultSmem || bytes <= *done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *done = bytes;
  return e;
}

}  // namespace

// q bfloat16 (the serving path's dtype), meta float32, both contiguous,
// meta 16-byte aligned.  Limits checked by the wrapper: D <= 320, D % 4
// == 0, G * D * 8 bytes of shared memory within the card's opt-in limit.
// D <= 128 runs the narrow instance (its code as before); above, the
// wide one (block_score_wide_kernel, 10 chunks a lane), which the
// context-parallel decode's MLA scoring takes: its latent metadata is
// 288 wide, G = 40 absorbed query heads over one latent head, and the
// scores of a rank's block shard are gathered before the select, so the
// fused score_select cannot serve it.
extern "C" int launch_block_score(const void* q, const void* meta, void* out,
                                  int B, int Hkv, int NB, int D, int G,
                                  void* stream) {
  static size_t opted[2] = {};
  if (B == 0 || Hkv == 0 || NB == 0) return (int)cudaGetLastError();
  if (D > kLanes * 4 * kWideChunks) return (int)cudaErrorInvalidValue;
  const int wide = D <= kLanes * 4 * kNarrowChunks ? 0 : 1;
  auto kern = wide ? block_score_wide_kernel
                   : block_score_kernel<__nv_bfloat16, kNarrowChunks>;
  const size_t smem = sizeof(float) * 2 * (size_t)G * D;
  cudaError_t e = smem_opt_in(kern, smem, &opted[wide]);
  if (e != cudaSuccess) return (int)e;
  const int threads = wide ? kWideScoreThreads : kScoreThreads;
  const int per = wide ? kWideBlocks : kScoreThreads / kLanes;
  dim3 grid((NB + per - 1) / per, Hkv, B);
  kern<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(meta),
      static_cast<float*>(out), Hkv, NB, D, G);
  return (int)cudaGetLastError();
}

// score_select: q (B, Hkv * G, D) bfloat16, meta (B, Hkv, NB, 2, D)
// float32 (cuboid) or (B, Hkv, NB, D) float32 (``mean`` != 0), cur_len
// (B,) int32 tokens in the cache before this step -> idx (B, Hkv, K) int32
// and sel_valid (B, Hkv, K) bool, K = min(top_k, NB) (the wrapper passes
// K); ``sum`` != 0 sums over the GQA group in place of the max.  Limits
// checked by the wrapper: D <= 320, D % 4 == 0, NB >= 1, and 8 * G * D +
// 4 * NB bytes of shared memory within the card's opt-in limit
// (ops.select_max_nb).  D <= 128 runs the narrow instantiation.
extern "C" int launch_score_select(const void* q, const void* meta,
                                   const void* cur_len, void* idx,
                                   void* sel_valid, int B, int Hkv, int NB,
                                   int D, int G, int K, int bs, int sink,
                                   int recent, int mean, int sum,
                                   void* stream) {
  using Kern = void (*)(const __nv_bfloat16*, const float*, const int*,
                        int*, bool*, int, int, int, int, int, int, int,
                        int);
  // [wide][mean][sum], each with the shared memory it has opted in to
  static const Kern kernels[2][2][2] = {
      {{score_select_kernel<__nv_bfloat16, kNarrowChunks, false, false>,
        score_select_kernel<__nv_bfloat16, kNarrowChunks, false, true>},
       {score_select_kernel<__nv_bfloat16, kNarrowChunks, true, false>,
        score_select_kernel<__nv_bfloat16, kNarrowChunks, true, true>}},
      {{score_select_kernel<__nv_bfloat16, kWideChunks, false, false>,
        score_select_kernel<__nv_bfloat16, kWideChunks, false, true>},
       {score_select_kernel<__nv_bfloat16, kWideChunks, true, false>,
        score_select_kernel<__nv_bfloat16, kWideChunks, true, true>}}};
  static size_t opted[2][2][2] = {};
  if (B == 0 || Hkv == 0 || NB == 0) return (int)cudaGetLastError();
  if (D > kLanes * 4 * kWideChunks) return (int)cudaErrorInvalidValue;
  const int wide = D <= kLanes * 4 * kNarrowChunks ? 0 : 1;
  const int im = mean ? 1 : 0, is = sum ? 1 : 0;
  const Kern kern = kernels[wide][im][is];
  const size_t smem = sizeof(float) * (2 * (size_t)G * D + NB);
  cudaError_t e = smem_opt_in(kern, smem, &opted[wide][im][is]);
  if (e != cudaSuccess) return (int)e;
  const int C = std::min(kMaxCluster, (NB + 15) / 16);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, Hkv, B);
  cfg.blockDim = dim3(kSelThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, kern,
      static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(meta),
      static_cast<const int*>(cur_len), static_cast<int*>(idx),
      static_cast<bool*>(sel_valid), Hkv, NB, D, G, K, bs, sink, recent);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
