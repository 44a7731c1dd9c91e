// The backward of causal flash attention (flash_prefill.cu) for Hopper.
//
// Replaces no Pallas kernel: the reference trains through
// `flash_attention_jnp` (src/repro/models/attention.py:90, called by every
// dense layer's attention) and differentiates it with jax.value_and_grad
// (src/repro/training/trainer.py:35-45).  On the card the port's forward of
// that function is the flash_prefill kernel, which has no gradient; this
// file is its gradient, so that training runs through hand-written
// attention kernels both ways.
//
// For causal self-attention (Sq = Sk = S, q_offset 0), q, o, dO (B, S, Hq,
// D), k, v (B, S, Hkv, D) bf16, lse (B, Hq, S) float32 (the forward's
// per-row log-sum-exp, natural log, launch_flash_prefill's lse output),
// G = Hq / Hkv:
//   P  = exp(S * scale - lse)       S = Q K^T over the keys j <= i
//   dV = P^T dO                      Delta = rowsum(dO * O)
//   dS = P * (dO V^T - Delta)        dQ = scale dS K,  dK = scale dS^T Q
// with dK and dV summed over each GQA group; dq (B, S, Hq, D), dk and dv
// (B, S, Hkv, D) float32.  Three launches:
//   (a) delta: Delta (B, Hq, S) float32 into the wrapper's scratch, one
//       warp per (row, token, head);
//   (b) dkdv: one CTA per (64-key tile, kv head, batch row).  It keeps its
//       K and V tiles in shared memory and walks, for each of the group's
//       G query heads, the query tiles from the one holding its first key
//       to the end (the causal triangle), recomputing S^T = K Q^T and
//       dP^T = V dO^T per tile, and accumulates dV += P^T dO and
//       dK += dS^T Q in float32 registers.  Two warp groups take
//       alternate heads of the GQA group side by side, and the second adds
//       its sums into the first's at the end, through shared memory: the
//       group's sum stays inside the CTA, with no atomics;
//   (c) dq: one CTA per (64-query tile, query head, batch row), heavy tiles
//       (near the end of the sequence) first.  It keeps its Q and dO tiles
//       and walks the 64-key tiles up to its diagonal, recomputing S and dP
//       and accumulating dQ += dS K.
// Every output element is written by one thread, once: two launches give
// the same bits.
//
// What bounds it: operations.  Five products of 2 D flops per visible
// (query, key) pair and query head (S^T, dP^T, dV, dK in (b); S, dP, dQ in
// (c) recompute two of them: seven done, five needed) against 2 bytes per
// element read once; at qwen2-0.5b's 4,096 tokens that is thousands of
// flops per byte, far above the ~295 at which the tensor cores bind.
//
// Design (FlashAttention-2's backward in shape, simple first): four warps
// a CTA, each owning 16 rows of the CTA's tile; every product is
// mma.sync m16n8k16 (bf16 in, float32 accumulate), its operands read from
// shared memory with ldmatrix (x4: a whole A fragment, or the B fragments
// of two n-tiles, in one instruction; .trans for the operands a product
// reads transposed, dO and Q in (b), K in (c)), whose rows are padded by
// 8 elements so that the eight 16-byte rows of each 8 x 8 matrix hit all
// 32 banks.  P and dS are rounded to bf16 in registers, where a product's
// accumulator fragment becomes the next product's A fragment with no trip
// through shared memory (as the forward rounds P before P V).  The tiles a
// CTA walks are double-buffered: the next one is copied with cp.async
// (rows past S zero-filled) while this one's products run.  The grids are
// tile-major, so the CTAs with the most tiles to walk (the first key tiles
// of (b), the last query tiles of (c)) of every (head, row) start first;
// (b)'s heads split over two warp groups halve its longest CTA's walk
// (G / 2 x S / BR query tiles at its first key tile).  wgmma, TMA and a
// deeper ring of tiles are for a later PR.
#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;   // four warps, 16 tile rows each
constexpr int kGroups = 2;      // (b)'s warp groups, each its share of G
constexpr int kTile = 64;       // keys per tile of (b), queries per tile of (c)
constexpr float kLog2e = 1.4426950408889634f;

// the query tile of (b): 64 rows at D 64, 32 at D 128 (its S^T, dP^T, dK
// and dV fragments then fit in registers)
template <int D> struct Cfg {
  static_assert(D == 64 || D == 128, "head dims 64 and 128");
  static constexpr int kLd = D + 8;   // shared-memory row stride, elements
  static constexpr int kBr = D == 64 ? 64 : 32;
  // a group's two buffers of Q and dO, elements
  static constexpr int kGroupTiles = 4 * kBr * kLd;
  // K and V; per group two buffers of Q and dO and two of lse and Delta
  static constexpr int kSmemDkdv = 2 * kTile * kLd * 2 +
                                   kGroups * (kGroupTiles * 2 + 4 * kBr * 4);
  static_assert(kGroupTiles * 2 >= 4 * kThreads * D / 2,
                "a group's tiles hold its warps' dK or dV accumulators");
  // Q and dO, two buffers of K and V
  static constexpr int kSmemDq = 6 * kTile * kLd * 2;
};

// c += a b: A 16 x 16 (4 registers), B 16 x 8 (2), C 16 x 8 float32
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t packf(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 b16 matrices, lane i giving row i % 8 of matrix i / 8; each
// lane receives, of matrix j, row lane / 4, columns 2 (lane % 4) (+1) in
// r[j] (transposed: row 2 (lane % 4) (+1), column lane / 4)
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Fragments (g = lane >> 2, t = lane & 3), each one ldmatrix.x4.  A
// (16 x 16) of a row-major tile X: rows r0 + g, r0 + g + 8, columns
// k0 + 2t (+1), k0 + 8 + 2t (+1).
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* X, int ld,
                                       int r0, int k0, int lane) {
  ldsm_x4(a, X + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + k0 +
                 8 * (lane >> 4));
}

// A (16 x 16) from a product's float32 accumulators c[n][4] over 16
// columns: n-tiles 2 kk and 2 kk + 1, rounded to bf16
__device__ __forceinline__ void frag_a_acc(uint32_t* a, float (*c)[4],
                                           int kk) {
  a[0] = packf(c[2 * kk][0], c[2 * kk][1]);
  a[1] = packf(c[2 * kk][2], c[2 * kk][3]);
  a[2] = packf(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = packf(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// B (16 x 8) of n-tiles n0 (b[0], b[1]) and n0 + 8 (b[2], b[3]) with
// B[k][n] = Y[n][k], Y row-major by n: rows n0 + g (+8), columns k0 + 2t
// (+1) and k0 + 8 + 2t (+1)
__device__ __forceinline__ void frag_b2_nk(uint32_t* b, const bf16* Y, int ld,
                                           int n0, int k0, int lane) {
  ldsm_x4(b, Y + (n0 + (lane & 7) + 8 * (lane >> 4)) * ld + k0 +
                 8 * ((lane >> 3) & 1));
}

// the same with B[k][n] = Z[k][n], Z row-major by k (read transposed):
// rows k0 + 2t (+1) and k0 + 8 + 2t (+1), column n0 + g (+8)
__device__ __forceinline__ void frag_b2_kn(uint32_t* b, const bf16* Z, int ld,
                                           int k0, int n0, int lane) {
  ldsm_x4_t(b, Z + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + n0 +
                   8 * (lane >> 4));
}

// 16 bytes global -> shared without registers; src_bytes 0 zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows row0 .. row0 + rows - 1 of a (.., S, .., D) bf16 tensor whose row r
// starts at src + r * stride, into dst (row stride D + 8) with cp.async;
// rows past S zero (their source clamped to row 0, read for no bytes)
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t stride, int row0, int rows,
                                          int S, int tid, int nthreads) {
  constexpr int kChunks = D / 8;
  for (int i = tid; i < rows * kChunks; i += nthreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < S;
    cp_async16(dst + r * (D + 8) + c * 8,
               src + (in ? (size_t)(row0 + r) * stride : 0) + c * 8,
               in ? 16 : 0);
  }
}

// n floats from src + row0 (those past S zero) into dst with cp.async
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int n, int S, int tid,
                                          int nthreads) {
  for (int i = tid; i < n; i += nthreads) {
    const bool in = row0 + i < S;
    cp_async4(dst + i, src + (in ? row0 + i : 0), in ? 4 : 0);
  }
}

// (a) Delta[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d], a warp a row
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                       float* __restrict__ delta, int S, int H,
                       long long rows) {
  const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const bf16* po = o + r * D;
  const bf16* pd = dO + r * D;
  float acc = 0.f;
#pragma unroll
  for (int d = 2 * lane; d < D; d += 64) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(po + d));
    const float2 c =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pd + d));
    acc = fmaf(a.x, c.x, acc);
    acc = fmaf(a.y, c.y, acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = (int)(r % H);
    const long long bi = r / H;
    delta[(bi / S * H + h) * S + bi % S] = acc;
  }
}

// (b) dK and dV of one 64-key tile of one kv head, summed over its group
// of G query heads by kGroups warp groups of four warps: group c takes
// the heads c, c + kGroups, ..., walking each one's query tiles, and adds
// its dK and dV into group 0's at the end, in that order.  A group's
// (query head, query tile) steps are one sequence; the next step's Q, dO,
// lse and Delta are copied (cp.async) into the second of two buffers
// while this one's products run.
template <int D>
__global__ void __launch_bounds__(kGroups * kThreads)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dO,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int S, int Hq, int G,
                      float scale) {
  using C = Cfg<D>;
  constexpr int LD = C::kLd, BR = C::kBr;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // kTile x LD
  bf16* vs = ks + kTile * LD;
  const int grp = threadIdx.x / kThreads, tid = threadIdx.x % kThreads;
  bf16* qs = vs + kTile * LD + grp * C::kGroupTiles;   // 2 x BR x LD
  bf16* dos = qs + 2 * BR * LD;
  float* lse_s = reinterpret_cast<float*>(vs + kTile * LD +
                                          kGroups * C::kGroupTiles) +
                 grp * 4 * BR;                           // 2 x BR
  float* dl_s = lse_s + 2 * BR;

  // tile-major: every (kv head, row)'s first key tile, the heaviest, first
  const int k0 = blockIdx.z * kTile;
  const int hk = blockIdx.x, b = blockIdx.y, Hkv = gridDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t kv_row = (size_t)Hkv * D, q_row = (size_t)Hq * D;
  load_tile<D>(ks, k + ((size_t)b * S * Hkv + hk) * D, kv_row, k0, kTile, S,
               threadIdx.x, kGroups * kThreads);
  load_tile<D>(vs, v + ((size_t)b * S * Hkv + hk) * D, kv_row, k0, kTile, S,
               threadIdx.x, kGroups * kThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();   // K and V have landed for every thread

  const int jr0 = 16 * warp;            // this warp's rows of the key tile
  const int j_a = k0 + jr0 + g, j_b = j_a + 8;
  const float sl2 = scale * kLog2e;
  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;

  // the group's steps (query head hk G + grp + kGroups (it / per), query
  // tile qt0 + it % per); a named barrier per group, its trip count its own
  const int qt0 = k0 / BR, per = (S + BR - 1) / BR - qt0;
  const int heads = (G - grp + kGroups - 1) / kGroups;
  const int steps = heads * per;
  auto sync_group = [&]() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(kThreads)
                 : "memory");
  };
  auto issue = [&](int it) {   // step it's inputs into buffer it & 1
    const int h = hk * G + grp + kGroups * (it / per);
    const int q0 = (qt0 + it % per) * BR, buf = it & 1;
    load_tile<D>(qs + buf * BR * LD, q + ((size_t)b * S * Hq + h) * D,
                 q_row, q0, BR, S, tid, kThreads);
    load_tile<D>(dos + buf * BR * LD, dO + ((size_t)b * S * Hq + h) * D,
                 q_row, q0, BR, S, tid, kThreads);
    load_rows(lse_s + buf * BR, lse + ((size_t)b * Hq + h) * S, q0, BR, S,
              tid, kThreads);
    load_rows(dl_s + buf * BR, delta + ((size_t)b * Hq + h) * S, q0, BR, S,
              tid, kThreads);
    cp_async_commit();
  };
  if (steps > 0) issue(0);
  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) {
      issue(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    sync_group();   // step it's buffer has landed for the whole group
    const int q0 = (qt0 + it % per) * BR, buf = it & 1;
    const bf16* qb = qs + buf * BR * LD;
    const bf16* db = dos + buf * BR * LD;
    const float* lb = lse_s + buf * BR;
    const float* dlb = dl_s + buf * BR;
    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BR queries
    float st[BR / 8][4], dpt[BR / 8][4];
#pragma unroll
    for (int n = 0; n < BR / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      frag_a(ak, ks, LD, jr0, kk * 16, lane);
      frag_a(av, vs, LD, jr0, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < BR / 8; n += 2) {
        uint32_t bq[4], bd[4];
        frag_b2_nk(bq, qb, LD, n * 8, kk * 16, lane);
        frag_b2_nk(bd, db, LD, n * 8, kk * 16, lane);
        mma(st[n], ak, bq[0], bq[1]);
        mma(st[n + 1], ak, bq[2], bq[3]);
        mma(dpt[n], av, bd[0], bd[1]);
        mma(dpt[n + 1], av, bd[2], bd[3]);
      }
    }
    // P^T (keys j <= query i < S) and dS^T = P^T (dP^T - Delta), in place
#pragma unroll
    for (int n = 0; n < BR / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = n * 8 + 2 * t + (e & 1);
        const int i = q0 + il;
        const int j = e < 2 ? j_a : j_b;
        const float p = (i < S && j <= i)
                            ? exp2f(fmaf(st[n][e], sl2, -(lb[il] * kLog2e)))
                            : 0.f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - dlb[il]);
      }
    // dV += P^T dO and dK += dS^T Q, over the step's BR queries
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
      uint32_t ap[4], as[4];
      frag_a_acc(ap, st, kk);
      frag_a_acc(as, dpt, kk);
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bd[4], bq[4];
        frag_b2_kn(bd, db, LD, kk * 16, n * 8, lane);
        frag_b2_kn(bq, qb, LD, kk * 16, n * 8, lane);
        mma(acc_dv[n], ap, bd[0], bd[1]);
        mma(acc_dv[n + 1], ap, bd[2], bd[3]);
        mma(acc_dk[n], as, bq[0], bq[1]);
        mma(acc_dk[n + 1], as, bq[2], bq[3]);
      }
    }
    sync_group();   // step it's buffer is read: step it + 2 may land
  }
  // group src > 0 adds its dK, then its dV, into group 0's through its
  // own tile buffers, each thread's accumulators lane by lane
  __syncthreads();   // every group is done with its buffers
  auto fold = [&](float (&acc)[D / 8][4], int src) {
    float* slot = reinterpret_cast<float*>(vs + kTile * LD +
                                           src * C::kGroupTiles) +
                  warp * (D / 2) * 32 + lane;
    if (grp == src) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) slot[(4 * n + e) * 32] = acc[n][e];
    }
    __syncthreads();
    if (grp == 0) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += slot[(4 * n + e) * 32];
    }
    __syncthreads();
  };
#pragma unroll
  for (int src = 1; src < kGroups; ++src) {
    fold(acc_dk, src);
    fold(acc_dv, src);
  }
  if (grp != 0) return;
  float* dkb = dk + ((size_t)b * S * Hkv + hk) * D;
  float* dvb = dv + ((size_t)b * S * Hkv + hk) * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + 2 * t;
    if (j_a < S) {
      *reinterpret_cast<float2*>(dkb + j_a * kv_row + d) =
          make_float2(acc_dk[n][0] * scale, acc_dk[n][1] * scale);
      *reinterpret_cast<float2*>(dvb + j_a * kv_row + d) =
          make_float2(acc_dv[n][0], acc_dv[n][1]);
    }
    if (j_b < S) {
      *reinterpret_cast<float2*>(dkb + j_b * kv_row + d) =
          make_float2(acc_dk[n][2] * scale, acc_dk[n][3] * scale);
      *reinterpret_cast<float2*>(dvb + j_b * kv_row + d) =
          make_float2(acc_dv[n][2], acc_dv[n][3]);
    }
  }
}

// (c) dQ of one 64-query tile of one query head; the next key tile's K
// and V are copied (cp.async) into the second of two buffers while this
// one's products run
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int S, int Hq, int G, float scale) {
  constexpr int LD = Cfg<D>::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // kTile x LD
  bf16* dos = qs + kTile * LD;
  bf16* ks = dos + kTile * LD;                      // 2 buffers each
  bf16* vs = ks + 2 * kTile * LD;

  // tile-major, heavy tiles (near the end of the sequence) first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;
  const int h = blockIdx.x, b = blockIdx.y;
  const int Hkv = Hq / G, hk = h / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t kv_row = (size_t)Hkv * D, q_row = (size_t)Hq * D;
  load_tile<D>(qs, q + ((size_t)b * S * Hq + h) * D, q_row, q0, kTile, S,
               threadIdx.x, kThreads);
  load_tile<D>(dos, dO + ((size_t)b * S * Hq + h) * D, q_row, q0, kTile, S,
               threadIdx.x, kThreads);

  const int ir0 = 16 * warp;            // this warp's rows of the query tile
  const int i_a = q0 + ir0 + g, i_b = i_a + 8;
  const float* lse_h = lse + ((size_t)b * Hq + h) * S;
  const float* dl_h = delta + ((size_t)b * Hq + h) * S;
  const float l2_a = i_a < S ? lse_h[i_a] * kLog2e : 0.f;
  const float l2_b = i_b < S ? lse_h[i_b] * kLog2e : 0.f;
  const float dl_a = i_a < S ? dl_h[i_a] : 0.f;
  const float dl_b = i_b < S ? dl_h[i_b] : 0.f;
  const float sl2 = scale * kLog2e;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const bf16* kh = k + ((size_t)b * S * Hkv + hk) * D;
  const bf16* vh = v + ((size_t)b * S * Hkv + hk) * D;
  const int n_kt = (min(q0 + kTile, S) - 1) / kTile + 1;   // to the diagonal
  auto issue = [&](int kt) {   // key tile kt into buffer kt & 1
    const int buf = kt & 1;
    load_tile<D>(ks + buf * kTile * LD, kh, kv_row, kt * kTile, kTile, S,
                 threadIdx.x, kThreads);
    load_tile<D>(vs + buf * kTile * LD, vh, kv_row, kt * kTile, kTile, S,
                 threadIdx.x, kThreads);
    cp_async_commit();
  };
  issue(0);   // with Q and dO
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      issue(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // key tile kt has landed for every thread
    const int k0 = kt * kTile, buf = kt & 1;
    const bf16* kb = ks + buf * kTile * LD;
    const bf16* vb = vs + buf * kTile * LD;
    // S = Q K^T and dP = dO V^T: this warp's 16 queries x 64 keys
    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ad[4];
      frag_a(aq, qs, LD, ir0, kk * 16, lane);
      frag_a(ad, dos, LD, ir0, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < kTile / 8; n += 2) {
        uint32_t bk[4], bv[4];
        frag_b2_nk(bk, kb, LD, n * 8, kk * 16, lane);
        frag_b2_nk(bv, vb, LD, n * 8, kk * 16, lane);
        mma(s[n], aq, bk[0], bk[1]);
        mma(s[n + 1], aq, bk[2], bk[3]);
        mma(dp[n], ad, bv[0], bv[1]);
        mma(dp[n + 1], ad, bv[2], bv[3]);
      }
    }
    // dS = P (dP - Delta), P over the keys j <= i < S, into s
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + n * 8 + 2 * t + (e & 1);
        const bool lo = e < 2;
        const int i = lo ? i_a : i_b;
        const float p = (i < S && j <= i)
                            ? exp2f(fmaf(s[n][e], sl2, lo ? -l2_a : -l2_b))
                            : 0.f;
        s[n][e] = p * (dp[n][e] - (lo ? dl_a : dl_b));
      }
    // dQ += dS K, over the tile's 64 keys
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      frag_a_acc(a, s, kk);
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bk[4];
        frag_b2_kn(bk, kb, LD, kk * 16, n * 8, lane);
        mma(acc[n], a, bk[0], bk[1]);
        mma(acc[n + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();   // key tile kt is read: tile kt + 2 may land
  }
  float* dqb = dq + ((size_t)b * S * Hq + h) * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + 2 * t;
    if (i_a < S)
      *reinterpret_cast<float2*>(dqb + i_a * q_row + d) =
          make_float2(acc[n][0] * scale, acc[n][1] * scale);
    if (i_b < S)
      *reinterpret_cast<float2*>(dqb + i_b * q_row + d) =
          make_float2(acc[n][2] * scale, acc[n][3] * scale);
  }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dO, const float* lse, float* delta, float* dq,
           float* dk, float* dv, int B, int S, int Hq, int Hkv, float scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  const int G = Hq / Hkv;
  const long long rows = (long long)B * S * Hq;
  flash_bwd_delta_kernel<D><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      o, dO, delta, S, Hq, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int tiles = (S + kTile - 1) / kTile;
  auto dkdv = flash_bwd_dkdv_kernel<D>;
  e = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::kSmemDkdv);
  if (e != cudaSuccess) return (int)e;
  dkdv<<<dim3(Hkv, B, tiles), kGroups * kThreads, C::kSmemDkdv, stream>>>(
      q, k, v, dO, lse, delta, dk, dv, S, Hq, G, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto dqk = flash_bwd_dq_kernel<D>;
  e = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::kSmemDq);
  if (e != cudaSuccess) return (int)e;
  dqk<<<dim3(Hq, B, tiles), kThreads, C::kSmemDq, stream>>>(
      q, k, v, dO, lse, delta, dq, S, Hq, G, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Causal self-attention's gradient: bf16 q, k, v, o, dO, float32 lse
// (B, Hq, S); delta a float32 (B, Hq, S) scratch; float32 dq, dk, dv
// written whole.  D in {64, 128}.  Limits checked by the wrapper:
// contiguous tensors, 16-byte aligned, Hq % Hkv == 0.  Returns a runtime
// error code.
extern "C" int launch_flash_prefill_bwd(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dO, const void* lse,
                                        void* delta, void* dq, void* dk,
                                        void* dv, int B, int S, int Hq,
                                        int Hkv, int D, float scale,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0 || Hq == 0) return (int)cudaGetLastError();
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  const bf16* O = static_cast<const bf16*>(o);
  const bf16* DO = static_cast<const bf16*>(dO);
  const float* L = static_cast<const float*>(lse);
  float* Dl = static_cast<float*>(delta);
  float* DQ = static_cast<float*>(dq);
  float* DK = static_cast<float*>(dk);
  float* DV = static_cast<float*>(dv);
  if (D == 64)
    return launch<64>(Q, K, V, O, DO, L, Dl, DQ, DK, DV, B, S, Hq, Hkv,
                      scale, s);
  if (D == 128)
    return launch<128>(Q, K, V, O, DO, L, Dl, DQ, DK, DV, B, S, Hq, Hkv,
                       scale, s);
  return (int)cudaErrorInvalidValue;
}
