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
// Over whole sequences (q_offset 0), q (B, Sq, Hq, D), o, dO (B, Sq, Hq,
// Dv), k (B, Sk, Hkv, D), v (B, Sk, Hkv, Dv) bf16, lse (B, Hq, Sq) float32
// (the forward's per-row log-sum-exp, natural log, launch_flash_prefill's
// lse output), G = Hq / Hkv:
//   P  = exp(S * scale - lse)       S = Q K^T over the keys a query sees
//   dV = P^T dO                      Delta = rowsum(dO * O)
//   dS = P * (dO V^T - Delta)        dQ = scale dS K,  dK = scale dS^T Q
// with dK and dV summed over each GQA group; dq (B, Sq, Hq, D), dk (B, Sk,
// Hkv, D) and dv (B, Sk, Hkv, Dv) float32.  Causal: query i sees the keys
// j <= i (self-attention, Sq = Sk); non-causal: every key j < Sk
// (Whisper's encoder, Sq = Sk = 1500, and its cross-attention, Sq the
// decoder's tokens, Sk = 1500).
//
// Instances: causal at (D, Dv) = (64, 64), (128, 128), MLA's (96, 64)
// (qk_nope 64 + qk_rope 32 against v_head_dim 64) and kimi-k2's (112,
// 112) (d_model 7168 over 64 heads); non-causal at Whisper's (64, 64).
// At (112, 112) q, k, v and dO all load as two 64-column TMA boxes,
// columns 112-127 zero-filled: S = Q K^T and dP = dO V^T (and their
// transposes) run D / 16 = 7 k-steps, dQ's, dK's and dV's products run
// at width 128 (their last 16 columns zero), and the epilogues store the
// first 112; Delta's rows take 16 lanes of 8 columns, the last two
// adding nothing.  MLA's q and k load as two 64-column TMA boxes,
// columns 96-127 of the second zero-filled (they lie past the tensor), as
// the forward loads them: S^T = K Q^T and S = Q K^T run D / 16 = 6
// k-steps, so the zero columns are never read; dP = dO V^T and dV's
// product run at Dv 64; dQ's and dK's products run at the padded width
// 128 (their last 32 columns are zero, products of the zero-filled K and
// Q columns) and the epilogues store the first 96.  MLA's G = 1 (40
// query heads over 40 key heads), so no chunk sum is launched.  In the
// non-causal mode every (query tile, key tile) pair is visible: dK-dV
// walks every query tile and dQ every key tile, so every CTA of a launch
// walks as far and the heaviest-first order has nothing to balance.  Keys
// past Sk get weight 0 (a score set to -inf before its exponential) in
// the ragged last key tile (1500 = 11 x 128 + 92) and queries past Sq in
// the ragged last query tile (448 = 3 x 128 + 64): TMA zero-fills their
// rows, but their lse in the padded workspace is 0 and the exponential
// of a score against it would not be 0.
//
// What bounds it: operations.  Five products of 2 D flops per visible
// (query, key) pair and query head against 2 bytes per element read once:
// at qwen2-0.5b's 4,096 tokens that is thousands of flops per byte, far
// above the ~295 at which the H100's tensor cores bind, and only wgmma
// reaches their rate.  This design does seven (the dQ kernel recomputes S
// and dP), so its own floor is 7/5 of the bound, and one exponential per
// pair and head in each of (b) and (c) runs on the SFU beside them.  What
// binds on the H100 is the product pipeline itself: built with
// -DFLASH_BWD_PRODUCTS_ONLY (no masking, exponentials or dS, so the
// results are wrong; ab_kernels.py --probes builds and times it) the
// kernels still take well over that floor, since every step waits for
// each of its products before the next can start; the elementwise work
// adds the rest.  The card's 700 W limit lowers the SM clock by a few per
// cent under this load (PERF.md has the readings).
//
// Design (FlashAttention-3's backward in shape, with dQ's products apart,
// so that no float32 atomic is needed).  Four launches, one count in the
// wrapper:
//   (a) delta: Delta = rowsum(dO * O) and lse * log2(e), both (B, Hq,
//       S_pad) float32 in the wrapper's workspace, S_pad = Sq rounded up
//       to 128 with zeros past Sq, so that a tile of either is one bulk
//       copy;
//   (b) dkdv: one CTA per (128-key tile, query head of the GQA group, kv
//       head, batch row) of three warpgroups.  Warpgroup 0 is the producer:
//       after setmaxnreg gives its registers away, one thread loads the K
//       and V tiles once (TMA, 128-byte swizzle) and then keeps a ring of 4
//       stages filled, each the Q tile, the dO tile, lse and Delta of Bq
//       queries of one head (Bq 128 at D 64, 64 at D 96 and 128, so
//       that S^T, dP^T, dK and dV fit in registers), guarded by full /
//       empty mbarriers.  Warpgroups 1 and 2 each own 64 keys.  A step: S^T =
//       K Q^T and dP^T = V dO^T (wgmma, both operands in shared memory, in
//       two commit groups); P^T from S^T in registers, rounded to bf16 (as
//       the forward rounds P), is at once the register A operand of dV +=
//       P^T dO (dO read transposed, imm-trans-b, as the forward reads V),
//       which runs while dS^T = P^T (dP^T - Delta) is formed from that
//       bf16 P^T and the landed dP^T; then dK += dS^T Q.  The walk is the
//       head's query tiles from the key tile's diagonal (causal; the first
//       tile when not) to Sq; only tiles that cross the diagonal, Sq or
//       Sk are masked (a score set to -inf before its exponential), and
//       TMA zero-fills rows past Sq and Sk;
//   (c) dq: one CTA per (128-query tile, query head, batch row), heavy
//       tiles first, the forward's shape: the Q and dO tiles load once, a
//       ring of K/V tiles of 128 keys follows, each consumer warpgroup owns
//       64 query rows: S = Q K^T and dP = dO V^T (shared-memory wgmma),
//       dS in registers as the A operand of dQ += dS K with K read
//       transposed;
//   (d) reduce, where G > 1: the chunks' partial dK and dV
//       summed in chunk order.
//
// Balance.  All CTAs of (b) with the same key tile walk the same number
// of steps, and the first key tile walks the most (the whole causal
// column).  A kv head's G query heads are split into G chunks of one head,
// each a CTA of its own, so the longest CTA walks one head's column, and
// the grid runs key tiles first to last: the heaviest CTAs start first
// and the rest fill in behind them, as in longest-job-first scheduling.
// Chunk 0 writes its dK and dV into dk and dv; chunk c > 0 into its own
// float32 slice of the workspace; (d) adds the slices into dk and dv in
// chunk order.  Every output element is written by one thread, and every
// sum runs in a fixed order: no atomics, and two launches give the same
// bits.
//
// Measured slower on the H100 and left out (PERF.md): the two consumers
// taking turns at the tensor cores (FA3's ping-pong); dS staged in shared
// memory for dQ's product; dQ's product of one tile overlapped with the
// next tile's dS; the chunks' sum done by the last chunk's CTA, or by the
// dQ kernel's idle producer warps; and dQ accumulated inside (b) in a
// fixed order under a per-tile semaphore (FA3's deterministic variant:
// five products, but its accumulators spill).
#include "common.cuh"
#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 384;   // a producer warpgroup and two consumers
constexpr int kBk = 128;        // keys per K/V tile (64 per consumer in dkdv)
constexpr int kBqDq = 128;      // query rows per dq CTA (64 per consumer)
constexpr int kRowPad = 128;    // lse2 and Delta rows padded to a multiple
constexpr float kLog2e = 1.4426950408889634f;

template <int D, int Dv> struct Cfg {
  static_assert((D == 64 && Dv == 64) || (D == 128 && Dv == 128) ||
                    (D == 96 && Dv == 64) || (D == 112 && Dv == 112),
                "(D, Dv) in (64, 64), (128, 128), MLA's (96, 64) and "
                "kimi-k2's (112, 112)");
  // 64-column slabs of 128 bytes: q and k, v and dO (a part slab
  // zero-filled past D or Dv)
  static constexpr int kSlabsQK = (D + 63) / 64;
  static constexpr int kSlabsV = (Dv + 63) / 64;
  static constexpr int kDPad = kSlabsQK * 64;   // dQ's and dK's width
  static constexpr int kDvPad = kSlabsV * 64;   // dV's width
  // dkdv's query tile: its S^T and dP^T (64 x kBq) and dK and dV (64 x
  // kDPad, 64 x Dv) stay in a consumer's registers
  static constexpr int kBq = D == 64 ? 128 : 64;
  static constexpr int kQSlab = kBq * 128;   // one slab of a Q / dO tile
  static constexpr int kQTile = kSlabsQK * kQSlab;
  static constexpr int kDoTile = kSlabsV * kQSlab;
  static constexpr int kKSlab = kBk * 128;   // one slab of a K / V tile
  static constexpr int kKTile = kSlabsQK * kKSlab;
  static constexpr int kVTile = kSlabsV * kKSlab;
  static constexpr int kStages = 4;
  static constexpr int kStageBytes = kQTile + kDoTile;   // Q, then dO
  static constexpr int kRowBytes = 2 * kBq * 4;    // lse2, then Delta
  static constexpr int kSmemDkdv =
      1024 + kKTile + kVTile + kStages * (kStageBytes + kRowBytes);
  // dq: Q and dO tiles of 128 rows once, a ring of K / V tiles
  static constexpr int kDqSlab = kBqDq * 128;
  static constexpr int kDqQTile = kSlabsQK * kDqSlab;
  static constexpr int kDqDoTile = kSlabsV * kDqSlab;
  static constexpr int kDqStages = D == 64 ? 4 : D == 96 ? 3 : 2;
  static constexpr int kSmemDq = 1024 + kDqQTile + kDqDoTile +
                                 kDqStages * (kKTile + kVTile);
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> bf16x2, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16x2 -> two floats, the low half first
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// acc (64 x N) = A B^T over D: A 64 rows of a K-major tile at a (64-column
// slabs ASlab bytes apart), B N rows of one at b (BSlab apart)
template <int D, int N, int ASlab, int BSlab>
__device__ __forceinline__ void mma_ss(float* acc, const unsigned char* a,
                                         const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int sl = kk / 4, off = (kk % 4) * 32;
    const uint64_t da = sw128_desc(a + sl * ASlab + off, 16, 1024);
    const uint64_t db = sw128_desc(b + sl * BSlab + off, 16, 1024);
    if constexpr (N == 128)
      wgmma_m64n128k16_ss(acc, da, db, kk > 0);
    else
      wgmma_m64n64k16_ss(acc, da, db, kk > 0);
  }
}

// acc (64 x D) += A B over K: A in registers (k-step kk in a[kk]), B the K
// rows x D tile at b read transposed, 16 rows (2048 bytes) a k-step,
// 64-column slabs BSlab bytes apart
template <int D, int K, int BSlab>
__device__ __forceinline__ void mma_rs(float* acc, uint32_t (*a)[4],
                                         const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t desc = sw128_desc(b + kk * 16 * 128, BSlab, 1024);
    if constexpr (D == 64)
      wgmma_m64n64k16_rs_tb(acc, a[kk], desc, 1);
    else
      wgmma_m64n128k16_rs_tb(acc, a[kk], desc, 1);
  }
}

// an accumulator fragment over N columns rounded to bf16 as the A
// fragments of a product over those columns: columns 16 kk .. 16 kk + 15
// are n-tiles 2 kk and 2 kk + 1, rows r (e 0, 1) and r + 8 (e 2, 3)
template <int N>
__device__ __forceinline__ void pack(const float* s, uint32_t (*p)[4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// lanes a row of the delta kernel: Dv / 8 rounded up to a power of two
__host__ __device__ constexpr int delta_lanes(int Dv) {
  int p = 1;
  while (p < Dv / 8) p *= 2;
  return p;
}

// (a) row r = (b H + h) S_pad + i of the workspace: Delta = sum_d dO O and
// lse2 = lse log2(e) of token i, zeros past S; delta_lanes(Dv) lanes a
// row, each reading 16 bytes of o and of dO (a lane past Dv none)
template <int Dv>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                       const float* __restrict__ lse, float* __restrict__ lse2,
                       float* __restrict__ delta, int S, int S_pad, int H,
                       long long rows) {
  constexpr int kLanes = delta_lanes(Dv), kRows = 256 / kLanes;
  const int sub = threadIdx.x % kLanes;
  const long long r = (long long)blockIdx.x * kRows + threadIdx.x / kLanes;
  const int i = (int)(r % S_pad);
  const long long bh = r / S_pad;
  float acc = 0.f;
  if (r < rows && i < S && sub * 8 < Dv) {
    const size_t off = ((size_t)(bh / H * S + i) * H + bh % H) * Dv + sub * 8;
    float a[8], c[8];
    load16_f32(o + off, a);
    load16_f32(dO + off, c);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc = fmaf(a[e], c[e], acc);
  }
#pragma unroll
  for (int m = kLanes / 2; m > 0; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (r < rows && sub == 0) {
    delta[r] = acc;
    lse2[r] = i < S ? lse[bh * S + i] * kLog2e : 0.f;
  }
}

// (b) one query head's share (its chunk) of dK and dV of one 128-key tile
// of its kv head
template <int D, int Dv, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap do_map,
                      const float* __restrict__ lse2,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, float* __restrict__ part,
                      int B, int Sq, int Sk, int S_pad, int Hq, int Hkv,
                      float sl2, float scale) {
  using C = Cfg<D, Dv>;
  constexpr int NS = C::kStages, BQ = C::kBq, DP = C::kDPad;
  constexpr int DVP = C::kDvPad;
  __shared__ __align__(8) uint64_t kv_full, full[NS], empty[NS];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* k_s = smem;
  unsigned char* v_s = k_s + C::kKTile;
  unsigned char* st_s = v_s + C::kVTile;   // stage st: Q, then dO
  float* row_s = reinterpret_cast<float*>(st_s + NS * C::kStageBytes);

  // key tiles first to last (the heaviest first), then the query head's
  // place in its group (its chunk), kv head, row
  const int per_tile = Hq * B;
  const int kt = blockIdx.x / per_tile;
  int rem = blockIdx.x % per_tile;
  const int ch = rem / (Hkv * B);
  rem %= Hkv * B;
  const int hk = rem / B, b = rem % B;
  const int h = hk * (Hq / Hkv) + ch;
  const int k0 = kt * kBk;
  // causal: the query tiles from the key tile's diagonal; else all
  const int qt0 = kCausal ? k0 / BQ : 0, nq = (Sq + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    mbar_init(&kv_full, 1);
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 256);   // every consumer thread arrives
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread loads K and V, then keeps the ring filled
    setmaxnreg_dec<24>();
    if (threadIdx.x != 0) return;
    // whole boxes count, the zero-filled rows and columns included
    mbar_arrive_expect_tx(&kv_full, C::kKTile + C::kVTile);
    for (int sl = 0; sl < C::kSlabsQK; ++sl)
      tma_load_4d(k_s + sl * C::kKSlab, &k_map, &kv_full, sl * 64, hk, k0,
                  b);
    for (int sl = 0; sl < C::kSlabsV; ++sl)
      tma_load_4d(v_s + sl * C::kKSlab, &v_map, &kv_full, sl * 64, hk, k0,
                  b);
    const float* l_src = lse2 + ((size_t)b * Hq + h) * S_pad;
    const float* d_src = delta + ((size_t)b * Hq + h) * S_pad;
    for (int j = 0; j < nq - qt0; ++j) {
      const int st = j % NS, qt = qt0 + j;
      if (j >= NS) mbar_wait(&empty[st], ((j / NS) - 1) & 1);
      mbar_arrive_expect_tx(&full[st], C::kStageBytes + C::kRowBytes);
      unsigned char* qs = st_s + st * C::kStageBytes;
      for (int sl = 0; sl < C::kSlabsQK; ++sl)
        tma_load_4d(qs + sl * C::kQSlab, &q_map, &full[st], sl * 64, h,
                    qt * BQ, b);
      for (int sl = 0; sl < C::kSlabsV; ++sl)
        tma_load_4d(qs + C::kQTile + sl * C::kQSlab, &do_map, &full[st],
                    sl * 64, h, qt * BQ, b);
      float* rs = row_s + st * 2 * BQ;
      bulk_load(rs, l_src + qt * BQ, BQ * 4, &full[st]);
      bulk_load(rs + BQ, d_src + qt * BQ, BQ * 4, &full[st]);
    }
    return;
  }

  // consumers: warpgroup c owns keys k0 + 64 c .. + 63
  setmaxnreg_inc<240>();
  const int c = wg - 1;
  const int t128 = threadIdx.x - 128 * wg;
  const int warp = t128 >> 5, lane = t128 & 31, quad = lane & 3;
  const int kc0 = k0 + 64 * c;
  const int j_a = kc0 + warp * 16 + (lane >> 2), j_b = j_a + 8;
  const unsigned char* kc = k_s + c * 64 * 128;   // this warpgroup's keys
  const unsigned char* vc = v_s + c * 64 * 128;

  float acc_dk[DP / 2], acc_dv[DVP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc_dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) acc_dv[i] = 0.f;

  mbar_wait(&kv_full, 0);
  // every step, a tile wholly above this warpgroup's keys masked whole
  for (int j = 0; j < nq - qt0; ++j) {
    const int st = j % NS;
    const int q0 = (qt0 + j) * BQ;
    const unsigned char* qs = st_s + st * C::kStageBytes;
    const unsigned char* dos = qs + C::kQTile;
    const float* ls = row_s + st * 2 * BQ;
    const float* dls = ls + BQ;
    const bool masked = kCausal ? q0 < kc0 + 63 || q0 + BQ > Sq
                                : q0 + BQ > Sq || kc0 + 64 > Sk;
    float s[BQ / 2], dp[BQ / 2];
    uint32_t pp[BQ / 16][4], ds[BQ / 16][4];
    mbar_wait(&full[st], (j / NS) & 1);
    fence_regs<BQ / 2>(s);
    fence_regs<BQ / 2>(dp);
    wgmma_fence();
    mma_ss<D, BQ, C::kKSlab, C::kQSlab>(s, kc, qs);     // S^T = K Q^T
    wgmma_commit();
    mma_ss<Dv, BQ, C::kKSlab, C::kQSlab>(dp, vc, dos);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<1>();   // S^T has landed; dP^T runs on
    fence_regs<BQ / 2>(s);
    // P^T over the keys a query i < Sq sees (causal: j <= i; else j <
    // Sk; a masked score's weight is ex2(-inf) = 0), rounded to bf16
#ifndef FLASH_BWD_PRODUCTS_ONLY
    if (masked) {
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = q0 + n * 8 + 2 * quad + (e & 1);
          const int jj = e < 2 ? j_a : j_b;
          if (kCausal ? i < jj || i >= Sq : i >= Sq || jj >= Sk)
            s[4 * n + e] = -INFINITY;
        }
    }
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      const float2 l2 =
          *reinterpret_cast<const float2*>(ls + n * 8 + 2 * quad);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * n + e] =
            ex2(fmaf(s[4 * n + e], sl2, (e & 1) ? -l2.y : -l2.x));
    }
#endif
    pack<BQ>(s, pp);
    // dV += P^T dO runs while dS^T is formed
    fence_regs<DVP / 2>(acc_dv);
    fence_regs<BQ / 4>(&pp[0][0]);
    wgmma_fence();
    mma_rs<DVP, BQ, C::kQSlab>(acc_dv, pp, dos);
    wgmma_commit();
    wgmma_wait<1>();   // dP^T has landed
    fence_regs<BQ / 2>(dp);
    // dS^T = P^T (dP^T - Delta), from the bf16 P^T of dV's product
#ifndef FLASH_BWD_PRODUCTS_ONLY
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      const float2 dl =
          *reinterpret_cast<const float2*>(dls + n * 8 + 2 * quad);
      const float2 p0 = unpack_bf16(pp[n / 2][(n & 1) * 2]);
      const float2 p1 = unpack_bf16(pp[n / 2][(n & 1) * 2 + 1]);
      dp[4 * n] = p0.x * (dp[4 * n] - dl.x);
      dp[4 * n + 1] = p0.y * (dp[4 * n + 1] - dl.y);
      dp[4 * n + 2] = p1.x * (dp[4 * n + 2] - dl.x);
      dp[4 * n + 3] = p1.y * (dp[4 * n + 3] - dl.y);
    }
#endif
    pack<BQ>(dp, ds);
    fence_regs<DP / 2>(acc_dk);
    fence_regs<BQ / 4>(&ds[0][0]);
    wgmma_fence();
    mma_rs<DP, BQ, C::kQSlab>(acc_dk, ds, qs);    // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DVP / 2>(acc_dv);
    fence_regs<DP / 2>(acc_dk);
    fence_regs<BQ / 4>(&pp[0][0]);
    fence_regs<BQ / 4>(&ds[0][0]);
    mbar_arrive(&empty[st]);   // this stage is read
  }

  // chunk 0 into dk and dv, chunk c > 0 into its slice of the workspace;
  // the first D columns of dK (past them its padded product's are zero)
  const size_t n_k = (size_t)B * Sk * Hkv * D;
  const size_t n_v = (size_t)B * Sk * Hkv * Dv;
  const size_t rk = (size_t)Hkv * D, rv = (size_t)Hkv * Dv;
  const size_t base = (size_t)b * Sk * Hkv + hk;
  float* dkb = dk + base * D;
  float* dvb = dv + base * Dv;
  if (ch > 0) {
    float* slice = part + (size_t)(ch - 1) * (n_k + n_v);
    dkb = slice + base * D;
    dvb = slice + n_k + base * Dv;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + 2 * quad;
    if (j_a < Sk)
      *reinterpret_cast<float2*>(dkb + j_a * rk + d) =
          make_float2(acc_dk[4 * n] * scale, acc_dk[4 * n + 1] * scale);
    if (j_b < Sk)
      *reinterpret_cast<float2*>(dkb + j_b * rk + d) =
          make_float2(acc_dk[4 * n + 2] * scale, acc_dk[4 * n + 3] * scale);
  }
#pragma unroll
  for (int n = 0; n < Dv / 8; ++n) {
    const int d = n * 8 + 2 * quad;
    if (j_a < Sk)
      *reinterpret_cast<float2*>(dvb + j_a * rv + d) =
          make_float2(acc_dv[4 * n], acc_dv[4 * n + 1]);
    if (j_b < Sk)
      *reinterpret_cast<float2*>(dvb + j_b * rv + d) =
          make_float2(acc_dv[4 * n + 2], acc_dv[4 * n + 3]);
  }
}

// (c) dQ of one 128-query tile of one query head
template <int D, int Dv, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const float* __restrict__ lse2,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Sq, int Sk, int S_pad, int Hq, int G, float sl2,
                    float scale) {
  using C = Cfg<D, Dv>;
  constexpr int NS = C::kDqStages, DP = C::kDPad;
  constexpr int kStage = C::kKTile + C::kVTile;   // K, then V
  __shared__ __align__(8) uint64_t qd_full, full[NS], empty[NS];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = smem;
  unsigned char* do_s = q_s + C::kDqQTile;
  unsigned char* kv_s = do_s + C::kDqDoTile;

  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy tiles first
  const int hq = blockIdx.y, b = blockIdx.z, hk = hq / G;
  const int q0 = qt * kBqDq;
  // causal: key tiles up to the diagonal of the tile's last real query;
  // else every key tile
  const int n_tiles = kCausal ? (min(q0 + kBqDq, Sq) - 1) / kBk + 1
                              : (Sk + kBk - 1) / kBk;

  if (threadIdx.x == 0) {
    mbar_init(&qd_full, 1);
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<24>();
    if (threadIdx.x != 0) return;
    mbar_arrive_expect_tx(&qd_full, C::kDqQTile + C::kDqDoTile);
    for (int sl = 0; sl < C::kSlabsQK; ++sl)
      tma_load_4d(q_s + sl * C::kDqSlab, &q_map, &qd_full, sl * 64, hq, q0,
                  b);
    for (int sl = 0; sl < C::kSlabsV; ++sl)
      tma_load_4d(do_s + sl * C::kDqSlab, &do_map, &qd_full, sl * 64, hq,
                  q0, b);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % NS;
      if (j >= NS) mbar_wait(&empty[st], ((j / NS) - 1) & 1);
      mbar_arrive_expect_tx(&full[st], kStage);
      unsigned char* ks = kv_s + st * kStage;
      for (int sl = 0; sl < C::kSlabsQK; ++sl)
        tma_load_4d(ks + sl * C::kKSlab, &k_map, &full[st], sl * 64, hk,
                    j * kBk, b);
      for (int sl = 0; sl < C::kSlabsV; ++sl)
        tma_load_4d(ks + C::kKTile + sl * C::kKSlab, &v_map, &full[st],
                    sl * 64, hk, j * kBk, b);
    }
    return;
  }

  // consumers: warpgroup c owns query rows q0 + 64 c .. + 63
  setmaxnreg_inc<240>();
  const int c = wg - 1;
  const int t128 = threadIdx.x - 128 * wg;
  const int warp = t128 >> 5, lane = t128 & 31, quad = lane & 3;
  const int r_base = q0 + 64 * c;
  const int row0 = r_base + warp * 16 + (lane >> 2);   // and row0 + 8
  // lse2 and Delta of the two rows (the workspace's rows reach q0 + 128)
  const size_t rb = ((size_t)b * Hq + hq) * S_pad;
  const float l2_a = lse2[rb + row0], l2_b = lse2[rb + row0 + 8];
  const float dl_a = delta[rb + row0], dl_b = delta[rb + row0 + 8];

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  mbar_wait(&qd_full, 0);
  const unsigned char* qc = q_s + c * 64 * 128;   // this warpgroup's rows
  const unsigned char* dc = do_s + c * 64 * 128;
  // every tile up to the CTA's last real row (rows past Sq, zero-filled,
  // add nothing and are not stored)
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % NS;
    const unsigned char* ks = kv_s + st * kStage;
    const unsigned char* vs = ks + C::kKTile;
    float s[kBk / 2], dp[kBk / 2];
    uint32_t ds[kBk / 16][4];
    mbar_wait(&full[st], (j / NS) & 1);
    fence_regs<kBk / 2>(s);
    fence_regs<kBk / 2>(dp);
    wgmma_fence();
    mma_ss<D, kBk, C::kDqSlab, C::kKSlab>(s, qc, ks);    // S = Q K^T
    mma_ss<Dv, kBk, C::kDqSlab, C::kKSlab>(dp, dc, vs);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<kBk / 2>(s);
    fence_regs<kBk / 2>(dp);
    // dS = P (dP - Delta), P over the keys row i sees: causal j <= i
    // (keys past Sk lie past every real row's diagonal, in a tile that is
    // masked); else j < Sk, masked in the ragged last tile
#ifndef FLASH_BWD_PRODUCTS_ONLY
    if (kCausal ? j * kBk + kBk - 1 > r_base : j * kBk + kBk > Sk) {
#pragma unroll
      for (int n = 0; n < kBk / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = j * kBk + n * 8 + 2 * quad + (e & 1);
          if (kCausal ? kpos > row0 + (e < 2 ? 0 : 8) : kpos >= Sk)
            s[4 * n + e] = -INFINITY;
        }
    }
#pragma unroll
    for (int n = 0; n < kBk / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        s[4 * n + e] = ex2(fmaf(s[4 * n + e], sl2, lo ? -l2_a : -l2_b)) *
                       (dp[4 * n + e] - (lo ? dl_a : dl_b));
      }
#endif
    pack<kBk>(s, ds);
    fence_regs<DP / 2>(acc);
    fence_regs<kBk / 4>(&ds[0][0]);
    wgmma_fence();
    mma_rs<DP, kBk, C::kKSlab>(acc, ds, ks);   // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DP / 2>(acc);
    fence_regs<kBk / 4>(&ds[0][0]);
    mbar_arrive(&empty[st]);   // K and V of tile j are read
  }

  // the first D columns (past them the padded product's are zero)
  const size_t q_row = (size_t)Hq * D;
  float* dqb = dq + (size_t)b * Sq * q_row + (size_t)hq * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + 2 * quad;
    if (row0 < Sq)
      *reinterpret_cast<float2*>(dqb + row0 * q_row + d) =
          make_float2(acc[4 * n] * scale, acc[4 * n + 1] * scale);
    if (row0 + 8 < Sq)
      *reinterpret_cast<float2*>(dqb + (row0 + 8) * q_row + d) =
          make_float2(acc[4 * n + 2] * scale, acc[4 * n + 3] * scale);
  }
}

// (d) dk += the partials of chunks 1 .. n_parts, in that order, and dv the
// same; n4k float4s in dk, n4v in dv, part (n_parts, n4k + n4v) float4s
// (a chunk's dK, then its dV)
__global__ void __launch_bounds__(256)
flash_bwd_reduce_kernel(float4* __restrict__ dk, float4* __restrict__ dv,
                        const float4* __restrict__ part, long long n4k,
                        long long n4v, int n_parts) {
  const long long x = (long long)blockIdx.x * 256 + threadIdx.x;
  if (x >= n4k + n4v) return;
  const int which = x >= n4k;
  const long long e = x - which * n4k;
  float4* out = (which ? dv : dk) + e;
  float4 a = *out;
  const float4* p = part + which * n4k + e;
  for (int c = 0; c < n_parts; ++c) {
    const float4 t = p[c * (n4k + n4v)];
    a.x += t.x;
    a.y += t.y;
    a.z += t.z;
    a.w += t.w;
  }
  *out = a;
}

// The workspace: lse2 and Delta (B, Hq, S_pad) each, S_pad = Sq rounded up
// to kRowPad, then dK (B, Sk, Hkv, D) and dV (B, Sk, Hkv, Dv) for each of
// chunks 1 .. G - 1 (chunk 0's go straight into dk and dv)
long long ws_floats(int B, int Sq, int Sk, int Hq, int Hkv, int D, int Dv) {
  const long long S_pad = (Sq + kRowPad - 1) / kRowPad * kRowPad;
  return 2 * (long long)B * Hq * S_pad +
         (long long)(Hq / Hkv - 1) * B * Sk * Hkv * (D + Dv);
}

template <int D, int Dv, bool kCausal>
int launch(const void* q, const void* k, const void* v, const bf16* o,
           const bf16* dO, const float* lse, float* ws, float* dq, float* dk,
           float* dv, int B, int Sq, int Sk, int Hq, int Hkv, float scale,
           cudaStream_t stream) {
  using C = Cfg<D, Dv>;
  const int G = Hq / Hkv;
  const int S_pad = (Sq + kRowPad - 1) / kRowPad * kRowPad;
  const size_t n_rows = (size_t)B * Hq * S_pad;
  float* lse2 = ws;
  float* delta = ws + n_rows;
  float* part = ws + 2 * n_rows;
  constexpr int kDeltaRows = 256 / delta_lanes(Dv);
  flash_bwd_delta_kernel<Dv><<<(unsigned)((n_rows + kDeltaRows - 1) /
                                          kDeltaRows),
                               256, 0, stream>>>(o, dO, lse, lse2, delta, Sq,
                                                 S_pad, Hq, (long long)n_rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  CUtensorMap qm, dom, km, vm, qm_dq, dom_dq;
  CUresult r = make_map(&qm, q, B, Sq, Hq, D, C::kBq);
  if (r == CUDA_SUCCESS) r = make_map(&dom, dO, B, Sq, Hq, Dv, C::kBq);
  if (r == CUDA_SUCCESS) r = make_map(&km, k, B, Sk, Hkv, D, kBk);
  if (r == CUDA_SUCCESS) r = make_map(&vm, v, B, Sk, Hkv, Dv, kBk);
  if (r == CUDA_SUCCESS) r = make_map(&qm_dq, q, B, Sq, Hq, D, kBqDq);
  if (r == CUDA_SUCCESS) r = make_map(&dom_dq, dO, B, Sq, Hq, Dv, kBqDq);
  if (r != CUDA_SUCCESS) return kDriverError + (int)r;
  const float sl2 = scale * kLog2e;

  auto dkdv = flash_bwd_dkdv_kernel<D, Dv, kCausal>;
  e = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::kSmemDkdv);
  if (e != cudaSuccess) return (int)e;
  const int nk = (Sk + kBk - 1) / kBk;
  dkdv<<<nk * Hq * B, kThreads, C::kSmemDkdv, stream>>>(
      qm, km, vm, dom, lse2, delta, dk, dv, part, B, Sq, Sk, S_pad, Hq, Hkv,
      sl2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  auto dqk = flash_bwd_dq_kernel<D, Dv, kCausal>;
  e = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::kSmemDq);
  if (e != cudaSuccess) return (int)e;
  dqk<<<dim3((Sq + kBqDq - 1) / kBqDq, Hq, B), kThreads, C::kSmemDq,
        stream>>>(qm_dq, km, vm, dom_dq, lse2, delta, dq, Sq, Sk, S_pad, Hq,
                  G, sl2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || G == 1) return (int)e;   // one chunk: no sum

  const long long n4k = (long long)B * Sk * Hkv * D / 4;
  const long long n4v = (long long)B * Sk * Hkv * Dv / 4;
  flash_bwd_reduce_kernel<<<(unsigned)((n4k + n4v + 255) / 256), 256, 0,
                            stream>>>(
      reinterpret_cast<float4*>(dk), reinterpret_cast<float4*>(dv),
      reinterpret_cast<const float4*>(part), n4k, n4v, G - 1);
  return (int)cudaGetLastError();
}

}  // namespace

// The float32 workspace launch_flash_prefill_bwd takes, in elements.
extern "C" long long flash_prefill_bwd_ws_floats(int B, int Sq, int Sk,
                                                 int Hq, int Hkv, int D,
                                                 int Dv) {
  return Hkv > 0 && Hq % Hkv == 0 ? ws_floats(B, Sq, Sk, Hq, Hkv, D, Dv)
                                  : -1;
}

// The gradient over whole sequences: bf16 q, k, v, o, dO, float32 lse
// (B, Hq, Sq); ws a float32 workspace of ws_n elements, at least
// flash_prefill_bwd_ws_floats; float32 dq, dk, dv written whole.  Causal
// (Sq == Sk) at (D, Dv) in {(64, 64), (128, 128), (96, 64), (112, 112)};
// non-causal
// (any Sq, Sk) at (64, 64).  Limits checked by the wrapper: contiguous
// tensors, 16-byte aligned, Hq % Hkv == 0.  Returns a runtime error code
// (invalid value for a workspace too small or a shape or mode not built),
// or 100000 + a CUresult if a TMA descriptor could not be encoded.
extern "C" int launch_flash_prefill_bwd(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dO, const void* lse,
                                        void* ws, long long ws_n, void* dq,
                                        void* dk, void* dv, int B, int Sq,
                                        int Sk, int Hq, int Hkv, int D,
                                        int Dv, int causal, float scale,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0 || Hq == 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || Hq % Hkv != 0 || Sk <= 0 || (causal && Sq != Sk) ||
      ws_n < ws_floats(B, Sq, Sk, Hq, Hkv, D, Dv))
    return (int)cudaErrorInvalidValue;
  const bf16* O = static_cast<const bf16*>(o);
  const bf16* DO = static_cast<const bf16*>(dO);
  const float* L = static_cast<const float*>(lse);
  float* W = static_cast<float*>(ws);
  float* DQ = static_cast<float*>(dq);
  float* DK = static_cast<float*>(dk);
  float* DV = static_cast<float*>(dv);
  if (!causal) {
    if (D == 64 && Dv == 64)   // Whisper's encoder and cross-attention
      return launch<64, 64, false>(q, k, v, O, DO, L, W, DQ, DK, DV, B, Sq,
                                   Sk, Hq, Hkv, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (D == 64 && Dv == 64)
    return launch<64, 64, true>(q, k, v, O, DO, L, W, DQ, DK, DV, B, Sq, Sk,
                                Hq, Hkv, scale, s);
  if (D == 128 && Dv == 128)
    return launch<128, 128, true>(q, k, v, O, DO, L, W, DQ, DK, DV, B, Sq,
                                  Sk, Hq, Hkv, scale, s);
  if (D == 96 && Dv == 64)   // MLA: qk_nope + qk_rope against v_head_dim
    return launch<96, 64, true>(q, k, v, O, DO, L, W, DQ, DK, DV, B, Sq, Sk,
                                Hq, Hkv, scale, s);
  if (D == 112 && Dv == 112)   // kimi-k2: d_model 7168 over 64 heads
    return launch<112, 112, true>(q, k, v, O, DO, L, W, DQ, DK, DV, B, Sq,
                                  Sk, Hq, Hkv, scale, s);
  return (int)cudaErrorInvalidValue;
}
