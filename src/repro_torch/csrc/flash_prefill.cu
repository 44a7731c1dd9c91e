// Flash attention for layer-segmented prefill, causal or not, for Hopper.
//
// Replaces the Pallas TPU kernel `flash_prefill` in
// src/repro/kernels/flash_prefill.py (mirrored on the serving path by
// `flash_attention_jnp`, src/repro/models/attention.py):
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / G] * scale) @ v[b, j, h / G]
// over the keys j <= q_offset + i (causal) and j < Sk, with
// q (B, Sq, Hq, D), k (B, Sk, Hkv, D), v (B, Sk, Hkv, Dv) bf16 and
// out (B, Sq, Hq, Dv) bf16.
// q_offset is the absolute position of query 0: a chunk continuation
// passes the earlier chunks' keys ahead of its window, Sk = q_offset + Sq.
// The non-causal mode (`flash_attention_jnp(causal=False)`: Whisper's
// encoder, Sq = Sk = 1500, and its cross-attention over the 1500 encoder
// positions, from a prompt window or one decode token per row) lets every
// query see every key j < Sk.  That is the causal mask with its diagonal
// moved past the last key, so the launcher runs the same kernel with
// q_offset = Sk: no tile is then cut by the diagonal, each query tile
// walks all ceil(Sk / 128) key tiles, and only the ragged last one
// (1500 = 11 x 128 + 92) is masked, by j < Sk, where TMA has zero-filled
// the keys past Sk.  The causal mode's device code is untouched by it.
// At Sq = 1 (a decode token) the 128-row query tile holds one real row:
// the K/V reads, which bound the call, are the same as for a full tile.
//
// What bounds it: operations.  4 * Hq * D flops per visible (query, key)
// pair against 2 bytes per element read once: at a 4096-token prompt that
// is thousands of flops per byte, far above the ~295 at which the H100's
// tensor cores, not HBM, are the limit; only wgmma reaches their rate.
//
// Design (FlashAttention-3 in shape): one CTA of three warpgroups per
// (query tile of 128 rows, query head, batch row), heavy tiles (near the
// end of the prompt) first.  Warpgroup 0 is the producer: after
// `setmaxnreg` gives its registers to the consumers, one thread issues TMA
// loads (cp.async.bulk.tensor, 4-D maps over (D, H, S, B), 128-byte
// swizzle) of the Q tile once and of K and V tiles of 128 keys into a ring
// of 4 (D 64; MLA's D 96 with Dv 64) or 3 (D 112 and 128) stages (225 KB
// of shared memory in all at D 112, D 128 and MLA's shape), each guarded
// by a "full" mbarrier that counts the bytes landed and an "empty" one the
// consumers arrive on.
// TMA zero-fills rows past Sq and Sk within each batch row, so a masked
// weight never meets garbage.  Warpgroups 1 and 2 each own 64 query rows:
// S = Q K^T is wgmma m64n128k16 with both operands in shared memory
// (K-major), the online softmax runs in registers in float32 in the log2
// domain, P is rounded to bf16 in registers (the usual FlashAttention
// choice) and is the register A operand of O += P V, wgmma m64nDk16 with V
// read from shared memory transposed (imm-trans-b), so V needs no
// transpose in memory.  Within a warpgroup the two products are issued
// asynchronously so that the softmax of tile j runs while the tensor cores
// do P V of tile j - 1 (wgmma.wait_group 1); the weights are exp2 of one
// FMA each (ex2.approx).  FlashAttention-3's ping-pong (the two
// warpgroups taking turns at the tensor cores through named barriers) was
// slower on the H100 and is not used (PERF.md).  Only tiles that cross a
// row's causal diagonal or Sk are masked; tiles past the diagonal of a
// warpgroup's last real query are skipped (it still releases their
// stage).  Head dims D = Dv in {64, 128} (one or two 64-element slabs of
// 128 bytes) are instantiated, and MLA's prefill, D = 96 for q and k
// (qk_nope 64 + qk_rope 32) with Dv = 64 for v: its q and k tensor maps
// are 96 columns wide and are loaded as two 64-column boxes, of which TMA
// fills columns 96-127 of the second with zeros (they lie past the
// tensor), and S = Q K^T runs D / 16 = 6 k-steps, so the zero columns are
// never even read; the wrapper passes q and k unpadded.  kimi-k2's heads,
// D = Dv = 112, load the same way on both sides: q and k as two 64-column
// boxes (columns 112-127 zero-filled, 7 k-steps of S = Q K^T), and v too,
// so that O += P V runs as m64n128 over 128 columns of which the last 16
// are zero; the epilogue stores only the first Dv = 112 columns, since the
// next 16 of the (B, Sq, Hq, 112) output belong to the next head.  The
// GQA group is
// not folded: each query head's CTA loads its K/V tiles, which the
// group's other heads read again from L2.
//
// The TMA descriptors are encoded on the host per launch (the pointers
// change) with the driver API's cuTensorMapEncodeTiled, and passed as
// __grid_constant__ parameters.  The library links only the CUDA runtime:
// the driver function is fetched once through the runtime
// (cudaGetDriverEntryPoint), so the build needs no libcuda.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBr = 128;   // query rows per CTA: 64 per consumer warpgroup
constexpr int kBc = 128;   // keys per K/V tile
constexpr int kThreads = 384;
constexpr int kSlabBytesQ = kBr * 128;   // one 64-column slab of the Q tile
constexpr int kSlabBytesKV = kBc * 128;  // one 64-column slab of a K/V tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

template <int D, int Dv> struct Cfg {
  static_assert(D % 16 == 0 && D <= 128 && Dv % 8 == 0 && Dv <= 128,
                "q/k depth a multiple of 16 up to 128, v width a multiple "
                "of 8 up to 128");
  static constexpr int kSlabsQK = (D + 63) / 64;   // a part slab zero-filled
  static constexpr int kSlabsV = (Dv + 63) / 64;
  // the width P V runs at (64 or 128): columns Dv.. of V are zero-filled
  // and the epilogue stores only the first Dv
  static constexpr int kDvPad = kSlabsV * 64;
  // the consumers hold two tiles at once (P V of one overlaps the softmax
  // of the next), so a third stage (a fourth where a stage is at most 48
  // KB) keeps a load ahead, within the 227 KB of shared memory
  static constexpr int kStages = (D > 96 || Dv > 64) ? 3 : 4;
  static constexpr int kQBytes = kSlabsQK * kSlabBytesQ;
  static constexpr int kKBytes = kSlabsQK * kSlabBytesKV;
  static constexpr int kVBytes = kSlabsV * kSlabBytesKV;
  static constexpr int kStageBytes = kKBytes + kVBytes;   // K, then V
  static constexpr int kSmem =
      1024 + kQBytes + kStages * kStageBytes;   // + alignment slack
};

// two floats -> bf16x2, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// issue S = Q K^T of one tile (64 rows of the Q tile at qc, the 128 keys of
// the K tile at ks): the accumulator fragment s[4 n + e]
template <int D>
__device__ __forceinline__ void issue_s(float* s, const unsigned char* qc,
                                        const unsigned char* ks) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int sl = kk / 4, off = (kk % 4) * 32;
    wgmma_m64n128k16_ss(s, sw128_desc(qc + sl * kSlabBytesQ + off, 16, 1024),
                        sw128_desc(ks + sl * kSlabBytesKV + off, 16, 1024),
                        kk > 0);
  }
  wgmma_commit();
}

// issue O += P V of one tile: V (keys x DvPad) at vs read transposed, 16
// keys (2048 bytes) per k-step, 64-column slabs kSlabBytesKV apart
template <int DvPad>
__device__ __forceinline__ void issue_pv(float* o, uint32_t (*p)[4],
                                         const unsigned char* vs) {
#pragma unroll
  for (int kk = 0; kk < kBc / 16; ++kk) {
    const uint64_t desc = sw128_desc(vs + kk * 16 * 128, kSlabBytesKV, 1024);
    if constexpr (DvPad == 64)
      wgmma_m64n64k16_rs_tb(o, p[kk], desc, 1);
    else
      wgmma_m64n128k16_rs_tb(o, p[kk], desc, 1);
  }
  wgmma_commit();
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the online-softmax state of one thread's two rows (row0 and row0 + 8)
struct Rows {
  int qpos0;          // absolute position of row0
  int Sk;
  int quad;           // lane & 3: the thread's column pair in each 8-key chunk
  float scale_log2;   // scale * log2(e)
  float m[2];         // running max, log2 domain
  float l[2];         // running sum of weights
};

// One K/V tile's online-softmax step, in place on the raw scores s (the
// accumulator fragment of the tile's 128 keys, kbase the first key): keys
// past a row's diagonal or Sk get weight 0 (checked only where the tile
// crosses them), the others exp2(s * scale_log2 - m); updates m and l and
// writes the factors that rescale the rows' earlier output into corr.  A
// masked score counts as -1e30 in the max: every row sees key 0 in its
// first tile, so m is finite from then on.
__device__ __forceinline__ void softmax_tile(float* s, float* corr, Rows& r,
                                             int kbase, bool masked) {
  if (masked) {
#pragma unroll
    for (int n = 0; n < kBc / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kbase + n * 8 + 2 * r.quad + (e & 1);
        const int qp = r.qpos0 + (e < 2 ? 0 : 8);
        if (kpos > qp || kpos >= r.Sk) s[4 * n + e] = kNegInf;
      }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < kBc / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * n + e]);
  float neg_m[2], rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(r.m[i], mx[i] * r.scale_log2);
    corr[i] = ex2(r.m[i] - m_new);
    r.m[i] = m_new;
    neg_m[i] = -m_new;
  }
#pragma unroll
  for (int n = 0; n < kBc / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float w = ex2(fmaf(s[4 * n + e], r.scale_log2, neg_m[e >> 1]));
      s[4 * n + e] = w;
      rsum[e >> 1] += w;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
    rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
    r.l[i] = r.l[i] * corr[i] + rsum[i];
  }
}

// the weights of a tile (softmax_tile's s) rounded to bf16 as the A
// fragments of P V: keys 16 kk .. 16 kk + 15 are chunks 2 kk and 2 kk + 1,
// rows row0 (e 0, 1) and row0 + 8 (e 2, 3)
__device__ __forceinline__ void pack_p(const float* s, uint32_t (*p)[4]) {
#pragma unroll
  for (int kk = 0; kk < kBc / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// kLse: the training forward's instance, which also writes each row's
// log-sum-exp (the serving path's instance is the same code without it)
template <int D, int Dv, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     bf16* __restrict__ out, float* __restrict__ lse,
                     int Sq, int Sk, int Hq, int G, int q_offset,
                     float scale_log2) {
  using C = Cfg<D, Dv>;
  constexpr int S = C::kStages;
  __shared__ __align__(8) uint64_t q_full, full[S], empty[S];
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle and the wgmma descriptors need 1024-byte atoms
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = smem;
  unsigned char* kv_s = smem + C::kQBytes;   // stage st: K, then V

  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy tiles first
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / G;
  const int q0 = qt * kBr;
  // keys up to the causal diagonal of the tile's last real query
  const int last_q = min(q0 + kBr, Sq) - 1;
  const int k_end = min(Sk, q_offset + last_q + 1);
  const int n_tiles = k_end > 0 ? (k_end + kBc - 1) / kBc : 0;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 256);   // every consumer thread arrives
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring of K/V tiles filled
    setmaxnreg_dec<24>();
    if (threadIdx.x != 0) return;
    // whole boxes count, the zero-filled columns past D included
    mbar_arrive_expect_tx(&q_full, C::kQBytes);
    for (int sl = 0; sl < C::kSlabsQK; ++sl)
      tma_load_4d(q_s + sl * kSlabBytesQ, &q_map, &q_full, sl * 64, hq, q0,
                  b);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % S;
      if (j >= S) mbar_wait(&empty[st], ((j / S) - 1) & 1);
      mbar_arrive_expect_tx(&full[st], C::kStageBytes);
      unsigned char* ks = kv_s + st * C::kStageBytes;
      unsigned char* vs = ks + C::kKBytes;
      for (int sl = 0; sl < C::kSlabsQK; ++sl)
        tma_load_4d(ks + sl * kSlabBytesKV, &k_map, &full[st], sl * 64, hk,
                    j * kBc, b);
      for (int sl = 0; sl < C::kSlabsV; ++sl)
        tma_load_4d(vs + sl * kSlabBytesKV, &v_map, &full[st], sl * 64, hk,
                    j * kBc, b);
    }
    return;
  }

  // consumers: warpgroup c owns query rows q0 + 64 c .. + 63
  setmaxnreg_inc<240>();
  const int c = wg - 1;
  const int t128 = threadIdx.x - 128 * wg;
  const int warp = t128 >> 5;
  const int lane = t128 & 31;
  const int r_base = q0 + 64 * c;
  const int row0 = r_base + warp * 16 + (lane >> 2);   // and row0 + 8
  const int quad = lane & 3;
  // tiles this warpgroup needs: up to the diagonal of its last real row
  int n_own = 0;
  if (r_base < Sq) {
    const int own_end = min(Sk, q_offset + min(r_base + 63, Sq - 1) + 1);
    n_own = own_end > 0 ? (own_end + kBc - 1) / kBc : 0;
  }
  Rows rows{q_offset + row0, Sk, quad, scale_log2,
            {kNegInf, kNegInf}, {0.f, 0.f}};

  constexpr int DvPad = C::kDvPad;
  float o[DvPad / 2];
#pragma unroll
  for (int i = 0; i < DvPad / 2; ++i) o[i] = 0.f;
  float s[kBc / 2];          // S of the newest tile, then its weights
  uint32_t p[kBc / 16][4];   // P of the tile whose P V is next or in flight
  float corr[2];

  mbar_wait(&q_full, 0);
  const unsigned char* qc = q_s + c * 64 * 128;   // this warpgroup's rows
  auto tile = [&](int j) { return kv_s + (j % S) * C::kStageBytes; };
  auto masked = [&](int j) {   // does tile j cross a row's diagonal or Sk?
    return j * kBc + kBc - 1 > q_offset + r_base || j * kBc + kBc > Sk;
  };

  // Software pipeline within the warpgroup: the softmax of tile j runs
  // while the tensor cores do P V of tile j - 1.  Every register a wgmma
  // reads is fenced (fence_regs) before the wgmma.fence that opens its
  // group, and the softmax between the two waits writes only S's
  // registers, whose group has completed: otherwise ptxas serializes the
  // wgmmas.
  if (n_own > 0) {
    mbar_wait(&full[0], 0);
    fence_regs<kBc / 2>(s);
    wgmma_fence();
    issue_s<D>(s, qc, tile(0));
    wgmma_wait<0>();
    fence_regs<kBc / 2>(s);
    softmax_tile(s, corr, rows, 0, masked(0));
    pack_p(s, p);
  }
  for (int j = 1; j < n_own; ++j) {
    mbar_wait(&full[j % S], (j / S) & 1);
    fence_regs<kBc / 2>(s);
    fence_regs<DvPad / 2>(o);
    fence_regs<kBc / 4>(&p[0][0]);
    wgmma_fence();
    issue_s<D>(s, qc, tile(j));
    issue_pv<DvPad>(o, p, tile(j - 1) + C::kKBytes);
    wgmma_wait<1>();   // S of tile j has landed; P V of j - 1 may not have
    fence_regs<kBc / 2>(s);
    softmax_tile(s, corr, rows, j * kBc, masked(j));
    wgmma_wait<0>();
    fence_regs<DvPad / 2>(o);
    fence_regs<kBc / 4>(&p[0][0]);
    mbar_arrive(&empty[(j - 1) % S]);   // K and V of tile j - 1 are read
#pragma unroll
    for (int n = 0; n < DvPad / 8; ++n) {
      o[4 * n] *= corr[0];
      o[4 * n + 1] *= corr[0];
      o[4 * n + 2] *= corr[1];
      o[4 * n + 3] *= corr[1];
    }
    pack_p(s, p);
  }
  if (n_own > 0) {
    fence_regs<DvPad / 2>(o);
    fence_regs<kBc / 4>(&p[0][0]);
    wgmma_fence();
    issue_pv<DvPad>(o, p, tile(n_own - 1) + C::kKBytes);
    wgmma_wait<0>();
    fence_regs<DvPad / 2>(o);
    fence_regs<kBc / 4>(&p[0][0]);
    mbar_arrive(&empty[(n_own - 1) % S]);
  }
  // tiles past this warpgroup's rows: release them unread
  for (int j = n_own; j < n_tiles; ++j) {
    mbar_wait(&full[j % S], (j / S) & 1);
    mbar_arrive(&empty[j % S]);
  }

  const float* l = rows.l;
  const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
  const size_t q_row = (size_t)Hq * Dv;   // elements between tokens
  bf16* ob = out + (size_t)b * Sq * q_row + (size_t)hq * Dv;
  // the first Dv columns only: past them lies the next head's output
#pragma unroll
  for (int n = 0; n < Dv / 8; ++n) {
    const int d = n * 8 + 2 * quad;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * q_row + d) =
          __floats2bfloat162_rn(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    if (row0 + 8 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)(row0 + 8) * q_row +
                                         d) =
          __floats2bfloat162_rn(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
  }
  // the training forward: each row's log-sum-exp of its scaled scores,
  // natural log, lse (B, Hq, Sq); m is kept in the log2 domain, so
  // ln(sum_j e^(s_j scale)) = (m + log2 l) ln 2.  The four threads of a
  // quad hold the same m and l (reduced by the shuffles); one writes.
  if constexpr (kLse) {
    if (quad == 0) {
      float* lb = lse + ((size_t)b * Hq + hq) * Sq;
      if (row0 < Sq) lb[row0] = (rows.m[0] + log2f(l[0])) * kLn2;
      if (row0 + 8 < Sq) lb[row0 + 8] = (rows.m[1] + log2f(l[1])) * kLn2;
    }
  }
}

template <int D, int Dv, bool kLse = false>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int q_offset,
           float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  CUresult r = make_map(&qm, q, B, Sq, Hq, D, kBr);
  if (r == CUDA_SUCCESS) r = make_map(&km, k, B, Sk, Hkv, D, kBc);
  if (r == CUDA_SUCCESS) r = make_map(&vm, v, B, Sk, Hkv, Dv, kBc);
  if (r != CUDA_SUCCESS) return kDriverError + (int)r;
  auto kern = flash_prefill_kernel<D, Dv, kLse>;
  constexpr int smem = Cfg<D, Dv>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBr - 1) / kBr, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(
      qm, km, vm, static_cast<bf16*>(out), lse, Sq, Sk, Hq, Hq / Hkv,
      q_offset, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// bfloat16, (D, Dv) in {(64, 64), (128, 128), (96, 64), (112, 112)};
// causal, or every query over every key (causal == 0: q_offset is
// ignored).  lse: null (serving), or a float32 (B, Hq, Sq) buffer that
// takes each row's log-sum-exp (training's forward, whose backward is
// flash_prefill_bwd.cu; (D, Dv) in {(64, 64), (128, 128), (96, 64),
// (112, 112)}, either mode).  Limits checked by the wrapper: contiguous (B, S, H,
// D|Dv) tensors, 16-byte aligned, Hq % Hkv == 0, q_offset >= 0.
// Returns a runtime error code, or 100000 + a CUresult if a TMA
// descriptor could not be encoded.
extern "C" int launch_flash_prefill(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    int B, int Sq, int Sk, int Hq, int Hkv,
                                    int D, int Dv, int q_offset, int causal,
                                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0 || Hq == 0) return (int)cudaGetLastError();
  // non-causal: the diagonal past every key (see the note at the top)
  const int qo = causal ? q_offset : Sk;
  float* L = static_cast<float*>(lse);
  if (L != nullptr) {   // training: the dense heads, MLA's and kimi-k2's
    if (D == 64 && Dv == 64)
      return launch<64, 64, true>(q, k, v, out, L, B, Sq, Sk, Hq, Hkv, qo,
                                  scale, s);
    if (D == 128 && Dv == 128)
      return launch<128, 128, true>(q, k, v, out, L, B, Sq, Sk, Hq, Hkv, qo,
                                    scale, s);
    if (D == 96 && Dv == 64)
      return launch<96, 64, true>(q, k, v, out, L, B, Sq, Sk, Hq, Hkv, qo,
                                  scale, s);
    if (D == 112 && Dv == 112)
      return launch<112, 112, true>(q, k, v, out, L, B, Sq, Sk, Hq, Hkv, qo,
                                    scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (D == 64 && Dv == 64)
    return launch<64, 64>(q, k, v, out, L, B, Sq, Sk, Hq, Hkv, qo, scale, s);
  if (D == 128 && Dv == 128)
    return launch<128, 128>(q, k, v, out, L, B, Sq, Sk, Hq, Hkv, qo, scale,
                            s);
  if (D == 96 && Dv == 64)   // MLA: qk_nope + qk_rope against v_head_dim
    return launch<96, 64>(q, k, v, out, L, B, Sq, Sk, Hq, Hkv, qo, scale,
                            s);
  if (D == 112 && Dv == 112)   // kimi-k2: d_model 7168 over 64 heads
    return launch<112, 112>(q, k, v, out, L, B, Sq, Sk, Hq, Hkv, qo, scale,
                            s);
  return (int)cudaErrorInvalidValue;
}
