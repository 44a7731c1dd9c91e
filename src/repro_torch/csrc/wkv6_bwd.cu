// The gradient of the WKV recurrence (csrc/wkv6.cu) for Hopper: training's
// backward ("kernel B").
//
// Replaces no Pallas kernel: the reference trains RWKV6 by
// jax.value_and_grad through the jax.lax.scan of `_wkv_step`
// (src/repro/models/rwkv6.py:93, :135-140), which differentiates the scan
// step by step.  Here, for one window of S tokens:
//
//   r, k, v, w, dy (B, S, H, 64), u (H, 64), float32; S_in (B, H, nc, 64,
//   64), the state before each time chunk, from the forward (kernel A,
//   launch_wkv6_f32); dS (B, H, 64, 64), the final state's gradient
//   -> dr, dk, dv, dlogw (B, S, H, 64), du (H, 64), dS0 (B, H, 64, 64)
//
// with, per token t in reverse, lam the gradient of the state after t and
// dyv = dy . v (ref.wkv6_bwd is the plain loop):
//   dr_i = sum_j dy_j S_ij + u_i k_i dyv     dk_i = sum_j lam_ij v_j + r_i u_i dyv
//   dv_j = sum_i lam_ij k_i + (sum_i r_i u_i k_i) dy_j
//   du_i += r_i k_i dyv                      lam_ij = w_i lam_ij + r_i dy_j
// and the gradient of log w, w_i sum_j lam_ij S_ij, formed without the
// states: with a_t,i = sum_j lam_{t+1,ij} S_{t+1,ij} (the state after t
// and its gradient), dlogw_t = a_t - P_t and a_{t-1} = a_t - P_t + Q_t,
// where P_t = k_t (lam_{t+1} v_t), the k-term dk's walk forms, and Q_t =
// r_t (S_t dy_t), the r-term dr's walk forms.
//
// What bounds it: bytes, on paper.  Per (token, head) it reads r, k, v, w
// and dy and writes dr, dk, dv and dlogw, 2,304 bytes (0.186 ms at B 2 x
// 4,096 and 32 heads at 3.35 TB/s), against at least 9 float32
// operations per (i, j) (dr's, dk's and dv's multiply-adds and lam's
// multiply and multiply-add, 0.144 ms at 67 TFLOP/s).  The walks below
// issue 10 a (i, j) (3 in each of R, K and V, 1 in the local pass), and
// what binds them on the card is shared memory: a 16-byte shared load
// costs a quarter-warp wavefront each whether its lanes share the address
// or not, so a thread must feed several rows from each load.
//
// Design: the forward's time chunks run in reverse, since lam_t =
// diag(w_t) lam_{t+1} + r_t dy_t^T is linear in lam_{t+1}.  Chunks are
// the forward's (the same L, so S_in[c] is the state at chunk c's start).
// Every thread walks its chunk once, in one of four roles of 128 threads,
// two roles a CTA of 256 threads that share the staged tokens:
//   1. fwd    (row, head, chunk): both roles walk the chunk forward.
//      R      S forward from S_in[c], writing dr and Q_t (parked in
//             dlogw's slot); the last chunk's R also forms a_end =
//             <dS, S_end>_i, which it alone holds S_end for, into du's
//             share slot.
//      local  (c >= 1) lam walked from zero at the chunk's end to its
//             start, in forward order: lam_loc[c] = sum_t D_t r_t dy_t^T
//             with D_t the product of the chunk's decays before t (one
//             multiply-add a (i, j)), and the chunk's decay product W[c].
//   2. carry  (row, head, 256 state values): lam_end[nc-1] = dS,
//             lam_end[c-1] = W[c]_i lam_end[c]_ij + lam_loc[c]_ij, in place.
//   3. bwd    (row, head, chunk): both roles walk lam back from lam_end[c].
//      K      (rows) writes dk, and dlogw from the suffix a, started at
//             a_end = <lam_end[c], S_in[c+1]>_i (the last chunk's from R)
//             with Q_t read from the stage; the chunk's share of du; chunk
//             0 writes dS0.
//      V      (columns) writes dv.
//   4. du     (head): the shares summed over rows and chunks in a fixed
//             order, so the kernel is deterministic.
// A window of one chunk is launches 1, 3 and 4 from S0 and dS.  R and the
// local pass need nothing of lam, so they share launch 1 and no walk waits
// on another: the suffix pass runs inside K, and Q, the only term it needs
// from R, comes with K's staged tokens (no P_t in device memory, no fifth
// launch, no scratch beyond the parent's).  A thread keeps a 4 x 8 tile of
// its role's state (Tile below: each shared load feeds 4 rows or
// columns, conflict-free), the tile's row (column) sums a 4-shuffle
// transposing butterfly; the tokens come kStage at a time into two
// shared-memory buffers by cp.async, the next stage in flight while this
// one is walked; each stage's dy . v and sum r u k are 16 lanes a token
// in conflict-free 16-byte loads.  On an H100 80GB HBM3 at 700 W
// (`ab_kernels.py`, PERF.md): 0.85 ms at B 2 x 4,096, 32 heads (fwd 0.35,
// bwd 0.46), 4.6x the bound, where the earlier design (the rows'
// CTA walking its chunk twice, 64-thread CTAs, one state row a thread,
// loads between barriers, Q read back from device memory in the walk, a
// 40-byte spill) took 2.30 ms.
#include "common.cuh"

// Probes and planted faults, each a separate build (ab_kernels.py
// --probes, kernels/build.py's FAULT_VARIANTS); their results are not the
// gradient.  -DWKV_BWD_NO_STORES: the walks' per-token stores go into a
// register sink, stored once a thread.  -DWKV_BWD_FAULT_NO_AEND: K's
// suffix starts from 0 instead of a_end.
#ifdef WKV_BWD_NO_STORES
#define WKV_PUT(dst, val) (sink += (val))
#else
#define WKV_PUT(dst, val) ((dst) = (val))
#endif

namespace {

constexpr int kHead = 64;
constexpr int kState = kHead * kHead;
constexpr int kStage = 16;          // tokens staged per pass
constexpr int kRole = 128;          // threads a role: 2 a row (or column)
constexpr int kThreads = 2 * kRole; // two roles a CTA
constexpr int kCarryThreads = 256;  // state values per carry CTA

struct Inputs {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* dy;
  const float* u;
};

struct Outputs {
  float* dr;
  float* dk;
  float* dv;
  float* dlogw;
  float* ds0;
  float* dupart;
};

// kStage tokens of one (row, head), float32; with kQ also their Q_t; per
// token dy . v and sum_i r_i u_i k_i.
template <bool kQ>
struct Stage {
  __align__(16) float r[kStage][kHead];
  __align__(16) float k[kStage][kHead];
  __align__(16) float v[kStage][kHead];
  __align__(16) float w[kStage][kHead];
  __align__(16) float dy[kStage][kHead];
  __align__(16) float q[kQ ? kStage : 1][kHead];
  float dyv[kStage];
  float bon[kStage];
};

template <bool kQ>
struct Smem {
  Stage<kQ> st[2];
  __align__(16) float u[kHead];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start the copy of n tokens of (row b, head h) from float offset off
// (token stride `stride`) into st; with kQ also Q from dlogw's slot.
template <bool kQ>
__device__ __forceinline__ void issue_stage(Stage<kQ>& st, const Inputs& in,
                                            const float* q, size_t off,
                                            size_t stride, int n) {
  constexpr int kArrays = kQ ? 6 : 5;
  static_assert(kStage * kHead / 4 <= kThreads, "a piece an array a thread");
  const int p = threadIdx.x;
  if (p < n * (kHead / 4)) {
    const int t = p / (kHead / 4), e = (p % (kHead / 4)) * 4;
    const size_t g = off + t * stride + e;
#pragma unroll
    for (int a = 0; a < kArrays; ++a) {
      const float* src = a == 0 ? in.r : a == 1 ? in.k : a == 2 ? in.v
                       : a == 3 ? in.w : a == 4 ? in.dy : q;
      float* dst = a == 0 ? &st.r[t][e] : a == 1 ? &st.k[t][e]
                 : a == 2 ? &st.v[t][e] : a == 3 ? &st.w[t][e]
                 : a == 4 ? &st.dy[t][e] : &st.q[t][e];
      cp_async16(dst, src + g);
    }
  }
  cp_async_commit();
}

// The stage's per-token dots dy . v and, with kBon, sum_i r_i u_i k_i: a
// warp takes tokens 2 warp and 2 warp + 1, 16 lanes a token, 4 channels a
// lane (conflict-free 16-byte loads), summed over the 16 lanes by 4
// shuffles in a fixed order.
template <bool kQ, bool kBon>
__device__ __forceinline__ void stage_dots(Stage<kQ>& st, const float* u,
                                           int n) {
  static_assert(kThreads == 16 * kStage, "16 lanes a token");
  const int lane = threadIdx.x & 31;
  const int t = 2 * (threadIdx.x >> 5) + (lane >> 4), e = 4 * (lane & 15);
  float a = 0.f, c = 0.f;
  if (t < n) {
    const float4 d = *reinterpret_cast<const float4*>(&st.dy[t][e]);
    const float4 v = *reinterpret_cast<const float4*>(&st.v[t][e]);
    a = fmaf(d.x, v.x, fmaf(d.y, v.y, fmaf(d.z, v.z, d.w * v.w)));
    if (kBon) {
      const float4 r = *reinterpret_cast<const float4*>(&st.r[t][e]);
      const float4 k = *reinterpret_cast<const float4*>(&st.k[t][e]);
      const float4 uu = *reinterpret_cast<const float4*>(&u[e]);
      c = fmaf(r.x * uu.x, k.x, fmaf(r.y * uu.y, k.y,
               fmaf(r.z * uu.z, k.z, r.w * uu.w * k.w)));
    }
  }
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    if (kBon) c += __shfl_xor_sync(0xffffffffu, c, o);
  }
  if ((lane & 15) == 0 && t < n) {
    st.dyv[t] = a;
    if (kBon) st.bon[t] = c;
  }
}

// The bounds [s, s + n) of stage si of a chunk [t0, t1) walked forward
// (from t0) or back (from t1; a partial stage then comes last).
__device__ __forceinline__ void stage_range(int si, int t0, int t1,
                                            bool back, int& s, int& n) {
  if (back) {
    const int end = t1 - si * kStage;
    s = max(t0, end - kStage);
    n = end - s;
  } else {
    s = t0 + si * kStage;
    n = min(kStage, t1 - s);
  }
}

// A role's 128 threads tile the 64 x 64 state in 4 x 8 blocks.  In a row
// tile (R, the local pass, K) a thread keeps rows 4 rg + m (m < 4) and
// columns 4 cg + e and 32 + 4 cg + e (e < 4), with cg = lane % 8 and rg = 4
// warp + lane / 8; in a column tile (V) the transpose: columns 4 cg + n
// and rows 4 rg + e and 32 + 4 rg + e, with rg = lane % 8 and cg = 4 warp
// + lane / 8.  Each shared load then feeds 4 rows (or columns): a
// quarter-warp reads 8 distinct 16-byte pieces in distinct banks, or one
// piece it shares, one wavefront either way; the row (column) sums over a
// tile row's 8 lanes are a transposing butterfly of 4 shuffles, after
// which lanes 2 k and 2 k + 1 of those 8 hold the sum of the tile's own
// row (column) m = k (own(lane) below).
struct Tile {
  int lo, hi, m4;   // this thread's two quads and its 4 rows (columns)
};
__device__ __forceinline__ Tile tile(int rt) {
  const int lane = rt & 31, warp = rt >> 5, g = lane & 7;
  const int other = 4 * warp + (lane >> 3);
  return {4 * g, 32 + 4 * g, 4 * other};
}
__device__ __forceinline__ int own(int lane) {
  return 2 * ((lane >> 2) & 1) + ((lane >> 1) & 1);
}

// the sums over the 8 lanes of lane bits 0-2 of v[m], m < 4: lane ends
// with that of m = own(lane)
__device__ __forceinline__ float tile_sum(float (&v)[4], int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int off = 4 >> r, half = 2 >> r;
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? v[i] : v[i + half];
      const float keep = up ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
// a row tile's 8 values of row `row` of a 64 x 64 matrix into x
__device__ __forceinline__ void ld_row(float (&x)[8], const float* row,
                                       const Tile& tl) {
  const float4 a = ld4(row + tl.lo), b = ld4(row + tl.hi);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// Launch 1: grid (nc, H, B).  Threads 0-127 R, 128-255 the local pass of
// chunk c >= 1 (idle at c = 0); both row tiles.
__global__ void __launch_bounds__(kThreads, 2)
wkv6_bwd_fwd_kernel(Inputs in, Outputs out, const float* __restrict__ s_in,
                    const float* __restrict__ ds, float* __restrict__ lam,
                    float* __restrict__ wprod, int S, int H, int L, int nc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<false>& sm = *reinterpret_cast<Smem<false>*>(smem_raw);
  const int c = blockIdx.x, h = blockIdx.y;
  const size_t b = blockIdx.z;
  const size_t slot = (b * H + h) * nc + c;
  const size_t stride = (size_t)H * kHead;
  const int role = threadIdx.x / kRole, rt = threadIdx.x % kRole;
  const int lane = rt & 31;
  const Tile tl = tile(rt);
  const int io = tl.m4 + own(lane);          // the row this lane stores
  const bool local = role == 1 && c >= 1;
  if (threadIdx.x < kHead)
    sm.u[threadIdx.x] = in.u[(size_t)h * kHead + threadIdx.x];
  const int t0 = c * L, t1 = min(S, t0 + L);
  const size_t base = (b * S * H + h) * kHead;
  auto tok = [&](int t) { return base + (size_t)t * stride; };
  float x[4][8];
  float wrun[4] = {1.f, 1.f, 1.f, 1.f};
  if (role == 0) {
#pragma unroll
    for (int m = 0; m < 4; ++m)
      ld_row(x[m], s_in + slot * kState + (tl.m4 + m) * kHead, tl);
  } else {
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int p = 0; p < 8; ++p) x[m][p] = 0.f;
  }
  const float uo = in.u[(size_t)h * kHead + io];
  float sink = 0.f;
  // R stores dr (even lanes) or Q_t (odd) of row io
  float* const put = ((lane & 1) ? out.dlogw : out.dr) + base + io;
  const int n_st = (t1 - t0 + kStage - 1) / kStage;
  {
    int s, n;
    stage_range(0, t0, t1, false, s, n);
    issue_stage(sm.st[0], in, nullptr, tok(s), stride, n);
  }
  for (int si = 0; si < n_st; ++si) {
    Stage<false>& st = sm.st[si & 1];
    cp_async_wait_all();
    __syncthreads();   // stage si landed; the other buffer is free
    if (si + 1 < n_st) {
      int s, n;
      stage_range(si + 1, t0, t1, false, s, n);
      issue_stage(sm.st[(si + 1) & 1], in, nullptr, tok(s), stride, n);
    }
    int s, n;
    stage_range(si, t0, t1, false, s, n);
    stage_dots<false, false>(st, sm.u, n);
    __syncthreads();   // the dots are visible
    if (role == 0) {
      for (int t = 0; t < n; ++t) {
        const float4 k4 = ld4(&st.k[t][tl.m4]), w4 = ld4(&st.w[t][tl.m4]);
        const float km[4] = {k4.x, k4.y, k4.z, k4.w};
        const float wm[4] = {w4.x, w4.y, w4.z, w4.w};
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int hq = 0; hq < 2; ++hq) {
          const float4 v4 = ld4(&st.v[t][hq ? tl.hi : tl.lo]);
          const float4 d4 = ld4(&st.dy[t][hq ? tl.hi : tl.lo]);
          const float vj[4] = {v4.x, v4.y, v4.z, v4.w};
          const float dj[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
          for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float& sx = x[m][4 * hq + e];
              acc[m] = fmaf(sx, dj[e], acc[m]);
              sx = fmaf(wm[m], sx, km[m] * vj[e]);
            }
        }
        const float sdy = tile_sum(acc, lane);
        const float ko = st.k[t][io], ro = st.r[t][io];
        WKV_PUT(put[(size_t)(s + t) * stride],
                (lane & 1) ? ro * sdy : fmaf(uo * ko, st.dyv[t], sdy));
      }
    } else if (local) {
      for (int t = 0; t < n; ++t) {
        const float4 r4 = ld4(&st.r[t][tl.m4]), w4 = ld4(&st.w[t][tl.m4]);
        const float rm[4] = {r4.x, r4.y, r4.z, r4.w};
        const float wm[4] = {w4.x, w4.y, w4.z, w4.w};
        float coef[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          coef[m] = wrun[m] * rm[m];
          wrun[m] *= wm[m];
        }
#pragma unroll
        for (int hq = 0; hq < 2; ++hq) {
          const float4 d4 = ld4(&st.dy[t][hq ? tl.hi : tl.lo]);
          const float dj[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
          for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              x[m][4 * hq + e] = fmaf(coef[m], dj[e], x[m][4 * hq + e]);
        }
      }
    }
  }
  if (role == 0 && c == nc - 1) {
    // a_end = <dS, S_end> on each row, for K's suffix in the last chunk
    float acc[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float d[8];
      ld_row(d, ds + (b * H + h) * kState + (tl.m4 + m) * kHead, tl);
      acc[m] = 0.f;
#pragma unroll
      for (int p = 0; p < 8; ++p) acc[m] = fmaf(d[p], x[m][p], acc[m]);
    }
    const float a = tile_sum(acc, lane);
    if ((lane & 1) == 0) out.dupart[slot * kHead + io] = a;
  }
  if (local) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float* dst = lam + slot * kState + (tl.m4 + m) * kHead;
      st4(dst + tl.lo, x[m]);
      st4(dst + tl.hi, x[m] + 4);
    }
    if ((lane & 7) == 0) st4(wprod + slot * kHead + tl.m4, wrun);
  }
#ifdef WKV_BWD_NO_STORES
  if (role == 0) put[(size_t)t0 * stride] = sink;
#endif
}

// Launch 2: grid (kState / kCarryThreads, H, B).  Slot c's lam_loc[c] is
// replaced by lam_end[c] (slot nc - 1 by dS, slot 0, which held nothing,
// by lam_end[0]).
__global__ void __launch_bounds__(kCarryThreads)
wkv6_bwd_carry_kernel(const float* __restrict__ ds, float* __restrict__ lam,
                      const float* __restrict__ wprod, int H, int nc) {
  constexpr int kBatch = 8;
  const int e = blockIdx.x * kCarryThreads + threadIdx.x;
  const int i = e / kHead;
  const size_t head = (size_t)blockIdx.z * H + blockIdx.y;
  float x = ds[head * kState + e];
  float* sc = lam + head * nc * kState + e;
  const float* wp = wprod + head * nc * kHead + i;
  for (int c0 = nc - 1; c0 >= 1; c0 -= kBatch) {
    float loc[kBatch], wv[kBatch];
#pragma unroll
    for (int m = 0; m < kBatch; ++m)
      if (c0 - m >= 1) {
        loc[m] = sc[(size_t)(c0 - m) * kState];
        wv[m] = wp[(size_t)(c0 - m) * kHead];
      }
#pragma unroll
    for (int m = 0; m < kBatch; ++m)
      if (c0 - m >= 1) {
        sc[(size_t)(c0 - m) * kState] = x;
        x = fmaf(wv[m], x, loc[m]);
      }
  }
  sc[0] = x;
}

// Launch 3: grid (nc, H, B).  Threads 0-127 K (a row tile), 128-255 V (a
// column tile).  lam_end: slot (b, h, c) of (B, H, nc, 64, 64); s_in the
// forward's states (chunk c < nc - 1 ends in S_in[c + 1]).
__global__ void __launch_bounds__(kThreads, 2)
wkv6_bwd_bwd_kernel(Inputs in, Outputs out, const float* __restrict__ s_in,
                    const float* __restrict__ lam_end, int S, int H, int L,
                    int nc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<true>& sm = *reinterpret_cast<Smem<true>*>(smem_raw);
  const int c = blockIdx.x, h = blockIdx.y;
  const size_t b = blockIdx.z;
  const size_t slot = (b * H + h) * nc + c;
  const size_t stride = (size_t)H * kHead;
  const int role = threadIdx.x / kRole, rt = threadIdx.x % kRole;
  const int lane = rt & 31;
  const Tile tl = tile(rt);
  const int io = tl.m4 + own(lane);     // K: the row it stores, V: column
  if (threadIdx.x < kHead)
    sm.u[threadIdx.x] = in.u[(size_t)h * kHead + threadIdx.x];
  const int t0 = c * L, t1 = min(S, t0 + L);
  const size_t base = (b * S * H + h) * kHead;
  auto tok = [&](int t) { return base + (size_t)t * stride; };
  const float* le = lam_end + slot * kState;
  float x[4][8];
  float a = 0.f, du = 0.f, sink = 0.f;
  if (role == 0) {
    const bool inner = c < nc - 1;
    const float* sn = s_in + (inner ? slot + 1 : slot) * kState;
    float acc[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      ld_row(x[m], le + (tl.m4 + m) * kHead, tl);
      acc[m] = 0.f;
      if (inner) {
        float sv[8];
        ld_row(sv, sn + (tl.m4 + m) * kHead, tl);
#pragma unroll
        for (int p = 0; p < 8; ++p) acc[m] = fmaf(x[m][p], sv[p], acc[m]);
      }
    }
    const float ai = tile_sum(acc, lane);
    a = inner ? ai : out.dupart[slot * kHead + io];    // the last: from R
#ifdef WKV_BWD_FAULT_NO_AEND
    a = 0.f;
#endif
  } else {
    // x[n][p]: column m4 + n, the tile's row p
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int row = p < 4 ? tl.lo + p : tl.hi + p - 4;
      const float4 v = ld4(le + row * kHead + tl.m4);
      x[0][p] = v.x; x[1][p] = v.y; x[2][p] = v.z; x[3][p] = v.w;
    }
  }
  const float uo = in.u[(size_t)h * kHead + io];
  // K stores dk (even lanes) or dlogw (odd) of row io, V (even lanes) dv
  // of column io
  float* const put = (role ? out.dv : (lane & 1) ? out.dlogw : out.dk) +
                     base + io;
  const int n_st = (t1 - t0 + kStage - 1) / kStage;
  {
    int s, n;
    stage_range(0, t0, t1, true, s, n);
    issue_stage(sm.st[0], in, out.dlogw, tok(s), stride, n);
  }
  for (int si = 0; si < n_st; ++si) {
    Stage<true>& st = sm.st[si & 1];
    cp_async_wait_all();
    __syncthreads();   // stage si landed; the other buffer is free
    if (si + 1 < n_st) {
      int s, n;
      stage_range(si + 1, t0, t1, true, s, n);
      issue_stage(sm.st[(si + 1) & 1], in, out.dlogw, tok(s), stride, n);
    }
    int s, n;
    stage_range(si, t0, t1, true, s, n);
    stage_dots<true, true>(st, sm.u, n);
    __syncthreads();   // the dots are visible
    if (role == 0) {
      for (int t = n - 1; t >= 0; --t) {
        const float4 r4 = ld4(&st.r[t][tl.m4]), w4 = ld4(&st.w[t][tl.m4]);
        const float rm[4] = {r4.x, r4.y, r4.z, r4.w};
        const float wm[4] = {w4.x, w4.y, w4.z, w4.w};
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int hq = 0; hq < 2; ++hq) {
          const float4 v4 = ld4(&st.v[t][hq ? tl.hi : tl.lo]);
          const float4 d4 = ld4(&st.dy[t][hq ? tl.hi : tl.lo]);
          const float vj[4] = {v4.x, v4.y, v4.z, v4.w};
          const float dj[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
          for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float& lx = x[m][4 * hq + e];
              acc[m] = fmaf(lx, vj[e], acc[m]);
              lx = fmaf(wm[m], lx, rm[m] * dj[e]);
            }
        }
        const float lv = tile_sum(acc, lane);
        const float ko = st.k[t][io], ro = st.r[t][io], dyv = st.dyv[t];
        a -= ko * lv;
        WKV_PUT(put[(size_t)(s + t) * stride],
                (lane & 1) ? a : fmaf(ro * uo, dyv, lv));
        a += st.q[t][io];
        du = fmaf(ro * ko, dyv, du);
      }
    } else {
      for (int t = n - 1; t >= 0; --t) {
        const float4 d4 = ld4(&st.dy[t][tl.m4]);
        const float dn[4] = {d4.x, d4.y, d4.z, d4.w};
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int hq = 0; hq < 2; ++hq) {
          const int row = hq ? tl.hi : tl.lo;
          const float4 k4 = ld4(&st.k[t][row]), w4 = ld4(&st.w[t][row]);
          const float4 r4 = ld4(&st.r[t][row]);
          const float kp[4] = {k4.x, k4.y, k4.z, k4.w};
          const float wp[4] = {w4.x, w4.y, w4.z, w4.w};
          const float rp[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
          for (int n2 = 0; n2 < 4; ++n2)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float& lx = x[n2][4 * hq + e];
              acc[n2] = fmaf(lx, kp[e], acc[n2]);
              lx = fmaf(wp[e], lx, rp[e] * dn[n2]);
            }
        }
        const float sum = tile_sum(acc, lane);
        if ((lane & 1) == 0)
          WKV_PUT(put[(size_t)(s + t) * stride],
                  fmaf(st.bon[t], st.dy[t][io], sum));
      }
    }
  }
  if (role == 0) {
    if ((lane & 1) == 0) out.dupart[slot * kHead + io] = du;
    if (c == 0) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float* d0 = out.ds0 + (b * H + h) * kState + (tl.m4 + m) * kHead;
        st4(d0 + tl.lo, x[m]);
        st4(d0 + tl.hi, x[m] + 4);
      }
    }
  }
#ifdef WKV_BWD_NO_STORES
  put[(size_t)t0 * stride] = sink;
#endif
}

// Launch 4: grid (H).  du_i = sum over rows b, then chunks c, of the K
// CTAs' shares.
__global__ void __launch_bounds__(kHead)
wkv6_bwd_du_kernel(const float* __restrict__ dupart, float* __restrict__ du,
                   int B, int H, int nc) {
  const int h = blockIdx.x, i = threadIdx.x;
  float s = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < nc; ++c)
      s += dupart[(((size_t)b * H + h) * nc + c) * kHead + i];
  du[(size_t)h * kHead + i] = s;
}

}  // namespace

// All float32, contiguous and 16-byte aligned; head width 64.  L: the
// forward's chunk length (S_in has nc = ceil(S / L) slots, or 1 when S <=
// L).  lam (B, H, nc, 64, 64) and wprod (B, H, nc, 64): scratch, unused
// (null) when nc = 1, where lam is dS itself; dupart (B, H, nc, 64).
extern "C" int launch_wkv6_bwd(const void* r, const void* k, const void* v,
                               const void* w, const void* u,
                               const void* s_in, const void* dy,
                               const void* ds, void* dr, void* dk, void* dv,
                               void* dlogw, void* du, void* ds0, void* lam,
                               void* wprod, void* dupart, int B, int S,
                               int H, int hd, int L, void* stream) {
  if (hd != kHead || B <= 0 || S <= 0 || H <= 0 || B > 65535 ||
      H > 65535 || L <= 0 || L % kStage != 0)
    return (int)cudaErrorInvalidValue;
  const int nc = S <= L ? 1 : (S + L - 1) / L;
  if (nc > 1 && (lam == nullptr || wprod == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Inputs in{static_cast<const float*>(r), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(w),
                  static_cast<const float*>(dy),
                  static_cast<const float*>(u)};
  const Outputs out{static_cast<float*>(dr),    static_cast<float*>(dk),
                    static_cast<float*>(dv),    static_cast<float*>(dlogw),
                    static_cast<float*>(ds0), static_cast<float*>(dupart)};
  const auto* dsf = static_cast<const float*>(ds);
  const auto* sin = static_cast<const float*>(s_in);
  auto* lf = static_cast<float*>(lam);
  auto* wp = static_cast<float*>(wprod);
  constexpr int smem_fwd = sizeof(Smem<false>);
  constexpr int smem_bwd = sizeof(Smem<true>);
  cudaError_t e = cudaFuncSetAttribute(
      wkv6_bwd_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_fwd);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wkv6_bwd_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bwd);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(nc, H, B);
  const int Lc = nc == 1 ? S : L;
  wkv6_bwd_fwd_kernel<<<grid, kThreads, smem_fwd, st>>>(
      in, out, sin, dsf, lf, wp, S, H, Lc, nc);
  if (nc > 1)
    wkv6_bwd_carry_kernel<<<dim3(kState / kCarryThreads, H, B),
                            kCarryThreads, 0, st>>>(dsf, lf, wp, H, nc);
  wkv6_bwd_bwd_kernel<<<grid, kThreads, smem_bwd, st>>>(
      in, out, sin, nc > 1 ? lf : dsf, S, H, Lc, nc);
  wkv6_bwd_du_kernel<<<H, kHead, 0, st>>>(static_cast<const float*>(dupart),
                                         static_cast<float*>(du), B, H, nc);
  return (int)cudaGetLastError();
}
