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
// where P_t = k_t (lam_{t+1} v_t), the k-term dk's pass forms, and Q_t =
// r_t (S_t dy_t), the r-term dr's pass forms.
//
// What bounds it: bytes.  Per (token, head) it reads r, k, v, w and dy and
// writes dr, dk, dv and dlogw, 2,304 bytes (0.180 ms at B 2 x 4,096 and 32
// heads at 3.35 TB/s), against at least 9 float32 operations per (i, j)
// (dr's, dk's and dv's multiply-adds and lam's multiply and multiply-add,
// 0.144 ms at 67 TFLOP/s).
//
// Design: the forward's time chunks run in reverse, since lam_t =
// diag(w_t) lam_{t+1} + r_t dy_t^T is linear in lam_{t+1}.  Chunks are
// the forward's (the same L, so S_in[c] is the state at chunk c's start):
//   1. local  (row, head, chunk c >= 1): lam walked back from zero at the
//      chunk's end to its start, lam_loc[c], and the chunk's decay product
//      W[c]_i, into the wrapper's scratch.
//   2. carry  (row, head, 256 state values): lam_end[nc-1] = dS,
//      lam_end[c-1] = W[c]_i lam_end[c]_ij + lam_loc[c]_ij, in place.
//   3. emit   (row, head, chunk, role), two CTAs a chunk:
//      rows   (thread i keeps row i): S recomputed forward from S_in[c],
//             writing dr and Q_t (parked in dlogw's slot); then a =
//             <lam_end[c], S_end>_i, the only cross-chunk term of the
//             decay's sum, since S_end is the chunk's own last state; then
//             lam walked back from lam_end[c], writing dk and dlogw (Q read
//             back), and the chunk's share of du; chunk 0 writes dS0.
//      cols   (thread j keeps column j): lam walked back from lam_end[c],
//             writing dv (its sum runs over i, across the rows' threads).
//   4. du     (head): the shares summed over rows and chunks in a fixed
//             order, so the kernel is deterministic.
// A window of one chunk is launches 3 and 4 from S0 and dS.  Each thread
// keeps 64 state values in registers; the tokens come kStage at a time
// through shared memory, read as float4 broadcasts.  A simple first
// design: the rows' CTA walks the chunk twice while the columns' walks it
// once, and the loads are not overlapped with the walks.
#include "common.cuh"

namespace {

constexpr int kHead = 64;
constexpr int kState = kHead * kHead;
constexpr int kStage = 16;          // tokens staged per pass
constexpr int kThreads = 64;        // one per state row (or column)
constexpr int kCarryThreads = 256;  // state values per carry CTA
constexpr int kQuads = kHead / 4;

struct Inputs {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* dy;
  const float* u;
};

// kStage tokens of one (row, head), float32, and per token dy . v and
// sum_i r_i u_i k_i; the head's u.
struct Tokens {
  __align__(16) float r[kStage][kHead];
  __align__(16) float k[kStage][kHead];
  __align__(16) float v[kStage][kHead];
  __align__(16) float w[kStage][kHead];
  __align__(16) float dy[kStage][kHead];
  float u[kHead];
  float dyv[kStage];
  float bon[kStage];
};

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

// Tokens [t, t + n) of (row b, head h) into sm (the caller has synced
// since sm was last read); with kDots also their dy . v and bonus sums, 4
// threads a token over 16 channels each, in a fixed order.  Returns
// synced.
template <bool kDots>
__device__ __forceinline__ void load_tokens(Tokens& sm, const Inputs& in,
                                            size_t off, size_t stride,
                                            int n) {
  for (int p = threadIdx.x; p < n * kQuads; p += kThreads) {
    const int t = p / kQuads, e = (p % kQuads) * 4;
    const size_t g = off + t * stride + e;
    copy4(&sm.r[t][e], in.r + g);
    copy4(&sm.k[t][e], in.k + g);
    copy4(&sm.v[t][e], in.v + g);
    copy4(&sm.w[t][e], in.w + g);
    copy4(&sm.dy[t][e], in.dy + g);
  }
  __syncthreads();
  if constexpr (kDots) {
    static_assert(kThreads == 4 * kStage, "4 threads a staged token");
    const int t = threadIdx.x >> 2, q = (threadIdx.x & 3) * (kHead / 4);
    float a = 0.f, c = 0.f;
    if (t < n) {
#pragma unroll
      for (int e = q; e < q + kHead / 4; ++e) {
        a = fmaf(sm.dy[t][e], sm.v[t][e], a);
        c = fmaf(sm.r[t][e] * sm.u[e], sm.k[t][e], c);
      }
    }
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    c += __shfl_xor_sync(0xffffffffu, c, 1);
    a += __shfl_xor_sync(0xffffffffu, a, 2);
    c += __shfl_xor_sync(0xffffffffu, c, 2);
    if ((threadIdx.x & 3) == 0 && t < n) {
      sm.dyv[t] = a;
      sm.bon[t] = c;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float sum4(const float (&a)[4]) {
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// One token's lam update in a thread that keeps row i of lam (lr[j]):
// returns sum_j lam_ij v_j before it; lam_ij = w_i lam_ij + r_i dy_j.
__device__ __forceinline__ float row_step(float (&lr)[kHead],
                                          const Tokens& sm, int t, float wi,
                                          float ri) {
  const float4* v4 = reinterpret_cast<const float4*>(sm.v[t]);
  const float4* d4 = reinterpret_cast<const float4*>(sm.dy[t]);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < kQuads; ++c) {
    const float4 vv = v4[c], dd = d4[c];
    const float vj[4] = {vv.x, vv.y, vv.z, vv.w};
    const float dj[4] = {dd.x, dd.y, dd.z, dd.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = lr[4 * c + e];
      acc[e] = fmaf(x, vj[e], acc[e]);
      x = fmaf(wi, x, ri * dj[e]);
    }
  }
  return sum4(acc);
}

// Launch 1: grid (nc - 1, H, B), chunk c = blockIdx.x + 1.  Thread j
// keeps column j of lam, walked back from zero through the chunk, and
// the product of channel j's decays.
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_local_kernel(Inputs in, float* __restrict__ lam,
                      float* __restrict__ wprod, int S, int H, int L,
                      int nc) {
  __shared__ Tokens sm;
  const int c = blockIdx.x + 1, h = blockIdx.y, j = threadIdx.x;
  const size_t b = blockIdx.z, slot = (b * H + h) * nc + c;
  const size_t stride = (size_t)H * kHead;
  float lc[kHead];
#pragma unroll
  for (int i = 0; i < kHead; ++i) lc[i] = 0.f;
  float wp = 1.f;
  const int t0 = c * L, t1 = min(S, t0 + L);
  for (int end = t1; end > t0; end -= kStage) {
    const int s = max(t0, end - kStage), n = end - s;
    __syncthreads();
    load_tokens<false>(sm, in, ((b * S + s) * H + h) * kHead, stride, n);
    for (int t = n - 1; t >= 0; --t) {
      const float dyj = sm.dy[t][j];
      wp *= sm.w[t][j];
      const float4* r4 = reinterpret_cast<const float4*>(sm.r[t]);
      const float4* w4 = reinterpret_cast<const float4*>(sm.w[t]);
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const float4 rr = r4[q], ww = w4[q];
        lc[4 * q] = fmaf(ww.x, lc[4 * q], rr.x * dyj);
        lc[4 * q + 1] = fmaf(ww.y, lc[4 * q + 1], rr.y * dyj);
        lc[4 * q + 2] = fmaf(ww.z, lc[4 * q + 2], rr.z * dyj);
        lc[4 * q + 3] = fmaf(ww.w, lc[4 * q + 3], rr.w * dyj);
      }
    }
  }
  float* out = lam + slot * kState + j;
#pragma unroll
  for (int i = 0; i < kHead; ++i) out[i * kHead] = lc[i];
  wprod[slot * kHead + j] = wp;
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

struct Outputs {
  float* dr;
  float* dk;
  float* dv;
  float* dlogw;
  float* ds0;
  float* dupart;
};

// Launch 3, the rows' CTA of (row b, head h, chunk c).
__device__ __forceinline__ void emit_rows(
    Tokens& sm, const Inputs& in, const Outputs& out,
    const float* __restrict__ s_in, const float* __restrict__ lam_end,
    size_t b, int h, int c, int S, int H, int t0, int t1, size_t slot) {
  const int i = threadIdx.x;
  const size_t stride = (size_t)H * kHead;
  auto tok = [&](int t) { return ((b * S + t) * H + h) * kHead; };
  float sr[kHead];
  const float* src = s_in + slot * kState + i * kHead;
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const float4 x = reinterpret_cast<const float4*>(src)[q];
    sr[4 * q] = x.x;
    sr[4 * q + 1] = x.y;
    sr[4 * q + 2] = x.z;
    sr[4 * q + 3] = x.w;
  }
  const float ui = sm.u[i];
  // forward: dr and Q from the states before each token
  for (int s = t0; s < t1; s += kStage) {
    const int n = min(kStage, t1 - s);
    __syncthreads();
    load_tokens<true>(sm, in, tok(s), stride, n);
    for (int t = 0; t < n; ++t) {
      const float ki = sm.k[t][i], wi = sm.w[t][i], ri = sm.r[t][i];
      const float4* v4 = reinterpret_cast<const float4*>(sm.v[t]);
      const float4* d4 = reinterpret_cast<const float4*>(sm.dy[t]);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const float4 vv = v4[q], dd = d4[q];
        const float vj[4] = {vv.x, vv.y, vv.z, vv.w};
        const float dj[4] = {dd.x, dd.y, dd.z, dd.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = sr[4 * q + e];
          acc[e] = fmaf(x, dj[e], acc[e]);
          x = fmaf(wi, x, ki * vj[e]);
        }
      }
      const float sdy = sum4(acc);
      const size_t o = tok(s + t) + i;
      out.dr[o] = fmaf(ui * ki, sm.dyv[t], sdy);
      out.dlogw[o] = ri * sdy;             // Q_t, read back below
    }
  }
  // a = <lam_end, S_end> on row i; lam_end replaces S in the registers
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const float* le = lam_end + slot * kState + i * kHead;
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const float4 x = reinterpret_cast<const float4*>(le)[q];
    const float lx[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[e] = fmaf(lx[e], sr[4 * q + e], acc[e]);
      sr[4 * q + e] = lx[e];
    }
  }
  float a = sum4(acc);
  float du = 0.f;
  // backward: dk, dlogw and du
  for (int end = t1; end > t0; end -= kStage) {
    const int s = max(t0, end - kStage), n = end - s;
    __syncthreads();
    load_tokens<true>(sm, in, tok(s), stride, n);
    for (int t = n - 1; t >= 0; --t) {
      const float ki = sm.k[t][i], wi = sm.w[t][i], ri = sm.r[t][i];
      const float dyv = sm.dyv[t];
      const float lv = row_step(sr, sm, t, wi, ri);
      const size_t o = tok(s + t) + i;
      out.dk[o] = fmaf(ri * ui, dyv, lv);
      const float p = ki * lv, qq = out.dlogw[o];
      a -= p;
      out.dlogw[o] = a;
      a += qq;
      du = fmaf(ri * ki, dyv, du);
    }
  }
  if (c == 0) {
    float* d0 = out.ds0 + (b * H + h) * kState + i * kHead;
#pragma unroll
    for (int q = 0; q < kQuads; ++q)
      reinterpret_cast<float4*>(d0)[q] =
          make_float4(sr[4 * q], sr[4 * q + 1], sr[4 * q + 2],
                      sr[4 * q + 3]);
  }
  out.dupart[slot * kHead + i] = du;
}

// Launch 3, the columns' CTA: dv.
__device__ __forceinline__ void emit_cols(
    Tokens& sm, const Inputs& in, const Outputs& out,
    const float* __restrict__ lam_end, size_t b, int h, int S, int H, int t0,
    int t1, size_t slot) {
  const int j = threadIdx.x;
  const size_t stride = (size_t)H * kHead;
  auto tok = [&](int t) { return ((b * S + t) * H + h) * kHead; };
  float lc[kHead];
  const float* le = lam_end + slot * kState + j;
#pragma unroll
  for (int i = 0; i < kHead; ++i) lc[i] = le[i * kHead];
  for (int end = t1; end > t0; end -= kStage) {
    const int s = max(t0, end - kStage), n = end - s;
    __syncthreads();
    load_tokens<true>(sm, in, tok(s), stride, n);
    for (int t = n - 1; t >= 0; --t) {
      const float dyj = sm.dy[t][j];
      const float4* k4 = reinterpret_cast<const float4*>(sm.k[t]);
      const float4* w4 = reinterpret_cast<const float4*>(sm.w[t]);
      const float4* r4 = reinterpret_cast<const float4*>(sm.r[t]);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const float4 kk = k4[q], ww = w4[q], rr = r4[q];
        const float ki[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wi[4] = {ww.x, ww.y, ww.z, ww.w};
        const float ri[4] = {rr.x, rr.y, rr.z, rr.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = lc[4 * q + e];
          acc[e] = fmaf(x, ki[e], acc[e]);
          x = fmaf(wi[e], x, ri[e] * dyj);
        }
      }
      out.dv[tok(s + t) + j] = fmaf(sm.bon[t], dyj, sum4(acc));
    }
  }
}

// Launch 3: grid (nc, H, 2 B); blockIdx.z = 2 b + role (0 rows, 1
// columns).  s_in and lam_end: slot (b, h, c) of (B, H, nc, 64, 64).
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_emit_kernel(Inputs in, Outputs out, const float* __restrict__ s_in,
                     const float* __restrict__ lam_end, int S, int H, int L,
                     int nc) {
  __shared__ Tokens sm;
  const int c = blockIdx.x, h = blockIdx.y;
  const size_t b = blockIdx.z >> 1;
  const size_t slot = (b * H + h) * nc + c;
  sm.u[threadIdx.x] = in.u[(size_t)h * kHead + threadIdx.x];
  const int t0 = c * L, t1 = min(S, t0 + L);
  if (blockIdx.z & 1)
    emit_cols(sm, in, out, lam_end, b, h, S, H, t0, t1, slot);
  else
    emit_rows(sm, in, out, s_in, lam_end, b, h, c, S, H, t0, t1, slot);
}

// Launch 4: grid (H).  du_i = sum over rows b, then chunks c, of the
// rows' CTAs' shares.
__global__ void __launch_bounds__(kThreads)
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
  if (hd != kHead || B <= 0 || S <= 0 || H <= 0 || 2 * B > 65535 ||
      H > 65535 || L <= 0 || L % kStage != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = S <= L ? 1 : (S + L - 1) / L;
  const Inputs in{static_cast<const float*>(r), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(w),
                  static_cast<const float*>(dy),
                  static_cast<const float*>(u)};
  const Outputs out{static_cast<float*>(dr),    static_cast<float*>(dk),
                    static_cast<float*>(dv),    static_cast<float*>(dlogw),
                    static_cast<float*>(ds0), static_cast<float*>(dupart)};
  const auto* dsf = static_cast<const float*>(ds);
  const float* lam_end = dsf;
  if (nc > 1) {
    if (lam == nullptr || wprod == nullptr) return (int)cudaErrorInvalidValue;
    auto* lf = static_cast<float*>(lam);
    auto* wp = static_cast<float*>(wprod);
    wkv6_bwd_local_kernel<<<dim3(nc - 1, H, B), kThreads, 0, st>>>(
        in, lf, wp, S, H, L, nc);
    wkv6_bwd_carry_kernel<<<dim3(kState / kCarryThreads, H, B),
                            kCarryThreads, 0, st>>>(dsf, lf, wp, H, nc);
    lam_end = lf;
  }
  wkv6_bwd_emit_kernel<<<dim3(nc, H, 2 * B), kThreads, 0, st>>>(
      in, out, static_cast<const float*>(s_in), lam_end, S, H,
      nc == 1 ? S : L, nc);
  wkv6_bwd_du_kernel<<<H, kThreads, 0, st>>>(static_cast<const float*>(dupart),
                                            static_cast<float*>(du), B, H,
                                            nc);
  return (int)cudaGetLastError();
}
