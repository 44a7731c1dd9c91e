// WKV recurrence (the RWKV6 time-mix's matrix-state scan) for Hopper.
//
// Replaces no Pallas kernel: the reference runs the recurrence as a
// jax.lax.scan over tokens, `_wkv_step` under `rwkv_time_mix` in
// src/repro/models/rwkv6.py:93 and :135-140.  A loop over tokens in PyTorch
// would launch some five kernels a token in every layer (about 1.97 M for a
// 16,384-token window over 24 layers), so the port computes the scan's
// function in at most three launches, prefill window and decode step alike:
//
//   r, k, v (B, S, H, 64) bf16; w (B, S, H, 64), u (H, 64) and
//   S0 (B, H, 64, 64) float32
//   per token, kv_ij = k_i v_j:
//     y_j = sum_i r_i (S_ij + u_i kv_ij),   S_ij = w_i S_ij + kv_ij
//   -> y (B, S, H, 64) float32, S after token S-1 (B, H, 64, 64) float32
//
// r, k and v widened to float32.  A padded position arrives with k = 0
// and w = 1, which leave S as it was, so no mask is needed, and with
// trailing padding the final state is the state after the row's last valid
// token.  S = 1 is the decode step.
//
// What bounds it: operations.  Per (token, head) it reads r, k and v (64
// bf16 values each) and w (64 float32) and writes y (64 float32), 896
// bytes.  The function needs 5 float32 operations per (i, j): the bonus
// term is a scalar per token, y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i,
// so y costs one multiply-add per (i, j), and the update w_i S_ij +
// k_i v_j a multiply and a multiply-add; 20,480 operations (plus 5 per
// channel) at 67 TFLOP/s take longer than 896 bytes at 3.35 TB/s.
//
// Why time chunks: the recurrence is sequential in t, and one row of one
// head is 4,096 state values, so a one-row prefill window walked token by
// token is only H = 32 CTAs on 132 SMs.  The update is linear in S, so the
// window is cut into chunks of L tokens (the wrapper picks L from the
// grid, ops.wkv6_chunk: about 8 one-warp CTAs an SM, one wave, L = 512 at
// B 1, S 16,384) and run in three launches:
//   1. local   (row, head, chunk c < last): the chunk's recurrence from a
//      zero state, no y; its end state S_loc[c] and the product of its
//      decays W[c]_i = prod_t w_ti go to scratch (the wrapper's).
//   2. carry   (row, head, 256 state values): S_in[0] = S0, S_in[c+1] =
//      W[c]_i S_in[c]_ij + S_loc[c]_ij, in place over S_loc (4,096
//      multiply-adds a chunk).
//   3. emit    (row, head, chunk): the chunk rerun from S_in[c], writing y;
//      the last chunk's CTA writes the final state.
// A window of at most one chunk is launch 3 alone, from S0; the decode
// step (S = 1) has a kernel of its own (wkv6_step_kernel).  The chunked
// form does 8 operations per (token, i, j) where the function needs 5
// (launch 1 repeats the update), so its own floor is 1.6x the bound.
//
// Why float32, and the numbers: the arithmetic stays float32 fused
// multiply-adds (bf16 or TF32 tensor-core tiles would miss the 2^-14 bar
// below by orders of magnitude).  The carry forms each chunk's decay
// product once (L roundings, as the token walk applies the same factors
// one by one) and adds one rounding per (chunk, i, j) to the state; both
// are damped by every later decay (w <= 1), so the state's error stays
// within a few float32 steps of its magnitude, as the token walk's does,
// under chip_smoke.py's bar of 2^-14 of the plain version on the inputs'
// magnitudes (WKV_RTOL).
//
// Design of launches 1 and 3: a CTA of one warp per (row, head, chunk).
// Each thread keeps 2 state columns (j, j + 32) in registers, so y_j needs
// no cross-thread sum and each broadcast shared load of r_i, k_i, w_i
// feeds 2 columns (with one column a thread, one broadcast load a
// float4 fed 12 instructions, and those loads bound the loop).  The
// chunk's tokens
// come kStage at a time: the next stage's r, k, v and w are copied with
// cp.async into a raw buffer while the current stage is computed from a
// float32 working copy, which each thread fills for its own columns after
// the copy lands.  While it fills it, each thread forms r_j u_j k_j for
// the stage's tokens and the warps sum them (a transposing butterfly, 16
// shuffles a stage), so launch 3's inner loop spends 3 instructions per
// (i, j): r S into four partial sums, k v, and w S + k v.  Launch 1's
// spends 2.
//
// Training's forward (launch_wkv6_f32, "kernel A") is a second template
// instance of launches 1-3: r, k and v arrive in float32 (the reference
// trains in float32, and so do the port's weights, so the training path
// casts nothing), and the carries' S_in[c] stay in the caller's scratch
// for the backward (csrc/wkv6_bwd.cu).  Its bytes bind: 1,280 a (token,
// head) against the serve's 896, 0.100 ms at B 2 x 4,096 and 32 heads
// against 0.080 ms for its operations.  The bf16 instances keep their
// code.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kHead = 64;     // head width
constexpr int kThreads = 32;  // launches 1 and 3: one warp
constexpr int kCols = kHead / kThreads;   // state columns a thread keeps
constexpr int kStage = 16;    // tokens staged per pass
constexpr int kState = kHead * kHead;
constexpr int kCarryThreads = 256;   // state values per carry CTA

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

// kEmit: launch 3 (reads r, writes y); else launch 1 (k, v, w only).
// T: r, k and v as they arrive, bf16 (the serve) or float32 (training).
template <bool kEmit, typename T>
struct Stage {
  static constexpr int kR = kEmit ? kStage : 1;
  // raw, as cp.async lands it
  __align__(16) T r[kR][kHead];
  __align__(16) T k[kStage][kHead];
  __align__(16) T v[kStage][kHead];
  __align__(16) float w[kStage][kHead];
  // the float32 working copy of the stage being computed
  __align__(16) float rf[kR][kHead];
  __align__(16) float kf[kStage][kHead];
  __align__(16) float wf[kStage][kHead];
  float vf[kStage][kHead];
  float bonus[kStage];         // sum_i r_i u_i k_i
};

// Copy tokens [t0, t0 + n) of one (row, head) into the raw buffer: 16-byte
// pieces, w's 16 per token first, then k's, v's (and r's), kP each (8 of
// bf16, 16 of float32).
template <bool kEmit, typename T>
__device__ __forceinline__ void issue_stage(
    Stage<kEmit, T>& sm, const T* r, const T* k, const T* v, const float* w,
    size_t off, size_t stride, int n) {
  constexpr int kPer = 16 / sizeof(T);        // values a piece
  constexpr int kP = kHead / kPer;            // pieces of one token's r, k, v
  constexpr int kPieces = 16 + (kEmit ? 3 : 2) * kP;
  for (int p = threadIdx.x; p < n * kPieces; p += kThreads) {
    const int t = p / kPieces;
    int q = p % kPieces;
    const size_t src = off + t * stride;
    if (q < 16) {
      cp_async16(&sm.w[t][q * 4], w + src + q * 4);
      continue;
    }
    q -= 16;
    const int e = (q % kP) * kPer;
    if (q < kP)
      cp_async16(&sm.k[t][e], k + src + e);
    else if (q < 2 * kP)
      cp_async16(&sm.v[t][e], v + src + e);
    else
      cp_async16(&sm.r[t % Stage<kEmit, T>::kR][e], r + src + e);
  }
  cp_async_commit();
}

// Sums each of v[0..15] over the warp.  Returns, in lane l, the sum of
// v[tok] with tok = 8 b4 + 4 b3 + 2 b2 + b1 (b_n bit n of l): each round
// halves the values a lane holds, keeping the half its bit selects.
__device__ __forceinline__ float transpose_sum16(float (&v)[kStage],
                                                 int lane) {
  static_assert(kStage == 16, "the butterfly folds 16 tokens over 32 lanes");
#pragma unroll
  for (int round = 0; round < 4; ++round) {
    const int half = (kStage / 2) >> round, off = 16 >> round;
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

// One (row, head, chunk): tokens [t_begin, t_end), from the state at s_in
// ((i, j) row-major; nullptr: zero), left in st (st[cc][i] = S[i][j],
// j = lane + 32 cc).  The first stage is in flight while the state loads.
template <bool kEmit, typename T>
__device__ __forceinline__ void run_chunk(
    Stage<kEmit, T>& sm, float (&st)[kCols][kHead], float (&wprod)[kCols],
    const float* __restrict__ s_in, const T* __restrict__ r,
    const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    float* __restrict__ y, size_t b, int h, int H, int S, int t_begin,
    int t_end) {
  const int lane = threadIdx.x;
  const size_t stride = (size_t)H * kHead;
  auto tok_off = [&](int t) { return ((b * S + t) * H + h) * kHead; };
  if (t_begin < t_end)
    issue_stage(sm, r, k, v, w, tok_off(t_begin), stride,
                min(kStage, t_end - t_begin));
  float uj[kCols];
#pragma unroll
  for (int cc = 0; cc < kCols; ++cc) {
    const int j = lane + cc * kThreads;
    uj[cc] = kEmit ? u[(size_t)h * kHead + j] : 0.f;
#pragma unroll
    for (int i = 0; i < kHead; ++i)
      st[cc][i] = s_in != nullptr ? s_in[i * kHead + j] : 0.f;
  }
  for (int t0 = t_begin; t0 < t_end; t0 += kStage) {
    const int n_tok = min(kStage, t_end - t0);
    cp_async_wait_all();
    // the stage has landed, and every thread has finished computing the
    // previous one from the working copy
    __syncthreads();
    float p[kStage];
#pragma unroll
    for (int t = 0; t < kStage; ++t) {
      p[t] = 0.f;
      if (t < n_tok) {
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          const int j = lane + cc * kThreads;
          const float kk = to_f32(sm.k[t][j]);
          const float ww = sm.w[t][j];
          sm.kf[t][j] = kk;
          sm.vf[t][j] = to_f32(sm.v[t][j]);
          sm.wf[t][j] = ww;
          if constexpr (kEmit) {
            const float rr = to_f32(sm.r[t][j]);
            sm.rf[t][j] = rr;
            p[t] = fmaf(rr * uj[cc], kk, p[t]);
          } else {
            wprod[cc] *= ww;
          }
        }
      }
    }
    if constexpr (kEmit) {
      const float part = transpose_sum16(p, lane);
      if (!(lane & 1))
        sm.bonus[((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 +
                 ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1)] = part;
    }
    // the working copy is whole and the raw buffer free
    __syncthreads();
    if (t0 + kStage < t_end)
      issue_stage(sm, r, k, v, w, tok_off(t0 + kStage), stride,
                  min(kStage, t_end - t0 - kStage));
    for (int t = 0; t < n_tok; ++t) {
      float vj[kCols];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc)
        vj[cc] = sm.vf[t][lane + cc * kThreads];
      const float4* k4 = reinterpret_cast<const float4*>(sm.kf[t]);
      const float4* w4 = reinterpret_cast<const float4*>(sm.wf[t]);
      if constexpr (kEmit) {
        const float4* r4 = reinterpret_cast<const float4*>(sm.rf[t]);
        float acc[kCols][4] = {};
#pragma unroll
        for (int c = 0; c < kHead / 4; ++c) {
          const float4 rr = r4[c], kk = k4[c], ww = w4[c];
          const float ri[4] = {rr.x, rr.y, rr.z, rr.w};
          const float ki[4] = {kk.x, kk.y, kk.z, kk.w};
          const float wi[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int cc = 0; cc < kCols; ++cc) {
              const int i = 4 * c + e;
              acc[cc][e] = fmaf(ri[e], st[cc][i], acc[cc][e]);
              st[cc][i] = fmaf(wi[e], st[cc][i], ki[e] * vj[cc]);
            }
        }
        float* yt = y + tok_off(t0 + t);
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          yt[lane + cc * kThreads] =
              fmaf(vj[cc], sm.bonus[t],
                   (acc[cc][0] + acc[cc][1]) + (acc[cc][2] + acc[cc][3]));
      } else {
#pragma unroll
        for (int c = 0; c < kHead / 4; ++c) {
          const float4 kk = k4[c], ww = w4[c];
          const float ki[4] = {kk.x, kk.y, kk.z, kk.w};
          const float wi[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int cc = 0; cc < kCols; ++cc) {
              const int i = 4 * c + e;
              st[cc][i] = fmaf(wi[e], st[cc][i], ki[e] * vj[cc]);
            }
        }
      }
    }
  }
}

// Launch 1: grid (chunks - 1, H, B).  Chunk c's end state from a zero
// state into scratch slot c, its decay product into wprod.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_local_kernel(const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ w, float* __restrict__ scratch,
                  float* __restrict__ wprod, int S, int H, int L, int nc) {
  __shared__ Stage<false, T> sm;
  const int c = blockIdx.x, h = blockIdx.y, lane = threadIdx.x;
  const size_t b = blockIdx.z;
  const size_t slot = (b * H + h) * nc + c;
  float st[kCols][kHead];
  float wp[kCols] = {1.f, 1.f};
  const int t_begin = c * L;
  run_chunk<false, T>(sm, st, wp, nullptr, nullptr, k, v, w, nullptr,
                      nullptr, b, h, H, S, t_begin, min(S, t_begin + L));
  float* out = scratch + slot * kState;
#pragma unroll
  for (int cc = 0; cc < kCols; ++cc) {
    const int j = lane + cc * kThreads;
#pragma unroll
    for (int i = 0; i < kHead; ++i) out[i * kHead + j] = st[cc][i];
    wprod[slot * kHead + j] = wp[cc];
  }
}

// Launch 2: grid (kState / kCarryThreads, H, B).  Walks the chunks of one
// (row, head) for kCarryThreads state values, replacing slot c's S_loc[c]
// by S_in[c] (slot nc - 1 held nothing); S_in[0] = S0.
__global__ void __launch_bounds__(kCarryThreads)
wkv6_carry_kernel(const float* __restrict__ s0, float* __restrict__ scratch,
                  const float* __restrict__ wprod, int H, int nc) {
  constexpr int kBatch = 8;
  const int e = blockIdx.x * kCarryThreads + threadIdx.x;
  const int i = e / kHead;
  const size_t head = (size_t)blockIdx.z * H + blockIdx.y;
  float s = s0[head * kState + e];
  float* sc = scratch + head * nc * kState + e;
  const float* wp = wprod + head * nc * kHead + i;
  for (int c0 = 0; c0 < nc - 1; c0 += kBatch) {
    float loc[kBatch], wv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (c0 + u < nc - 1) {
        loc[u] = sc[(size_t)(c0 + u) * kState];
        wv[u] = wp[(size_t)(c0 + u) * kHead];
      }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (c0 + u < nc - 1) {
        sc[(size_t)(c0 + u) * kState] = s;
        s = fmaf(wv[u], s, loc[u]);
      }
  }
  sc[(size_t)(nc - 1) * kState] = s;
}

// Launch 3: grid (nc, H, B).  Chunk c from S_in[c] (s_in slot c: scratch,
// or S0 when nc = 1), writing y; the last chunk writes the final state.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_emit_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s_in,
                 float* __restrict__ y, float* __restrict__ s_out, int S,
                 int H, int L, int nc) {
  __shared__ Stage<true, T> sm;
  const int c = blockIdx.x, h = blockIdx.y, lane = threadIdx.x;
  const size_t b = blockIdx.z;
  const size_t head = b * H + h;
  float st[kCols][kHead];
  float unused[kCols];
  const int t_begin = c * L;
  run_chunk<true, T>(sm, st, unused, s_in + (head * nc + c) * kState, r, k,
                     v, w, u, y, b, h, H, S, t_begin, min(S, t_begin + L));
  if (c == nc - 1) {
    float* out = s_out + head * kState;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
#pragma unroll
      for (int i = 0; i < kHead; ++i)
        out[i * kHead + lane + cc * kThreads] = st[cc][i];
  }
}

// The decode step (S = 1): grid (H, B), 256 threads; thread (g, j), g =
// tid / 64, keeps rows 16 g .. 16 g + 15 of column j, so each thread
// moves 16 of the state's values each way where a thread of launch 3
// moves 64: a step is a read and a write of the state, and its time is
// their latency.  At rwkv6-1.6b's decode launch (B 4, 32 heads) this
// kernel takes 0.0020 device ms and launch 3 alone on the one token
// 0.0037 (`ab_kernels.py --probes`, H100 SXM at 700 W), against 0.0023
// for the single kernel this file replaced, hence a second path.
constexpr int kStepThreads = 256;
constexpr int kStepRows = kState / kStepThreads;     // 16
constexpr int kStepGroups = kHead / kStepRows;        // 4

__global__ void __launch_bounds__(kStepThreads)
wkv6_step_kernel(const __nv_bfloat16* __restrict__ r,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ w, const float* __restrict__ u,
                 const float* __restrict__ s0, float* __restrict__ y,
                 float* __restrict__ s_out, int H) {
  __shared__ float rs[kHead], ks[kHead], vs[kHead], ws[kHead];
  __shared__ float part[kStepGroups][kHead];
  __shared__ float bonus[2];
  const int tid = threadIdx.x, j = tid % kHead, g = tid / kHead;
  const int h = blockIdx.x;
  const size_t head = (size_t)blockIdx.y * H + h;
  const float* sh = s0 + head * kState + (size_t)g * kStepRows * kHead + j;
  float st[kStepRows];
#pragma unroll
  for (int m = 0; m < kStepRows; ++m) st[m] = sh[m * kHead];
  if (tid < kHead) {
    const size_t off = head * kHead + tid;     // token 0 of row b, head h
    const float rr = to_f32(r[off]), kk = to_f32(k[off]);
    rs[tid] = rr;
    ks[tid] = kk;
    vs[tid] = to_f32(v[off]);
    ws[tid] = w[off];
    const float p = warp_sum(rr * u[(size_t)h * kHead + tid] * kk);
    if ((tid & 31) == 0) bonus[tid >> 5] = p;
  }
  __syncthreads();
  const float vj = vs[j];
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int m = 0; m < kStepRows; ++m) {
    const int i = g * kStepRows + m;
    acc[m & 3] = fmaf(rs[i], st[m], acc[m & 3]);
    st[m] = fmaf(ws[i], st[m], ks[i] * vj);
  }
  part[g][j] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  float* so = s_out + head * kState + (size_t)g * kStepRows * kHead + j;
#pragma unroll
  for (int m = 0; m < kStepRows; ++m) so[m * kHead] = st[m];
  __syncthreads();
  if (g == 0)
    y[head * kHead + j] =
        fmaf(vj, bonus[0] + bonus[1],
             (part[0][j] + part[1][j]) + (part[2][j] + part[3][j]));
}

}  // namespace

// The three launches of a window (or launch 3 alone for one chunk);
// r, k and v of type T.  The decode step (S = 1) of the serve's bf16
// instance takes wkv6_step_kernel; the training instance (float32) runs
// every window here.  scratch holds S_in[c] after the call.
template <typename T>
static int launch_window(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* s0, void* y, void* s_out,
                  void* scratch, void* wprod, int B, int S, int H, int hd,
                  int L, void* stream) {
  if (hd != kHead || B < 0 || S < 0 || H <= 0 || B > 65535 || H > 65535 ||
      L <= 0 || L % kStage != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* rb = static_cast<const T*>(r);
  const auto* kb = static_cast<const T*>(k);
  const auto* vb = static_cast<const T*>(v);
  const auto* wf = static_cast<const float*>(w);
  const auto* uf = static_cast<const float*>(u);
  const auto* s0f = static_cast<const float*>(s0);
  auto* yf = static_cast<float*>(y);
  auto* so = static_cast<float*>(s_out);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (S == 1) {
      wkv6_step_kernel<<<dim3(H, B), kStepThreads, 0, st>>>(
          rb, kb, vb, wf, uf, s0f, yf, so, H);
      return (int)cudaGetLastError();
    }
  }
  if (S <= L) {     // one pass from S0
    wkv6_emit_kernel<T><<<dim3(1, H, B), kThreads, 0, st>>>(
        rb, kb, vb, wf, uf, s0f, yf, so, S, H, S, 1);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr || wprod == nullptr)
    return (int)cudaErrorInvalidValue;
  const int nc = (S + L - 1) / L;
  auto* sc = static_cast<float*>(scratch);
  auto* wp = static_cast<float*>(wprod);
  wkv6_local_kernel<T><<<dim3(nc - 1, H, B), kThreads, 0, st>>>(
      kb, vb, wf, sc, wp, S, H, L, nc);
  wkv6_carry_kernel<<<dim3(kState / kCarryThreads, H, B), kCarryThreads, 0,
                      st>>>(s0f, sc, wp, H, nc);
  wkv6_emit_kernel<T><<<dim3(nc, H, B), kThreads, 0, st>>>(
      rb, kb, vb, wf, uf, sc, yf, so, S, H, L, nc);
  return (int)cudaGetLastError();
}

// r, k and v bfloat16; w, u, S0, y and S_out float32; all contiguous and
// 16-byte aligned.  The head width must be 64.  L: the chunk length, a
// multiple of kStage; with L >= S one launch from S0 and no scratch, else
// scratch (B, H, ceil(S / L), 64, 64) and wprod (B, H, ceil(S / L), 64)
// float32.
extern "C" int launch_wkv6(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* y, void* s_out, void* scratch, void* wprod,
                           int B, int S, int H, int hd, int L,
                           void* stream) {
  return launch_window<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, scratch,
                                      wprod, B, S, H, hd, L, stream);
}

// Training's forward (kernel A): launch_wkv6 with float32 r, k and v, the
// reference's training precision, and no decode-step kernel.  The caller
// keeps scratch: after the call slot c holds S_in[c], the state before
// chunk c, which the backward (csrc/wkv6_bwd.cu) reruns each chunk from.
// Per (token, head) it reads 1,280 bytes (r, k, v and w, 64 float32
// each) and writes y's 256.
extern "C" int launch_wkv6_f32(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* s0,
                               void* y, void* s_out, void* scratch,
                               void* wprod, int B, int S, int H, int hd,
                               int L, void* stream) {
  return launch_window<float>(r, k, v, w, u, s0, y, s_out, scratch, wprod,
                              B, S, H, hd, L, stream);
}
