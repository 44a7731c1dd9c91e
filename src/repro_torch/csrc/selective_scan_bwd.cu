// The backward of the selective scan (selective_scan.cu) for Hopper
// ("kernel D").
//
// Replaces no Pallas kernel: the reference trains the Mamba layer through
// jax.value_and_grad of a jax.lax.scan (`_ssm_scan`,
// src/repro/models/mamba.py:60-80), whose gradient is a reverse scan.  This
// file computes that gradient's function, kernels/ref.py's
// selective_scan_bwd, over a whole window; it does not repeat the
// reference's scan step by step.  Every operand float32:
//
//   x, dt, dy (Bt, S, di); B, C (Bt, S, 16); A (di, 16); D (di,); h_ckpt
//   (Bt, ceil(S / 64), di, 16), the state before each 64-token chunk, from
//   training's forward (launch_selective_scan_f32); dh (Bt, di, 16), the
//   final state's gradient.  Per (row, channel d, state n), a_t =
//   exp(dt_t A), h_t the state after token t, g_t its gradient (g_t =
//   C_t dy_t + a_{t+1} g_{t+1}, from dh):
//     dx_t = dt_t sum_n g_t B_t + D dy_t
//     ddt_t = sum_n g_t (A a_t h_{t-1} + x_t B_t)
//     dB_t[n] = sum_d g_t dt_t x_t        dC_t[n] = sum_d dy_t h_t
//     dA = sum_{b,t} g_t dt_t a_t h_{t-1}  dD = sum_{b,t} dy_t x_t
//     dh0 = a_0 g_0.
//
// What bounds it: bytes, on paper.  It reads x, dt and dy and writes dx
// and ddt, 20 bytes a (token, channel): 0.211 ms at B 1 x 4,096, d_inner
// 8192 on the H100's 3.35 TB/s, against ~18 float32 operations a (token,
// channel, state), 0.14 ms at 67 TFLOP/s.  Above both sit the walk's
// issue (every exponential taken twice, ~8 instructions of expf each,
// ~45 instructions a (token, channel, state) in all, ~0.77 ms on 132 SMs)
// and its shared-memory and shuffle traffic, with 16 warps an SM to hide
// their latencies at B 1.
//
// Design.  A thread per (row, channel, 2 states) keeps g and its A in
// registers; 8 threads hold a channel, a CTA of 256 threads 32 channels
// of one row (256 CTAs at B 1, d_inner 8192: 2 CTAs, 16 warps, an SM, in
// one wave; the parent's 4 states a thread gave 8 warps), and walks the
// row's 64-token chunks in reverse, so g never leaves the CTA.  A chunk's
// x, dt, dy, B and C land in shared memory by cp.async while the chunk
// after it (in the walk) is computed.  Within a chunk the CTA reruns the
// states forward from the chunk's checkpoint with the forward's own
// arithmetic (expf, no division by a_t, which underflows for large dt
// |A|), keeping each thread's state at the start of every 8-token
// sub-chunk in shared memory; then, sub-chunk by sub-chunk in reverse, it
// reruns those 8 tokens into registers (h_{t-1}, h_t, a_t, and each
// token's B and dt for the walk) and walks g back over them.  dx and ddt,
// sums over the channel's 8 lanes, wait for 4 tokens: a transposing
// butterfly over them (8 shuffles for 8 sums), after which lanes 2 m and
// 2 m + 1 hold token m's.  dB and dC, sums over channels: a transposing
// butterfly over the warp's 4 channels (3 shuffles a token), the 8 warps'
// sums in shared memory in order, into a per-CTA partial (Bt, CTAs, S,
// 32); a second launch sums the CTAs' partials in CTA order, and dA and dD
// (per-row partials) over the rows in row order.  No atomics: two
// launches give the same bits.  Tokens past S in the last chunk and
// channels past d_inner are zeros in shared memory (dt = x = dy = 0), so
// they add nothing to any sum.  On an H100 80GB HBM3 at 700 W
// (`ab_kernels.py`, PERF.md): 1.39 ms at B 1 x 4,096, d_inner 8192, where
// the earlier design (4 states a thread, 8 warps an SM) took 1.76.
// Tried and slower there: the dB / dC partials summed on chip across a
// thread-block cluster's CTAs in distributed shared memory (clusters of
// 2 to 8, 6% to 2.3x slower), 16-channel CTAs, 4 states a thread with
// more work shared per token.
#include "common.cuh"

// Probes, each a separate build (ab_kernels.py --probes); their results
// are not the gradient.  -DSCAN_BWD_NO_EXP takes every exponential as one
// saturated add; -DSCAN_BWD_NO_STORES puts the per-token stores (dx, ddt
// and the dB / dC partials) into a register sink, stored once a thread.
#ifdef SCAN_BWD_NO_EXP
#define SCAN_EXP(x) __saturatef(1.f + (x))
#else
#define SCAN_EXP(x) expf(x)
#endif
#ifdef SCAN_BWD_NO_STORES
#define SCAN_PUT(dst, val) (sink += (val))
#else
#define SCAN_PUT(dst, val) ((dst) = (val))
#endif

namespace {

constexpr int kStates = 16;              // d_state
constexpr int kP = 2;                    // states per thread
constexpr int kLanes = kStates / kP;     // threads per channel
constexpr int kChannels = 32;            // channels per CTA
constexpr int kThreads = kChannels * kLanes;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;               // selective_scan.cu's checkpoints
constexpr int kSub = 8;                  // tokens rerun into registers
constexpr int kSubs = kChunk / kSub;
constexpr int kHalf = kSub / 2;          // tokens a dx / ddt butterfly takes
constexpr int kPart = 2 * kStates;       // a token's dB and dC sums
static_assert(kLanes == 2 * kHalf, "lane pairs end with a token's sums");

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

struct Stage {     // one chunk's inputs (32 KB)
  float x[kChunk][kChannels];
  float dt[kChunk][kChannels];
  float dy[kChunk][kChannels];
  float b[kChunk][kStates];
  float c[kChunk][kStates];
};

struct Smem {      // 96 KB: 2 CTAs, 16 warps, an SM
  Stage st[2];
  float2 bnd[kSubs][kThreads];         // a thread's state at sub-chunk starts
  float red[2][kSub][kWarps][kPart];   // the warps' dB and dC sums
};

// Copy tokens [t0, t0 + n) into stage st as 16-byte pieces, per token
// kItems items: a group of 4 channels (its x, dt and dy), or a quarter of
// B or of C.  A group past d_inner (di % 8 == 0) is not copied.
constexpr int kGroups = kChannels / 4;
constexpr int kItems = kGroups + 8;

__device__ __forceinline__ void issue_chunk(
    Stage& st, const float* x, const float* dt, const float* dy,
    const float* B, const float* C, size_t row, int t0, int n, int c0,
    int di) {
  for (int i = threadIdx.x; i < n * kItems; i += kThreads) {
    const int t = i / kItems, it = i % kItems;
    const size_t tok = row + t0 + t;
    if (it < kGroups) {
      const int ch = it * 4;
      if (c0 + ch < di) {
        const size_t at = tok * di + c0 + ch;
        cp_async16(&st.x[t][ch], x + at);
        cp_async16(&st.dt[t][ch], dt + at);
        cp_async16(&st.dy[t][ch], dy + at);
      }
    } else {
      const int part = (it - kGroups) & 3;
      if (it - kGroups < 4)
        cp_async16(&st.b[t][part * 4], B + tok * kStates + part * 4);
      else
        cp_async16(&st.c[t][part * 4], C + tok * kStates + part * 4);
    }
  }
  cp_async_commit();
}

// one token forward: h = exp(dt A) h + (dt x) B, as selective_scan.cu
__device__ __forceinline__ void step(const Stage& st, int t, int cl, int q,
                                     const float (&a)[kP], float (&h)[kP]) {
  const float dtv = st.dt[t][cl];
  const float dtx = dtv * st.x[t][cl];
  const float2 bn = *reinterpret_cast<const float2*>(&st.b[t][q * kP]);
  h[0] = fmaf(SCAN_EXP(dtv * a[0]), h[0], dtx * bn.x);
  h[1] = fmaf(SCAN_EXP(dtv * a[1]), h[1], dtx * bn.y);
}

__global__ void __launch_bounds__(kThreads, 2)
selective_scan_bwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const float* __restrict__ A,
                          const float* __restrict__ Dskip,
                          const float* __restrict__ h_ckpt,
                          const float* __restrict__ dy,
                          const float* __restrict__ dh,
                          float* __restrict__ dx, float* __restrict__ ddt,
                          float* __restrict__ dh0,
                          float* __restrict__ part,
                          float* __restrict__ dA_part,
                          float* __restrict__ dD_part, int S, int di) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int cl = tid / kLanes;           // the thread's channel in the CTA
  const int q = tid % kLanes;            // its states: 2 q, 2 q + 1
  const int c0 = blockIdx.x * kChannels;
  const int c = c0 + cl;
  const size_t b = blockIdx.y;
  const bool live = c < di;
  const size_t row = b * S;
  const int n_ck = (S + kChunk - 1) / kChunk;
  float* part_row = part + (b * gridDim.x + blockIdx.x) * S * kPart;
  // after the dB / dC butterfly lane holds kind (dB, dC) lane bit 3 of
  // state 2 q + lane bit 4
  const int j_out = ((lane >> 3) & 1) * kStates + q * kP + ((lane >> 4) & 1);

  // zeros where nothing is copied: channels past di, tokens past S
  {
    float4* z = reinterpret_cast<float4*>(&sm.st[0]);
    for (int i = tid; i < (int)(2 * sizeof(Stage) / 16); i += kThreads)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float a[kP] = {}, G[kP] = {}, dA_acc[kP] = {};
  float dD_acc = 0.f, sink = 0.f;
  if (live) {
    const float2 av = *reinterpret_cast<const float2*>(
        A + (size_t)c * kStates + q * kP);
    const float2 gv = *reinterpret_cast<const float2*>(
        dh + (b * di + c) * kStates + q * kP);
    a[0] = av.x; a[1] = av.y; G[0] = gv.x; G[1] = gv.y;
  }
  const float dskip = live ? Dskip[c] : 0.f;
  __syncthreads();

  if (n_ck > 0) {
    const int t0 = (n_ck - 1) * kChunk;
    issue_chunk(sm.st[0], x, dt, dy, Bm, Cm, row, t0, S - t0, c0, di);
  }
  int buf = 0, it = 0;
  for (int ck = n_ck - 1; ck >= 0; --ck, buf ^= 1) {
    const int t0 = ck * kChunk, n_tok = min(kChunk, S - t0);
    cp_async_wait_all();
    // this chunk's pieces have landed, and every thread is done with the
    // other stage (the chunk after this one)
    __syncthreads();
    if (ck > 0)
      issue_chunk(sm.st[buf ^ 1], x, dt, dy, Bm, Cm, row, t0 - kChunk,
                  kChunk, c0, di);
    const Stage& st = sm.st[buf];
    const int n_sub = (n_tok + kSub - 1) / kSub;
    // the states forward from the checkpoint, each sub-chunk's start kept
    float h[kP] = {};
    if (live) {
      const float2 hv = *reinterpret_cast<const float2*>(
          h_ckpt + ((b * n_ck + ck) * di + c) * kStates + q * kP);
      h[0] = hv.x; h[1] = hv.y;
    }
    for (int k = 0; k < n_sub; ++k) {
      sm.bnd[k][tid] = make_float2(h[0], h[1]);
      if (k + 1 < n_sub) {
#pragma unroll
        for (int u = 0; u < kSub; ++u) step(st, k * kSub + u, cl, q, a, h);
      }
    }
    for (int k = n_sub - 1; k >= 0; --k, ++it) {
      const int par = it & 1;
      // the states of the sub-chunk (hp[u] = h_{t-1}, hp[u + 1] = h_t) and
      // a_t, rerun into registers with the forward's arithmetic
      float hp[kSub + 1][kP], ea[kSub][kP], bk[kSub][kP], dtk[kSub];
      {
        const float2 v = sm.bnd[k][tid];
        hp[0][0] = v.x;
        hp[0][1] = v.y;
#pragma unroll
        for (int u = 0; u < kSub; ++u) {
          const int t = k * kSub + u;
          const float dtv = st.dt[t][cl];
          const float dtx = dtv * st.x[t][cl];
          const float2 bn = *reinterpret_cast<const float2*>(
              &st.b[t][q * kP]);
          dtk[u] = dtv;
          bk[u][0] = bn.x;
          bk[u][1] = bn.y;
#pragma unroll
          for (int e = 0; e < kP; ++e) {
            ea[u][e] = SCAN_EXP(dtv * a[e]);
            hp[u + 1][e] = fmaf(ea[u][e], hp[u][e], dtx * bk[u][e]);
          }
        }
      }
      // g walked back over them, dx and ddt every kHalf tokens
      float vv[2 * kHalf];
#pragma unroll
      for (int u = kSub - 1; u >= 0; --u) {
        const int t = k * kSub + u;
        const float xv = st.x[t][cl], dtv = dtk[u];
        const float dyv = st.dy[t][cl];
        const float dtx = dtv * xv;
        const float2 cn2 = *reinterpret_cast<const float2*>(
            &st.c[t][q * kP]);
        const float* bn = bk[u];
        const float cn[kP] = {cn2.x, cn2.y};
        float v[2 * kP];
        float sx = 0.f, sdt = 0.f;
#pragma unroll
        for (int e = 0; e < kP; ++e) {
          const float g = fmaf(cn[e], dyv, G[e]);
          const float gw = g * (ea[u][e] * hp[u][e]);
          v[e] = g * dtx;
          v[kP + e] = dyv * hp[u + 1][e];
          sx = fmaf(g, bn[e], sx);
          sdt = fmaf(a[e], gw, sdt);
          dA_acc[e] = fmaf(dtv, gw, dA_acc[e]);
          G[e] = ea[u][e] * g;
        }
        vv[2 * (u % kHalf)] = sx;
        vv[2 * (u % kHalf) + 1] = sdt;
        dD_acc = fmaf(dyv, xv, dD_acc);
        // dB and dC over the warp's 4 channels (lane bits 3 and 4): each
        // round halves the values a lane holds, keeping the half its
        // channel bit selects
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int off = kLanes << r, half = kP >> r;
          const bool up = lane & off;
#pragma unroll
          for (int i = 0; i < half; ++i) {
            const float send = up ? v[i] : v[i + half];
            const float keep = up ? v[i + half] : v[i];
            v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
          }
        }
        sm.red[par][u][warp][j_out] = v[0];
        if (u % kHalf == 0) {
          // dx and ddt of tokens u .. u + 3: the sums over the channel's 8
          // lanes (lane bits 2, 1, 0) of their (sx, sdt), transposed so
          // lanes 2 m and 2 m + 1 end with token u + m's sx and sdt
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const int off = (kLanes / 2) >> r, half = kHalf >> r;
            const bool up = lane & off;
#pragma unroll
            for (int i = 0; i < half; ++i) {
              const float send = up ? vv[i] : vv[i + half];
              const float keep = up ? vv[i + half] : vv[i];
              vv[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
            }
          }
          const float other = __shfl_xor_sync(0xffffffffu, vv[0], 1);
          const int tt = k * kSub + u + (q >> 1);
          if ((q & 1) == 0 && live && t0 + tt < S) {
            const size_t tok = row + t0 + tt;
            SCAN_PUT(dx[tok * di + c],
                     fmaf(dskip, st.dy[tt][cl], st.dt[tt][cl] * vv[0]));
            SCAN_PUT(ddt[tok * di + c], fmaf(st.x[tt][cl], vv[0], other));
          }
        }
      }
      __syncthreads();   // the warps' dB / dC sums are in red[par]
      // the CTA's dB and dC sums of the sub-chunk's tokens, warps in order
      {
        const int u = tid / kPart, j = tid % kPart;
        static_assert(kSub * kPart == kThreads, "a sum a thread");
        const float* r = sm.red[par][u][0];
        float s = r[j];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s += r[w * kPart + j];
        if (t0 + k * kSub + u < S)
          SCAN_PUT(part_row[(size_t)(t0 + k * kSub + u) * kPart + j], s);
      }
    }
  }
  if (live) {
    *reinterpret_cast<float2*>(dh0 + (b * di + c) * kStates + q * kP) =
        make_float2(G[0], G[1]);
    *reinterpret_cast<float2*>(dA_part + (b * di + c) * kStates + q * kP) =
        make_float2(dA_acc[0], dA_acc[1]);
    if (q == 0) dD_part[b * di + c] = dD_acc;
#ifdef SCAN_BWD_NO_STORES
    dx[row * di + c] = sink;
#endif
  }
}

// dB and dC: the CTAs' partials summed in CTA order; dA and dD: the rows'
// partials summed in row order
__global__ void __launch_bounds__(256)
selective_scan_bwd_sum_kernel(const float* __restrict__ part,
                              const float* __restrict__ dA_part,
                              const float* __restrict__ dD_part,
                              float* __restrict__ dB, float* __restrict__ dC,
                              float* __restrict__ dA, float* __restrict__ dD,
                              int Bt, int S, int di, int n_cta) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long n_bc = (long long)Bt * S * kPart;
  const long long n_a = (long long)di * kStates;
  if (i < n_bc) {
    const long long bt = i / kPart;          // b S + t
    const int j = (int)(i % kPart);
    const long long b = bt / S, t = bt % S;
    const float* p = part + (b * n_cta * S + t) * kPart + j;
    float s = 0.f;
    for (int k = 0; k < n_cta; ++k) s += p[(long long)k * S * kPart];
    if (j < kStates)
      dB[bt * kStates + j] = s;
    else
      dC[bt * kStates + j - kStates] = s;
  } else if (i < n_bc + n_a) {
    const long long e = i - n_bc;
    float s = 0.f;
    for (int b = 0; b < Bt; ++b) s += dA_part[b * n_a + e];
    dA[e] = s;
  } else if (i < n_bc + n_a + di) {
    const long long e = i - n_bc - n_a;
    float s = 0.f;
    for (int b = 0; b < Bt; ++b) s += dD_part[(long long)b * di + e];
    dD[e] = s;
  }
}

// the CTAs of a row, kChannels channels each
int ctas(int di) { return (di + kChannels - 1) / kChannels; }

}  // namespace

// The scratch launch_selective_scan_bwd takes, in floats: the CTAs' dB
// and dC partials (Bt, ceil(di / 32), S, 32), then dA's and dD's per-row
// partials (Bt, di, 16) and (Bt, di).
extern "C" long long selective_scan_bwd_ws_floats(int Bt, int S, int di) {
  return (long long)Bt * ctas(di) * S * kPart +
         (long long)Bt * di * kStates + (long long)Bt * di;
}

// The gradient of launch_selective_scan_f32 (its h_ckpt given): every
// operand float32, contiguous and 16-byte aligned; d_state 16, d_inner a
// multiple of 8; ws at least selective_scan_bwd_ws_floats floats.  Writes
// dx, ddt (Bt, S, di), dB, dC (Bt, S, 16), dA (di, 16), dD (di,) and dh0
// (Bt, di, 16) whole.  Two launches; returns a runtime error code.
extern "C" int launch_selective_scan_bwd(
    const void* x, const void* dt, const void* B, const void* C,
    const void* A, const void* D, const void* h_ckpt, const void* dy,
    const void* dh, void* dx, void* ddt, void* dB, void* dC, void* dA,
    void* dD, void* dh0, void* ws, long long ws_n, int Bt, int S, int di,
    int ds, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ds != kStates || Bt <= 0 || S <= 0 || di <= 0 || di % 8 != 0 ||
      Bt > 65535 || ws_n < selective_scan_bwd_ws_floats(Bt, S, di))
    return (int)cudaErrorInvalidValue;
  const int n_cta = ctas(di);
  float* part = static_cast<float*>(ws);
  float* dA_part = part + (size_t)Bt * n_cta * S * kPart;
  float* dD_part = dA_part + (size_t)Bt * di * kStates;
  constexpr int smem = sizeof(Smem);
  cudaError_t e = cudaFuncSetAttribute(
      selective_scan_bwd_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  selective_scan_bwd_kernel<<<dim3(n_cta, Bt), kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const float*>(h_ckpt), static_cast<const float*>(dy),
      static_cast<const float*>(dh), static_cast<float*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dh0), part, dA_part,
      dD_part, S, di);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)Bt * S * kPart + (long long)di * kStates +
                      di;
  selective_scan_bwd_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      part, dA_part, dD_part, static_cast<float*>(dB),
      static_cast<float*>(dC), static_cast<float*>(dA),
      static_cast<float*>(dD), Bt, S, di, n_cta);
  return (int)cudaGetLastError();
}
